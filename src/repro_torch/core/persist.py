"""Crash-safe persistence primitives (DESIGN.md §17).

A save interrupted by a crash (OOM kill, power loss, deploy rollover) must
never leave a loadable-but-wrong index behind: the serving tier would
happily answer queries from garbage. The protocol here gives every save
two properties:

  atomicity  — each artifact is written to `<name>.tmp`, fsync'd, and
               `os.replace`d into place; readers only ever see the old
               bytes or the new bytes, never a torn write.
  detection  — the JSON sidecar carries a crc32 per saved array, and is
               itself written (atomically) AFTER the array file. The
               sidecar is therefore the commit point: a crash between the
               two renames leaves new arrays under an old sidecar, which
               `load()` rejects with `IndexCorruptError` instead of
               deserializing a mismatched pair.

Sharded saves extend the same idea one level up: shards commit first
(each with the single-index protocol), then the `.sharded.json` manifest
— embedding a crc32 of every shard's sidecar bytes — commits the whole
mesh last (the manifest-last protocol of `ShardedKBest.save`).

`checkpoint(step)` names every kill point in the protocol; a fault
harness hooks it to kill a save at each step and assert load sees
old-or-error, never garbage.

This module is a copy of the JAX package's `repro/core/persist.py`
(numpy only), so the two packages read and write the same format-2
files.
"""
from __future__ import annotations

import os
import zlib
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional

import numpy as np


class IndexCorruptError(RuntimeError):
    """A persisted index failed validation (truncation, checksum mismatch,
    torn sidecar, partial sharded save). Never returned as data — load()
    raises instead of deserializing a suspect artifact."""


# ------------------------------------------------------------ crash hook
_crash_hook: Optional[Callable[[str], None]] = None


def set_crash_hook(fn: Optional[Callable[[str], None]]) -> None:
    """Install (or clear, with None) the fault-injection hook. Test-only:
    production saves run with no hook and checkpoint() is a no-op."""
    global _crash_hook
    _crash_hook = fn


def checkpoint(step: str) -> None:
    """Named kill point inside the save protocol. The hook may raise to
    simulate a crash at exactly this step."""
    if _crash_hook is not None:
        _crash_hook(step)


# ---------------------------------------------------------- atomic write
def _fsync_dir(d: Path) -> None:
    # directory fsync makes the rename itself durable; best-effort because
    # not every filesystem (or sandbox) grants O_RDONLY on directories
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path: Path, data: bytes, label: str) -> None:
    """tmp + fsync + rename. `label` names this artifact's kill points:
    `{label}.begin` (nothing written), `{label}.staged` (tmp durable,
    final untouched), `{label}.committed` (rename done)."""
    path = Path(path)
    checkpoint(f"{label}.begin")
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    checkpoint(f"{label}.staged")
    os.replace(tmp, path)
    _fsync_dir(path.parent)
    checkpoint(f"{label}.committed")


# ------------------------------------------------------------- checksums
def array_checksums(arrs: Mapping[str, np.ndarray]) -> Dict[str, int]:
    """crc32 over each array's raw bytes (C-contiguous view)."""
    return {k: int(zlib.crc32(np.ascontiguousarray(v).tobytes()))
            for k, v in arrs.items()}


def file_crc32(path: Path) -> int:
    return int(zlib.crc32(Path(path).read_bytes()))


def save_arrays(path: Path, arrs: Mapping[str, np.ndarray],
                label: str) -> Dict[str, int]:
    """Atomically write an .npz of `arrs` to `path`; returns the per-array
    checksums for the caller's sidecar."""
    import io
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrs)
    atomic_write(path, buf.getvalue(), label)
    return array_checksums(arrs)


def load_arrays(path: Path,
                checksums: Optional[Mapping[str, int]]) -> Dict[str, np.ndarray]:
    """Read an .npz back, failing loudly: any read/parse error (truncation,
    torn zip) and any checksum/name mismatch raises IndexCorruptError.
    `checksums=None` skips verification (legacy pre-§17 sidecars)."""
    try:
        with np.load(path) as z:
            data = {k: np.asarray(z[k]) for k in z.files}
    except IndexCorruptError:
        raise
    except Exception as e:                     # zipfile/pickle/np errors
        raise IndexCorruptError(
            f"unreadable index arrays at {path}: {e!r}") from e
    if checksums is not None:
        if set(data) != set(checksums):
            raise IndexCorruptError(
                f"array set mismatch at {path}: sidecar lists "
                f"{sorted(checksums)}, file holds {sorted(data)} — "
                f"torn save (arrays and sidecar from different commits)")
        for name, crc in array_checksums(data).items():
            want = int(checksums[name])
            if crc != want:
                raise IndexCorruptError(
                    f"checksum mismatch for array '{name}' at {path}: "
                    f"crc32 {crc} != sidecar {want}")
    return data
