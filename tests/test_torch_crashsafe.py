"""Crash-safe persistence of the port (DESIGN.md §17), the crash matrices
of the JAX package's tests/test_crashsafe.py on the port's KBest and
ShardedKBest, driven through repro_torch.serve.faults.

Kill the save at EVERY checkpoint step and load() must see the previous
intact index, the new complete one (only past the final commit), or a
clean IndexCorruptError — never a silently wrong index. Plus direct
corruption: truncation, bit flips, torn sidecars, sidecars without
checksums, mixed-generation sharded saves. And parity: a save fires the
same ordered list of checkpoint steps in both packages.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import kbest as jpresets
from repro.core.index import KBest as RefKBest
from repro.core.sharded import ShardedKBest as RefShardedKBest
from repro.serve import faults as jfaults
from repro_torch.configs import kbest as kcfg
from repro_torch.core.index import KBest, _meta_path, _npz_path
from repro_torch.core.persist import IndexCorruptError
from repro_torch.core.sharded import ShardedKBest
from repro_torch.serve.faults import InjectedCrash, crash_at, trace_steps
from torch_reference_cache import jax_maps_below_limit  # noqa: F401

torch.set_num_threads(1)

SEED = 7
N = 160


def _x(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((N, 32)).astype(np.float32)


def _build(seed: int) -> KBest:
    return KBest(kcfg.smoke_config(), device="cpu").add(_x(seed))


def _build_sharded(seed: int) -> ShardedKBest:
    return ShardedKBest(kcfg.sharded_smoke_config(2),
                        device="cpu").add(_x(seed))


def _load(path):
    return KBest.load(path, device="cpu")


def _load_sharded(path):
    return ShardedKBest.load(path, device="cpu")


@pytest.fixture(scope="module")
def old_new():
    return _build(SEED), _build(SEED + 1)


@pytest.fixture(scope="module")
def old_new_sharded():
    return _build_sharded(SEED), _build_sharded(SEED + 1)


def _db(idx) -> np.ndarray:
    if isinstance(idx, ShardedKBest):
        return np.concatenate([s.db.numpy() for s in idx.shards])
    return idx.db.numpy()


def _steps(save_fn, path) -> list:
    out = []
    with trace_steps(out):
        save_fn(path)
    assert out, "save fired no checkpoints — the crash matrix is empty"
    return out


def _run_matrix(old, new, loader, tmp_path, name):
    """For each kill point: restore the old save, crash the new save at
    that step, and demand load() yields old bytes, new bytes, or a clean
    IndexCorruptError."""
    path = str(tmp_path / name)
    steps = _steps(new.save, str(tmp_path / (name + ".probe")))
    old_db, new_db = _db(old), _db(new)
    saw_error = saw_old = False
    for step in steps:
        old.save(path)                      # reset to a committed baseline
        with crash_at(step):
            with pytest.raises(InjectedCrash):
                new.save(path)
        try:
            got = _db(loader(path))
        except IndexCorruptError:
            saw_error = True
            continue
        is_old = got.shape == old_db.shape and np.array_equal(got, old_db)
        is_new = got.shape == new_db.shape and np.array_equal(got, new_db)
        saw_old |= is_old
        assert is_old or is_new, \
            f"kill at '{step}' loaded a mixed-generation index"
    # the matrix must exercise both outcomes, or it proves nothing
    assert saw_old, "no kill point preserved the old index"
    assert saw_error, "no kill point produced a detectable partial save"


def test_crash_matrix_single(old_new, tmp_path):
    old, new = old_new
    _run_matrix(old, new, _load, tmp_path, "idx.npz")


def test_crash_matrix_sharded(old_new_sharded, tmp_path):
    old, new = old_new_sharded
    _run_matrix(old, new, _load_sharded, tmp_path, "mesh")


def test_first_save_crash_leaves_clean_error_or_nothing(old_new, tmp_path):
    """With NO previous save, a mid-save crash yields FileNotFoundError,
    IndexCorruptError, or (only when the kill lands after the sidecar
    commit) the complete new index — never a partial one."""
    _, new = old_new
    steps = _steps(new.save, str(tmp_path / "probe.npz"))
    for i, step in enumerate(steps):
        path = str(tmp_path / f"fresh{i}.npz")
        with crash_at(step):
            with pytest.raises(InjectedCrash):
                new.save(path)
        try:
            got = _load(path)
        except (FileNotFoundError, IndexCorruptError):
            continue
        assert step == "index.meta.committed", \
            f"kill at pre-commit step '{step}' still loaded"
        assert np.array_equal(got.db.numpy(), new.db.numpy())


def test_truncated_npz_fails_loudly(old_new, tmp_path):
    old, _ = old_new
    path = tmp_path / "t.npz"
    old.save(str(path))
    raw = _npz_path(path).read_bytes()
    _npz_path(path).write_bytes(raw[:len(raw) // 2])
    with pytest.raises(IndexCorruptError):
        _load(str(path))


def test_bitflip_fails_checksum(old_new, tmp_path):
    """A flipped payload byte that still unzips is caught by the per-array
    crc32."""
    old, _ = old_new
    path = tmp_path / "b.npz"
    old.save(str(path))
    raw = bytearray(_npz_path(path).read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    _npz_path(path).write_bytes(bytes(raw))
    with pytest.raises(IndexCorruptError):
        _load(str(path))


def test_torn_sidecar_fails_loudly(old_new, tmp_path):
    old, _ = old_new
    path = tmp_path / "s.npz"
    old.save(str(path))
    mp = _meta_path(path)
    mp.write_text(mp.read_text()[:20])      # torn JSON
    with pytest.raises(IndexCorruptError):
        _load(str(path))


def test_legacy_sidecar_without_checksums_still_loads(old_new, tmp_path):
    """Saves from before checksums carry no "checksums" key: load() skips
    the verification instead of rejecting them."""
    old, _ = old_new
    path = tmp_path / "legacy.npz"
    old.save(str(path))
    meta = json.loads(_meta_path(path).read_text())
    meta.pop("checksums")
    meta.pop("format")
    _meta_path(path).write_text(json.dumps(meta))
    got = _load(str(path))
    assert np.array_equal(got.db.numpy(), old.db.numpy())


def test_mixed_generation_sharded_save_rejected(old_new_sharded, tmp_path):
    """shard0 overwritten by another save generation under an unchanged
    manifest: the manifest's sidecar crc32 catches it."""
    old, new = old_new_sharded
    path = str(tmp_path / "mix")
    old.save(path)
    new.shards[0].save(ShardedKBest._shard_path(path, 0), _label="shard0")
    with pytest.raises(IndexCorruptError):
        _load_sharded(path)


def test_missing_shard_and_torn_manifest_rejected(old_new_sharded, tmp_path):
    """The manifest's other two faults: a shard sidecar it names is gone,
    and the manifest's own bytes are torn."""
    old, _ = old_new_sharded
    path = str(tmp_path / "gone")
    old.save(path)
    _meta_path(Path(ShardedKBest._shard_path(path, 1))).unlink()
    with pytest.raises(IndexCorruptError, match="missing"):
        _load_sharded(path)
    old.save(path)
    mp = Path(path + ".sharded.json")
    mp.write_text(mp.read_text()[:30])
    with pytest.raises(IndexCorruptError, match="unreadable"):
        _load_sharded(path)


def test_no_stray_tmp_files_after_clean_save(old_new, tmp_path):
    old, _ = old_new
    old.save(str(tmp_path / "clean.npz"))
    assert not list(Path(tmp_path).glob("*.tmp"))


def test_save_kill_points_match_reference(tmp_path):
    """A one-index save and a 2-shard save fire the same ordered list of
    checkpoint step names in both packages: the crash matrices above walk
    the reference's kill points."""
    x = _x(SEED)
    ref = RefKBest(jpresets.smoke_config()).add(x)
    ref_sh = RefShardedKBest(jpresets.sharded_smoke_config(2)).add(x)
    port = KBest(kcfg.smoke_config(), device="cpu").add(x)
    port_sh = ShardedKBest(kcfg.sharded_smoke_config(2), device="cpu").add(x)
    for name, (r, p) in {"idx.npz": (ref, port),
                         "mesh": (ref_sh, port_sh)}.items():
        exp, got = [], []
        with jfaults.trace_steps(exp):
            r.save(str(tmp_path / ("ref-" + name)))
        with trace_steps(got):
            p.save(str(tmp_path / ("port-" + name)))
        assert got == exp, (got, exp)
    assert exp[-1] == "manifest.committed"
    assert [s for s in exp if s.startswith("shard1.")][0] == \
        "shard1.arrays.begin"
