"""Atomic, device-independent checkpointing, the counterpart of the JAX
package's `train/checkpoint.py` (DESIGN.md §6), on the same format:

    step_00000120/
      arrays.npz        {leaf path: array}, paths "/"-joined tree keys
                        (`params/mlp/0/w`, `opt/v/tables/vr`)
      meta.json         {"step": int, "keys": [...]}
      _DONE             commit marker (written last)

so either package restores the other's checkpoints. Properties kept:
  * atomic commit (tmp dir, `_DONE`, rename): a killed save never corrupts
    the latest valid step;
  * auto-resume: `latest_step()` scans for the newest `_DONE`;
  * device independence: arrays are saved as host arrays and restored onto
    the device asked for (one card here; the reference's re-mesh);
  * retention: keep_last pruning;
  * async: `AsyncCheckpointer` copies to the host in the caller and
    writes on a worker thread.
A bf16 leaf is saved as f32 (exact; the reference's restore casts it
back), and a bf16 array of the reference's is read from its raw 16 bits.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.train.tree import (leaves_with_path, path_key, to_numpy,
                                    to_tensor, tree_map, unflatten)


def _flatten(tree) -> dict:
    return {path_key(path): to_numpy(leaf)
            for path, leaf in leaves_with_path(tree)}


def save(path: str, step: int, tree, keep_last: int = 3) -> str:
    root = Path(path)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    arrays = _flatten(tree)
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "meta.json").write_text(json.dumps(
        {"step": step, "keys": sorted(arrays.keys())}))
    (tmp / "_DONE").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    _prune(root, keep_last)
    return str(final)


def _prune(root: Path, keep_last: int) -> None:
    done = sorted(p for p in root.glob("step_*") if (p / "_DONE").exists())
    for p in done[:-keep_last]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(path: str) -> Optional[int]:
    root = Path(path)
    if not root.exists():
        return None
    done = sorted(p for p in root.glob("step_*") if (p / "_DONE").exists())
    if not done:
        return None
    return int(done[-1].name.split("_")[1])


def _dtype_of(leaf) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return torch.from_numpy(np.zeros(0, np.asarray(leaf).dtype)).dtype


def restore(path: str, step: int, like, device=None):
    """Restore into the structure, shapes and dtypes of `like` (tensors or
    arrays), as tensors on `device` (None: the card)."""
    dev = torch.device("cuda" if device is None else device)
    d = Path(path) / f"step_{step:08d}"
    assert (d / "_DONE").exists(), f"checkpoint {d} incomplete"
    with np.load(d / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    out = []
    for path_keys, leaf in leaves_with_path(like):
        key = path_key(path_keys)
        arr = arrays[key]
        assert arr.shape == tuple(leaf.shape), (key, arr.shape, leaf.shape)
        out.append(to_tensor(arr, dev).to(_dtype_of(leaf)))
    return unflatten(like, out)


class AsyncCheckpointer:
    """Fire-and-forget saves on a worker thread (one in flight at a time);
    a worker's error is raised by the next `save()` or `wait()`."""

    def __init__(self, path: str, keep_last: int = 3):
        self.path = path
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None

    def save(self, step: int, tree) -> None:
        self.wait()
        host_tree = tree_map(to_numpy, tree)   # device -> host in the caller

        def work():
            try:
                save(self.path, step, host_tree, self.keep_last)
            except Exception as e:       # surfaced on the next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
