"""Fault-tolerant training loop, the counterpart of the JAX package's
`train/loop.py` (DESIGN.md §6):
  * periodic and signal-triggered checkpoints with atomic commit,
  * automatic resume from the latest valid checkpoint,
  * straggler detection (a per-step wall-time EMA; step 0, which holds the
    first call's warm-up, never seeds it),
  * restore of a checkpoint onto another device (`reshard_checkpoint`),
  * failure injection for testing the above end to end.

The Trainer is model-agnostic: it takes loss_fn(params, batch) -> (loss,
metrics) over a parameter tree, an optimizer config, a device and a data
iterator of numpy batches, which it moves to the device. A step is one
autograd pass and one `opt_update`; its one host sync reads the loss (the
reference's `block_until_ready`), which the straggler clock needs. The
reference's sharding arguments have no meaning on one card; `device` takes
their place. `donate=True` is the reference's buffer donation (its
default): AdamW then updates the parameters and moments in place, in
slices, so a step holds one copy of the state (the params given to `fit`
are consumed); the default keeps them untouched.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Iterator

import torch

from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.optimizer import OptConfig, opt_init, opt_update
from repro_torch.train.tree import leaves, to_tensor, unflatten


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep_last: int = 3
    straggler_kappa: float = 2.5   # step > kappa * EMA => straggler
    ema_alpha: float = 0.1
    fail_at_step: int = -1         # failure injection (tests)
    log_every: int = 10


class SimulatedFailure(RuntimeError):
    pass


def train_step(loss_fn: Callable, opt_cfg: OptConfig, params, opt_state,
               batch, donate: bool = False):
    """One autograd pass of loss_fn(params, batch) -> (loss, metrics) and
    one `opt_update`: (new params, new opt state, metrics as tensors)."""
    req = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss, metrics = loss_fn(unflatten(params, req), batch)
    grads = torch.autograd.grad(loss, req)
    with torch.no_grad():
        new_params, new_state, gnorm = opt_update(
            unflatten(params, grads), opt_state,
            unflatten(params, [p.detach() for p in req]), opt_cfg,
            donate=donate)
    metrics = dict(metrics, loss=loss.detach(), grad_norm=gnorm)
    return new_params, new_state, metrics


class Trainer:
    def __init__(self, loss_fn: Callable, opt_cfg: OptConfig,
                 cfg: TrainerConfig, device=None, donate: bool = False):
        self.loss_fn = loss_fn
        self.donate = donate
        self.opt_cfg = opt_cfg
        self.cfg = cfg
        self.device = torch.device("cuda" if device is None else device)
        self.ckpt = ckpt_mod.AsyncCheckpointer(cfg.ckpt_dir, cfg.keep_last)
        self.straggler_steps = 0
        self._ema = None
        self._warm = None
        self._stop = False

    def step_fn(self, params, opt_state, batch):
        """One step: (new params, new opt state, metrics as tensors)."""
        return train_step(self.loss_fn, self.opt_cfg, params, opt_state,
                          batch, donate=self.donate)

    # ------------------------------------------------------------- signals
    def install_signal_handler(self):
        def handler(signum, frame):
            self._stop = True   # checkpoint + exit at the next step boundary
        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)

    # --------------------------------------------------------------- train
    def fit(self, params, data: Iterator, n_steps: int,
            resume: bool = True) -> dict:
        opt_state = opt_init(params, self.opt_cfg)
        start = 0
        if resume:
            last = ckpt_mod.latest_step(self.cfg.ckpt_dir)
            if last is not None:
                state = ckpt_mod.restore(
                    self.cfg.ckpt_dir, last,
                    {"params": params, "opt": opt_state}, self.device)
                params, opt_state = state["params"], state["opt"]
                start = last
        history = []
        for step in range(start, n_steps):
            if self._stop:
                break
            if step == self.cfg.fail_at_step:
                # crash AFTER the last checkpoint committed, BEFORE saving
                # this step: the restart path must recover.
                self.ckpt.wait()
                raise SimulatedFailure(f"injected failure at step {step}")
            t0 = time.perf_counter()   # includes data stalls: they ARE a
            batch = next(data)         # straggler symptom at fleet scale
            batch = {k: to_tensor(v, self.device) for k, v in batch.items()}
            params, opt_state, metrics = self.step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])      # the step's one host sync
            dt = time.perf_counter() - t0
            self._track_straggler(dt, step)
            if step % self.cfg.log_every == 0:
                history.append({"step": step, "loss": loss, "sec": dt})
            if (step + 1) % self.cfg.ckpt_every == 0:
                self.ckpt.save(step + 1, {"params": params, "opt": opt_state})
        self.ckpt.save(n_steps if not self._stop else step,
                       {"params": params, "opt": opt_state})
        self.ckpt.wait()
        return {"params": params, "opt": opt_state, "history": history,
                "stragglers": self.straggler_steps}

    def _track_straggler(self, dt: float, step: int) -> None:
        if self._warm is None:
            self._warm = True   # step 0 holds the first call's warm-up
            return
        if self._ema is None:
            self._ema = dt
            return
        if dt > self.cfg.straggler_kappa * self._ema:
            self.straggler_steps += 1
        a = self.cfg.ema_alpha
        self._ema = (1 - a) * self._ema + a * dt


def reshard_checkpoint(ckpt_dir: str, step: int, like_tree, device=None):
    """Restore a checkpoint onto another device (on one card, the
    reference's elastic re-mesh)."""
    return ckpt_mod.restore(ckpt_dir, step, like_tree, device)
