"""Training launcher: --arch <id> on one card, the counterpart of the JAX
package's `repro/launch/train.py`.

    # a RecSys arch at its full config, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm \
        --steps 20 --batch 65536

    # the reduced config, on the host
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm \
        --smoke --steps 10 --device cpu

The port trains the four RecSys archs (fm, deepfm, bst, bert4rec); an LM
or GNN arch exits with the error that names the ROADMAP item porting it.
`--seq` is the LM stream's sequence length (the RecSys streams take their
config's). A checkpoint directory that holds steps resumes from the
newest.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from repro_torch import configs as reg
from repro_torch.data.pipeline import Prefetcher, ctr_batches, seq_batches
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.optimizer import OptConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--opt", choices=("adamw", "adafactor"), default="adamw")
    ap.add_argument("--ckpt", type=str, default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    try:
        mod = reg.get(args.arch)
    except reg.NotPortedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    cfg = mod.smoke_config() if args.smoke else mod.full_config()

    from repro_torch.models import recsys as M
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = M.init_params(cfg, gen)
    if cfg.kind in ("fm", "deepfm"):
        data = Prefetcher(ctr_batches(cfg.n_sparse, cfg.vocab_per_field,
                                      args.batch))
    else:
        data = Prefetcher(seq_batches(cfg.kind, cfg.n_items, args.batch,
                                      cfg.seq_len))

    def lfn(p, b):
        return M.loss_fn(p, b, cfg)

    print(f"arch={args.arch} family={mod.FAMILY} "
          f"params={M.n_params(params) / 1e6:.2f}M device={args.device}")
    trainer = Trainer(lfn, OptConfig(kind=args.opt, lr=args.lr),
                      TrainerConfig(ckpt_dir=args.ckpt, ckpt_every=25,
                                    log_every=5), device=args.device)
    trainer.install_signal_handler()
    out = trainer.fit(params, data, n_steps=args.steps)
    for h in out["history"]:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
