"""Training launcher: --arch <id> on one card, the counterpart of the JAX
package's `repro/launch/train.py`.

    # a RecSys arch at its full config, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm \
        --steps 20 --batch 65536

    # the reduced config, on the host
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --smoke --steps 10 --batch 4 --seq 32 --device cpu

Every arch trains: LM archs on the token stream (`--batch` x `--seq`), the
GNN arch (dimenet, at `full_config("full_graph_sm")` without `--smoke`)
on sampled 2-hop subgraphs of `--batch` seed nodes, RecSys archs on their
streams (at their config's sequence length). A checkpoint directory that
holds steps resumes from the newest.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from repro_torch import configs as reg
from repro_torch.data.pipeline import (Prefetcher, ctr_batches,
                                       gnn_minibatches, lm_batches,
                                       seq_batches)
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

    mod = reg.get(args.arch)
    cfg = mod.smoke_config() if args.smoke else (
        mod.full_config("full_graph_sm") if mod.FAMILY == "gnn"
        else mod.full_config())

    gen = torch.Generator(device=args.device).manual_seed(0)
    if mod.FAMILY == "lm":
        from repro_torch.models import transformer as M
        data = lm_batches(cfg.vocab, args.batch, args.seq)
    elif mod.FAMILY == "recsys":
        from repro_torch.models import recsys as M
        if cfg.kind in ("fm", "deepfm"):
            data = ctr_batches(cfg.n_sparse, cfg.vocab_per_field, args.batch)
        else:
            data = seq_batches(cfg.kind, cfg.n_items, args.batch,
                               cfg.seq_len)
    else:
        from repro_torch.models import dimenet as M
        data = gnn_minibatches(n_nodes=2000, d_feat=cfg.d_feat,
                               batch_nodes=args.batch, fanouts=(5, 3),
                               n_classes=cfg.n_out)
    params = M.init_params(cfg, gen)
    data = Prefetcher(data)

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
