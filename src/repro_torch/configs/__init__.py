"""Architecture registry, the counterpart of the JAX package's
`configs/__init__.py`: one module per assigned arch (plus the ANN presets
in kbest.py). Each module exposes

    ARCH_ID:  str
    FAMILY:   "lm" | "gnn" | "recsys"
    SHAPES:   tuple of shape names valid for this arch
    full_config()   -> model config (exact assigned hyperparameters)
    smoke_config()  -> reduced same-family config for CPU smoke tests

Select with --arch <id> in the launchers. The port has every family
(LM, GNN, RecSys).
"""
from __future__ import annotations

import importlib

ARCHS = (
    # LM family
    "qwen2_5_14b",
    "chatglm3_6b",
    "gemma_2b",
    "kimi_k2_1t_a32b",
    "llama4_scout_17b_a16e",
    # GNN
    "dimenet",
    # RecSys
    "deepfm",
    "bert4rec",
    "bst",
    "fm",
)

_ALIAS = {
    "qwen2.5-14b": "qwen2_5_14b",
    "chatglm3-6b": "chatglm3_6b",
    "gemma-2b": "gemma_2b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
}

LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
RECSYS_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")


def get(arch: str):
    name = _ALIAS.get(arch, arch.replace("-", "_").replace(".", "_"))
    assert name in ARCHS, f"unknown arch {arch}; options: {ARCHS}"
    return importlib.import_module(f"repro_torch.configs.{name}")


def all_cells():
    """All 40 (arch, shape) dry-run cells, in the reference's order."""
    for a in ARCHS:
        mod = get(a)
        for s in mod.SHAPES:
            yield a, s
