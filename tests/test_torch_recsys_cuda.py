"""The RecSys family on the card (`cuda`-marked; each test skips without a
CUDA device, and this file imports no JAX).

`serve_retrieval` on the `batch_dist` kernel against its plain path at the
three retrieval widths of the RecSys configs (d = 10 for fm and deepfm,
whose rows are not 16-byte aligned, 32 for bst, 64 for bert4rec), Q = 1 and
Q = 33 queries, B = 10,007 candidates: distances within the kernels'
`rtol=3e-5, atol=3e-4`, ids through `assert_same_ranking`. And one
`Trainer` run on the card.
"""
import dataclasses

import pytest
import torch

from repro_torch import configs as reg
from repro_torch.data.pipeline import seq_batches
from repro_torch.kernels import ops
from repro_torch.models import recsys as R
from repro_torch.train import checkpoint as ck
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.optimizer import OptConfig
from test_torch_parity import assert_same_ranking

N_CANDS = 10_007
# (arch, its retrieval width d)
WIDTHS = (("fm", 10), ("bst", 32), ("bert4rec", 64))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg(arch, d):
    cfg = reg.get(arch).smoke_config()
    if arch == "fm":
        return dataclasses.replace(cfg, embed_dim=d, vocab_per_field=N_CANDS)
    return dataclasses.replace(cfg, d_model=d, n_items=N_CANDS)


def _batch(cfg, Q, g):
    if cfg.kind == "fm":
        return {"sparse_ids": torch.randint(0, cfg.vocab_per_field,
                                            (Q, cfg.n_sparse), generator=g,
                                            device=g.device)}
    key = "hist" if cfg.kind == "bst" else "seq"
    return {key: torch.randint(0, cfg.n_items, (Q, cfg.seq_len), generator=g,
                               device=g.device)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch,d", WIDTHS)
@pytest.mark.parametrize("Q", [1, 33])
def test_cuda_serve_retrieval_kernel_matches_plain(cuda, arch, d, Q):
    cfg = _cfg(arch, d)
    g = torch.Generator(device=cuda).manual_seed(d + Q)
    params = R.init_params(cfg, g)
    batch = _batch(cfg, Q, g)
    assert R.candidate_table(params, cfg).shape == (N_CANDS, d)
    before = ops.launch_counts()["batch_dist"]
    kd, ki = R.serve_retrieval(params, batch, cfg, k=100, use_kernel=True)
    assert ops.launch_counts()["batch_dist"] == before + 1
    pd, pi = R.serve_retrieval(params, batch, cfg, k=100)
    assert kd.shape == (Q, 100) and ki.dtype == torch.int32
    assert_same_ranking(kd.cpu().numpy(), ki.cpu().numpy(),
                        pd.cpu().numpy(), pi.cpu().numpy())


@pytest.mark.cuda
def test_cuda_trainer_steps_on_the_card(cuda, tmp_path):
    cfg = reg.get("bst").smoke_config()
    params = R.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    tr = Trainer(lambda p, b: R.loss_fn(p, b, cfg), OptConfig(lr=1e-3),
                 TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=2,
                               log_every=1), device=cuda)
    out = tr.fit(params, seq_batches("bst", cfg.n_items, 16, cfg.seq_len),
                 n_steps=3)
    assert [h["step"] for h in out["history"]] == [0, 1, 2]
    assert all(torch.isfinite(torch.tensor(h["loss"]))
               for h in out["history"])
    assert all(t.is_cuda for t in out["params"]["blocks"].values())
    assert ck.latest_step(str(tmp_path)) == 3
    back = ck.restore(str(tmp_path), 3, {"params": params,
                                         "opt": out["opt"]})
    assert back["params"]["item_emb"].is_cuda
    assert torch.equal(back["params"]["item_emb"], out["params"]["item_emb"])
