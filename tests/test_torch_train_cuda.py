"""Training on a card against the CPU port (``repro_torch.launch.train``):
Qwen2-7B's SMOKE loss and gradients on the card within the rule of the CPU
tests (loss within 1e-5 relative, each gradient leaf within 1e-4 of its
max |g|) of the CPU port's on the same params and batch, the same with
each layer rematerialised bit for bit, and no hand-written kernel
launched (the routes step aside under autograd). These tests need a CUDA
device and skip without one; they import nothing of JAX:
``python -m pytest -q --noconftest -m cuda tests/test_torch_train_cuda.py``.
"""
import os

import pytest
import torch

from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.kernels import flash_decode, health, quant_matmul, row_order
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.optim.optimizer import tree_paths

# before the process's first cuBLAS call: the deterministic mode needs it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG",
                      train.CUBLAS_WORKSPACE_CONFIG)

KERNELS = (quant_matmul.quant_matmul_format, quant_matmul.quant_matmul,
           quant_matmul.round_k_inplace, flash_decode.flash_decode_attention,
           flash_decode.flash_decode_certified, row_order.row_mean,
           row_order.f32_matmul, health.numeric_health)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def to(tree, dev):
    return {k: to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


@pytest.mark.cuda
def test_smoke_grads_on_the_card_match_the_cpu(cuda_device):
    cfg = configs.get("qwen2_7b").SMOKE
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    batch = pipeline.batch_at(pipeline.DataConfig(
        vocab=cfg.vocab, seq=16, global_batch=2), 0)
    for fn in KERNELS:
        fn.launches = 0
    runs = {}
    for name, dev, remat in (("card", cuda_device, True),
                             ("card_plain", cuda_device, False),
                             ("cpu", "cpu", True)):
        tc = train.TrainConfig(seq=16, global_batch=2, remat=remat)
        with train.deterministic():
            runs[name] = train.loss_and_grads(train.make_loss_fn(cfg, tc),
                                              to(params, dev),
                                              to(batch, dev))
    assert all(fn.launches == 0 for fn in KERNELS)
    (cl, cg), (pl, pg), (hl, hg) = (runs[k] for k in
                                    ("card", "card_plain", "cpu"))
    assert torch.equal(cl, pl)
    pg, hg = dict(tree_paths(pg)), dict(tree_paths(hg))
    assert abs(float(cl) - float(hl)) <= 1e-5 * abs(float(hl))
    for path, g in tree_paths(cg):
        assert torch.equal(g, pg[path]), path
        want = hg[path]
        err = float((g.cpu() - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), path


@pytest.mark.cuda
def test_checkpoint_streams_to_the_card(cuda_device, tmp_path):
    """A card's state saved (through reused pinned host buffers) and
    restored (through one pinned slice, arrays larger than a slice among
    them) comes back bit for bit, twice."""
    from repro_torch.checkpoint.checkpointing import Checkpointer

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    state = {"big": torch.randn(70 << 18, device=cuda_device, generator=gen),
             "q": torch.randint(-127, 128, (3, 129), dtype=torch.int8,
                                device=cuda_device),
             "step": torch.tensor(4, dtype=torch.int32, device=cuda_device)}
    ck = Checkpointer(str(tmp_path))
    for step in (1, 2):
        ck.save(step, state, blocking=False)
        want = {k: v.clone() for k, v in state.items()}
        state["big"].add_(1.0)              # after save returned
        ck.wait()
        got, _ = ck.restore({k: torch.empty_like(v, device="meta")
                             for k, v in state.items()}, step,
                            device=cuda_device)
        for k, v in want.items():
            assert got[k].is_cuda and torch.equal(got[k], v), k
