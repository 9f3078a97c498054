"""The ``numeric_health`` CUDA kernel against its plain version, on a card.

These tests need a CUDA device (the kernel has no CPU mode) and skip
without one; they import nothing of JAX:
``python -m pytest -q --noconftest -m cuda tests/test_torch_health_cuda.py``.

Every stat must equal the plain version's (``core.quantize.numeric_health``
on the same card tensor) bit for bit: max_abs and min_nonzero are a max and
a min, the counts are integers, so no summation order enters. Held on the
outputs of the seven Qwen2-7B projections at M = 4 and 512, on edge inputs
(NaN, ±inf, −0, f32 subnormals, all zero, all beyond max_finite), at k ∈
{8, 12, 24, 26} and emin ∈ {−6, −14, −126, −150}, from an unaligned start
(the kernel's scalar path) and twice in a row (the same bits).
"""
import math

import pytest
import torch

from repro_torch.core.quantize import numeric_health as plain
from repro_torch.kernels import health

# Qwen2-7B's projections: N of wq, wk, wv, wo, w_gate, w_up, w_down
PROJ_N = (3584, 512, 512, 3584, 18944, 18944, 3584)
FORMATS = [(k, 15, emin) for k in (8, 12, 24, 26)
           for emin in (-6, -14, -126, -150)] + [(12, 127, -126)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def plain_row(x, fmt):
    row = health.init_rows(1, x.device)
    health.pack_row(plain(x, *fmt), row[0])
    return row


def kernel_row(x, fmt):
    row = health.init_rows(1, x.device)
    health.numeric_health(x, *fmt, row, 0)
    return row


def assert_same_row(x, fmt):
    got, want = kernel_row(x, fmt), plain_row(x, fmt)
    assert torch.equal(got, want), (fmt, health.unpack_rows(got.cpu()),
                                    health.unpack_rows(want.cpu()))
    return health.unpack_rows(got.cpu())[0]


def _products(dev, M, N, seed):
    """A projection-shaped product: magnitudes over many binades, a few
    tiny and a few large values, as a served product has."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(M, N, device=dev, generator=gen)
    scale = torch.exp2(torch.randint(-40, 20, (M, N), device=dev,
                                     generator=gen).float())
    return (x * scale).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4, 512])
def test_projection_outputs_bitwise(cuda_device, M):
    for i, N in enumerate(PROJ_N):
        x = _products(cuda_device, M, N, seed=M + i)
        for fmt in ((8, 15, -14), (12, 15, -14), (24, 127, -126),
                    (26, 127, -150), (10, 7, -6)):
            st = assert_same_row(x, fmt)
            if fmt[2] > -100:
                assert st["n_under"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
def test_edge_inputs_bitwise(cuda_device, fmt):
    dev = cuda_device
    inf, nan = math.inf, math.nan
    sub = 2.0 ** -140
    max_bits, _ = health.threshold_bits(*fmt)
    cases = {
        "specials": torch.tensor([nan, inf, -inf, -0.0, 0.0, 1.5, -2.0,
                                  sub, -sub, 2.0 ** -149, 3e38], device=dev),
        "all_zero": torch.zeros(1000, device=dev),
        "neg_zero": torch.full((77,), -0.0, device=dev),
        "all_nan": torch.full((33,), nan, device=dev),
        "subnormals": torch.arange(1, 5001, device=dev,
                                   dtype=torch.float32) * 2.0 ** -149,
        "all_over": torch.full((4096 + 3,), 3.0e38, device=dev),
    }
    if max_bits != 0x7f800000:
        over = torch.tensor([max_bits], dtype=torch.int32).view(
            torch.float32).item()
        cases["at_and_past_max"] = torch.tensor(
            [over, -over, over * 1.001 if over < 3e38 else over],
            device=dev)
    for name, x in cases.items():
        st = assert_same_row(x, fmt)
        if name == "all_zero":
            assert st["max_abs"] == 0.0 and st["min_nonzero"] == math.inf
        if name == "all_nan":
            assert st["n_nonfinite"] == 33 and st["max_abs"] == 0.0


@pytest.mark.cuda
def test_unaligned_start_and_repeat_bitwise(cuda_device):
    x = _products(cuda_device, 4, 18944 + 1, seed=9).reshape(-1)
    for off in (1, 2, 3):
        view = x[off:]
        assert view.data_ptr() % 16
        assert_same_row(view, (12, 15, -14))
    big = _products(cuda_device, 512, 18944, seed=10)
    first = kernel_row(big, (10, 15, -14))
    for _ in range(3):
        assert torch.equal(kernel_row(big, (10, 15, -14)), first)


@pytest.mark.cuda
def test_log_rows_and_launch_count(cuda_device):
    """Rows of one log are independent; each call launches once; the
    dispatch makes a non-contiguous product contiguous first."""
    buf = health.init_rows(3, cuda_device)
    xs = [_products(cuda_device, 4, n, seed=n) for n in (512, 3584)]
    xs.append(_products(cuda_device, 64, 64, seed=1).t())
    before = health.numeric_health.launches
    for r, x in enumerate(xs):
        health.numeric_health_dispatch(x, 12, 15, -14, buf, r)
    assert health.numeric_health.launches == before + 3
    for r, x in enumerate(xs):
        assert torch.equal(buf[r:r + 1], plain_row(x.contiguous(),
                                                    (12, 15, -14)))
    with pytest.raises(ValueError):
        health.numeric_health(xs[2], 12, 15, -14, buf, 0)   # not contiguous
    with pytest.raises(ValueError):
        health.numeric_health(xs[0].double(), 12, 15, -14, buf, 0)
