"""Serving in bf16 and fp8 (``ServeConfig.compute_dtype`` / ``cache_dtype``
/ ``param_dtype``), the port against the JAX package on the CPU.

Rules, each measured here (the probes are the tests themselves):

* Conversions into bf16 and e4m3 are bit for bit ``jnp.astype``'s. e4m3
  follows the reference, not ``Tensor.to``: NaN past the tie at 464.
* XLA's CPU backend rounds a bf16 elementwise chain per op (``a*b+c``
  equals the per-op rounding everywhere), as PyTorch does, but keeps a
  square feeding a mean in f32 (``mean(x*x)`` equals the mean of the
  unrounded squares). The port rounds the square (its own op), so its
  rmsnorm mean is within one bf16 ulp of the reference's.
* GEMMs: bf16 and e4m3 products are exact in f32, so a product differs
  from the reference's only by the order of its f32 sums: after the final
  rounding (k, a format, then bf16), equal or one ulp of the last rounding
  apart.
* Whole models (SMOKE, a few layers): logits within a stated number of
  bf16 ulps of the largest logit, from the measured worst case; tokens
  equal, or (where not) the top-1 gap at the step is within that bound.
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)

import dataclasses
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.backend import JOps
from repro.kernels import flash_decode as jfd
from repro.kernels import quant_matmul as jqm
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import backend as tbackend
from repro_torch.core import dtypes
from repro_torch.core.backend import TorchOps
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.kernels import row_order as tro
from repro_torch.launch import batching as tbatching
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT

BF16, FP8 = torch.bfloat16, torch.float8_e4m3fn
FMT = (12, 15, -14)
FMT_MAP = {"": {"k": 12, "emax": 15, "emin": -14}}
B, PROMPT, STEPS = 2, 8, 4
MAX_SEQ = PROMPT + STEPS + 1


def _np(t):
    return t.float().numpy()


def _ulp_bf16(x):
    """bf16's spacing at |x| (f64), 2⁻¹³³ at least."""
    _, e = np.frexp(np.abs(np.asarray(x, np.float64)))
    return np.ldexp(1.0, np.maximum(e - 1, -126) - 7)


# --------------------------------------------------------------- rounding

E4M3_GRID = [0.0, -0.0, 448.0, -448.0, 449.0, 463.9, 464.0, -464.0, 464.01,
             465.0, 470.0, -470.0, 480.0, 500.0, 1e6, 2.0 ** -6, 2.0 ** -9,
             2.0 ** -10, -2.0 ** -10, 2.0 ** -10 * 1.0001, 2.0 ** -11,
             1.0625, 1.1875, 3.0 * 2.0 ** -9, 1e-30, math.inf, -math.inf,
             math.nan]


def test_e4m3_conversion_follows_the_reference():
    """dtypes.cast into e4m3 bit for bit ``jnp.astype`` on the grid (ties,
    the 464 tie, past it, subnormals, the tie to zero, ±inf, NaN) and on
    random values of every scale; ``Tensor.to`` saturates instead, which is
    why the port has its own conversion. Rule: bitwise (NaN alike)."""
    rng = np.random.RandomState(0)
    vals = np.concatenate([np.asarray(E4M3_GRID, np.float32),
                           (rng.randn(4000) * np.exp2(
                               rng.randint(-14, 10, 4000))).astype(
                               np.float32)])
    want = np.asarray(jnp.asarray(vals).astype(jnp.float8_e4m3fn))
    got = dtypes.cast(torch.from_numpy(vals), FP8)
    wf, gf = want.astype(np.float32), got.float().numpy()
    assert np.array_equal(np.isnan(wf), np.isnan(gf))
    ok = ~np.isnan(wf)
    assert np.array_equal(want.view(np.uint8)[ok],
                          got.view(torch.uint8).numpy()[ok])
    # Tensor.to saturates where the reference gives NaN
    assert float(torch.tensor(470.0).to(FP8).float()) == 448.0
    assert math.isnan(float(dtypes.cast(torch.tensor(470.0), FP8).float()))
    assert float(dtypes.cast(torch.tensor(464.0), FP8).float()) == 448.0
    assert float(dtypes.cast(torch.tensor(2.0 ** -10), FP8).float()) == 0.0


def test_bf16_conversion_is_the_references():
    """``Tensor.to(bfloat16)`` bit for bit ``jnp.astype`` (RNE ties,
    overflow to inf, subnormals, NaN). Rule: bitwise."""
    rng = np.random.RandomState(1)
    ties = (1.0 + np.arange(1, 64) * 2.0 ** -8 + 2.0 ** -9).astype(np.float32)
    vals = np.concatenate([
        np.asarray([0.0, -0.0, 3.3895e38, 3.4e38, -3.4e38, 1e-39, 1e-45,
                    math.inf, -math.inf, math.nan], np.float32), ties,
        (rng.randn(4000) * np.exp2(rng.randint(-130, 120, 4000))).astype(
            np.float32)])
    want = np.asarray(jnp.asarray(vals).astype(jnp.bfloat16))
    got = torch.from_numpy(vals).to(BF16)
    wf = want.astype(np.float32)
    ok = ~np.isnan(wf)
    assert np.array_equal(np.isnan(wf), np.isnan(got.float().numpy()))
    assert np.array_equal(want.view(np.uint16)[ok],
                          got.view(torch.int16).numpy().view(np.uint16)[ok])


def test_params_from_numpy_keeps_ml_dtypes_bits():
    rng = np.random.RandomState(2)
    tree = {"a": rng.randn(5, 7).astype(ml_dtypes.bfloat16),
            "b": {"c": (rng.randn(3, 4) * 8).astype(ml_dtypes.float8_e4m3fn)},
            "d": rng.randn(3).astype(np.float32)}
    got = params_from_numpy(tree, "cpu")
    assert got["a"].dtype == BF16 and got["b"]["c"].dtype == FP8
    assert np.array_equal(got["a"].view(torch.int16).numpy().view(np.uint16),
                          tree["a"].view(np.uint16))
    assert np.array_equal(got["b"]["c"].view(torch.uint8).numpy(),
                          tree["b"]["c"].view(np.uint8))
    assert np.array_equal(got["d"].numpy(), tree["d"])


@pytest.mark.parametrize("arch", ["qwen2_7b", "rwkv6_1p6b", "mixtral_8x22b",
                                  "minicpm3_4b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float8_e4m3fn"])
def test_init_params_dtype_is_the_f32_init_cast(arch, dtype):
    """``init_params(dtype=)`` fills stacked leaves a layer slice at a time
    and rounds them: bit for bit the f32 init cast by ``dtypes.cast``."""
    cfg = tconfigs.get(arch).SMOKE
    dt = getattr(torch, dtype)
    f32 = TT.init_params(cfg, generator=torch.Generator().manual_seed(3),
                         device="cpu")
    narrow = TT.init_params(cfg, generator=torch.Generator().manual_seed(3),
                            device="cpu", dtype=dt)

    def leaves(t, p=()):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, p + (k,))
        else:
            yield p, t

    for (path, a), (_, b) in zip(leaves(f32), leaves(narrow)):
        assert b.dtype == dt, path
        want = dtypes.cast(a, dt)
        view = torch.int16 if dt == BF16 else torch.uint8
        assert torch.equal(want.view(view), b.view(view)), path


# ------------------------------------------------- plain versions vs JAX

def _gemm_operands(seed, M, K, N, wdt):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(BF16)
    w = dtypes.cast(torch.from_numpy(
        (rng.randn(K, N) / math.sqrt(K)).astype(np.float32)), wdt)
    jx = jnp.asarray(_np(x)).astype(jnp.bfloat16)
    jw = jnp.asarray(_np(w)).astype(
        jnp.bfloat16 if wdt == BF16 else jnp.float8_e4m3fn)
    return x, w, jx, jw


def _one_ulp_apart(got, want, ulp):
    """Equal, or one ``ulp(value)`` apart: the GEMM contract's last
    rounding."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    lim = ulp(np.maximum(np.abs(got), np.abs(want)))
    return float((diff / np.where(lim > 0, lim, 1)).max()), bool(
        np.all(diff <= lim))


@pytest.mark.parametrize("wdt", [BF16, FP8], ids=["bf16", "e4m3"])
def test_gemm_plain_versions_against_the_reference_kernels(wdt):
    """bf16 x against bf16 or e4m3 w: kernel 1's and kernel 3's plain
    versions (then cast to bf16, as the backends do) against the
    reference's Pallas kernels in interpret mode on the same narrow
    operands (then ``.astype(bf16)``), and ``f32_matmul``'s against
    ``jnp.matmul(preferred_element_type=f32)``. Rule: equal or one ulp of
    the last rounding apart (the products are exact in f32; only the sums'
    order differs). Measured worst: see the asserts' messages."""
    M, K, N = 8, 96, 64
    x, w, jx, jw = _gemm_operands(4, M, K, N, wdt)
    got = tqm.quant_matmul_format_dispatch(x, w, FMT)
    assert got.dtype == BF16
    want = jqm.quant_matmul_format(jx, jw, jnp.asarray(FMT), block_k=K,
                                   interpret=True).astype(jnp.bfloat16)
    ulps, ok = _one_ulp_apart(_np(got), np.asarray(want, np.float32),
                              _ulp_bf16)
    assert ok, f"quant_matmul_format: {ulps} bf16 ulps"
    got = tqm.quant_matmul_dynamic_k(x, w, 12)
    want = jqm.quant_matmul(jx, jw, k=12, block_k=K,
                            interpret=True).astype(jnp.bfloat16)
    ulps, ok = _one_ulp_apart(_np(got), np.asarray(want, np.float32),
                              _ulp_bf16)
    assert ok, f"quant_matmul: {ulps} bf16 ulps"
    got = tro.matmul_dispatch(x, w)
    want = jnp.matmul(jx, jw.astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32).astype(
        jnp.bfloat16)
    ulps, ok = _one_ulp_apart(_np(got), np.asarray(want, np.float32),
                              _ulp_bf16)
    assert got.dtype == BF16 and ok, f"f32_matmul: {ulps} bf16 ulps"


def test_row_mean_bf16_and_the_xla_square_probe():
    """The probe: XLA's jitted ``mean(x*x)`` in bf16 equals the f32 mean of
    the UNROUNDED squares, rounded once (the square stays in f32 inside the
    fusion), while a jitted ``a*b+c`` rounds per op. The port squares as
    its own op (rounded to bf16, as the rmsnorm is written), then
    ``row_mean``'s plain version means in f32 and rounds: within one bf16
    ulp of the reference's rmsnorm mean. Measured: 97 % equal, the rest one
    ulp."""
    rng = np.random.RandomState(5)
    x = rng.randn(64, 448).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    xf = np.asarray(jx, np.float32)
    ref = np.asarray(jax.jit(lambda a: jnp.mean(a * a, axis=-1,
                                                keepdims=True))(jx),
                     np.float32)
    unrounded = (xf.astype(np.float64) ** 2).mean(-1, keepdims=True)
    assert np.array_equal(ref, np.asarray(
        jnp.asarray(unrounded.astype(np.float32)).astype(jnp.bfloat16),
        np.float32)) or _one_ulp_apart(ref, unrounded, _ulp_bf16)[1]
    a, b2, c = (jnp.asarray(rng.randn(4096).astype(np.float32)).astype(
        jnp.bfloat16) for _ in range(3))
    per_op = (torch.from_numpy(np.asarray(a, np.float32)).to(BF16)
              * torch.from_numpy(np.asarray(b2, np.float32)).to(BF16)
              + torch.from_numpy(np.asarray(c, np.float32)).to(BF16))
    assert np.array_equal(np.asarray(jax.jit(lambda p, q, r: p * q + r)(
        a, b2, c), np.float32), _np(per_op))
    bk = TorchOps(BF16)
    tx = torch.from_numpy(xf).to(BF16)
    got = bk.mean(bk.square(tx), dim=-1, keepdim=True)
    assert got.dtype == BF16
    assert torch.equal(got.float(), tro.row_mean_dispatch(
        bk.square(tx)).float())
    ulps, ok = _one_ulp_apart(_np(got), ref, _ulp_bf16)
    assert ok, f"rmsnorm mean: {ulps} bf16 ulps from the reference's"


@pytest.mark.parametrize("cdt", [BF16, FP8], ids=["bf16", "e4m3"])
def test_decode_plain_versions_against_the_reference(cdt):
    """bf16 q with a bf16 or e4m3 cache. Kernel 2's plain version against
    the reference's certified Pallas kernel in interpret mode (q/k/v
    rounded into the format as they load, output rounded, then written in
    q's dtype): equal or one bf16 ulp (the kernel and the oracle sum in
    other orders before the format's rounding). Kernel 4's bf16 plain
    version against the reference's composed bf16 path through its own
    ``JOps(bfloat16)`` (einsum, scale, softcap, mask, softmax, einsum,
    jitted): within two bf16 ulps of max |v| (XLA keeps some of that chain
    in f32 inside its fusions; measured worst in the message)."""
    rng = np.random.RandomState(6)
    Bq, H, G, D, S = 2, 2, 3, 32, 80
    lens = np.array([80, 37], np.int32)
    q = torch.from_numpy(rng.randn(Bq, H, G, D).astype(np.float32)).to(BF16)
    k, v = (dtypes.cast(torch.from_numpy(rng.randn(Bq, S, H, D).astype(
        np.float32)), cdt) for _ in range(2))
    jdt = jnp.bfloat16 if cdt == BF16 else jnp.float8_e4m3fn
    jq = jnp.asarray(_np(q)).astype(jnp.bfloat16)
    jk, jv = (jnp.asarray(_np(t)).astype(jdt) for t in (k, v))
    lengths = torch.from_numpy(lens)
    got = tfd.certified_decode_attention(q, k, v, lengths, FMT)
    want = jfd.flash_decode_certified(jq, jk, jv, jnp.asarray(lens),
                                      jnp.asarray(FMT), block_s=S,
                                      interpret=True)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    ulps, ok = _one_ulp_apart(_np(got), np.asarray(want, np.float32),
                              _ulp_bf16)
    assert ok, f"kernel 2: {ulps} bf16 ulps"
    vmax = float(np.abs(_np(v)).max())
    for window, cap in ((0, 0.0), (16, 50.0)):
        got = tfd.flash_decode_bf16_ref(q, k, v, lengths, window=window,
                                        softcap=cap)
        bk = JOps(jnp.bfloat16)

        def composed(qq, kk, vv):
            kk, vv = bk.input(kk), bk.input(vv)
            s = bk.einsum("bkgd,bskd->bkgs", qq, kk)
            s = bk.scale(s, D ** -0.5)
            if cap:
                s = bk.softcap(s, cap)
            pos = jnp.arange(S)[None, :]
            n = jnp.asarray(lens)[:, None]
            ok = pos < n
            if window:
                ok = ok & (pos >= n - window)
            s = bk.where(ok[:, None, None, :], s, bk.const(-1e9))
            return bk.einsum("bkgs,bskd->bkgd", bk.softmax(s, axis=-1), vv)

        want = np.asarray(jax.jit(composed)(jq, jk, jv), np.float32)
        err = float(np.abs(_np(got) - want).max())
        assert got.dtype == BF16
        assert err <= 2 * _ulp_bf16(vmax), (
            f"kernel 4 bf16 (window {window}, cap {cap}): {err} against "
            f"{2 * _ulp_bf16(vmax)}")


def test_kernel4_bf16_plain_version_rules():
    """The bf16 plain version's own contract, in f32 arithmetic on the CPU:
    a lane of length 0 attends all S positions uniformly (the mean of v in
    bf16 weights), positions past a lane's length and below its window are
    never read (NaN there changes nothing), and the chunked fold equals one
    chunk where S ≤ 64. Rule: exact."""
    rng = np.random.RandomState(7)
    q = torch.from_numpy(rng.randn(2, 1, 2, 16).astype(np.float32)).to(BF16)
    k, v = (torch.from_numpy(rng.randn(2, 200, 1, 16).astype(
        np.float32)).to(BF16) for _ in range(2))
    lengths = torch.tensor([150, 0], dtype=torch.int32)
    base = tfd.flash_decode_bf16_ref(q, k, v, lengths, window=100)
    k2, v2 = k.clone(), v.clone()
    k2[0, 150:] = v2[0, 150:] = float("nan")
    k2[0, :50] = v2[0, :50] = float("nan")
    again = tfd.flash_decode_bf16_ref(q, k2, v2, lengths, window=100)
    assert torch.equal(base[0].float(), again[0].float())
    p = tfd._rbf(torch.tensor(1.0 / 200))
    mean = (p * v[1].float()).sum(0)          # all weights equal, one chunk
    assert float((base[1].float() - mean.to(BF16).float()).abs().max()) \
        <= float(_ulp_bf16(float(mean.abs().max())))


# ------------------------------------------- models against the reference

def _jax_params(cfg, pdt):
    jp = JT.init_params(jax.random.PRNGKey(0), cfg)
    if pdt is not None:
        jp = jax.tree_util.tree_map(lambda a: a.astype(pdt), jp)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")


def _serve_both(arch, cache, param, steps=STEPS, compute="bfloat16",
                **sc_kw):
    """The reference's own ``build_serve_steps`` (jitted on a one-device
    mesh with Auto axes) and the port's ``prefill_step`` / ``decode_step``
    on the same params (cast as the dry run stores them) and prompt, each
    greedy on its own tokens, with a ``cache``-dtype cache. Returns
    (reference prefill logits, reference tokens, reference cache, port
    prefill logits, port tokens, port decode logits, port cache)."""
    jcfg, tcfg = jconfigs.get(arch).SMOKE, tconfigs.get(arch).SMOKE
    pdt = {"same": jserve.DTYPES[compute], "fp8": jnp.float8_e4m3fn}[param]
    jp, tp = _jax_params(jcfg, pdt)
    jsc = jserve.ServeConfig(arch=arch, batch=B, max_seq=MAX_SEQ,
                             prefill_len=PROMPT, compute_dtype=compute,
                             cache_dtype=cache, param_dtype=param, **sc_kw)
    tsc = tserve.ServeConfig(arch=arch, batch=B, max_seq=MAX_SEQ,
                             prefill_len=PROMPT, compute_dtype=compute,
                             cache_dtype=cache, param_dtype=param,
                             device="cpu", **sc_kw)
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)
    toks = np.random.RandomState(0).randint(0, jcfg.vocab, (B, PROMPT))
    cdt = jserve.DTYPES[cache]
    with mesh:
        prefill, decode, _ = jserve.build_serve_steps(jcfg, jsc, mesh)
        jc = JT.init_cache(jcfg, B, MAX_SEQ, cdt)
        jl, jc = prefill(jp, jc, {"tokens": jnp.asarray(toks)})
        jt = jnp.argmax(jl[:, -1], -1)
        jtoks = [np.asarray(jt)]
        for i in range(steps):
            jt, jc = decode(jp, jc, {"tokens": jt[:, None],
                                     "pos": jnp.asarray(PROMPT + i,
                                                        jnp.int32)})
            jtoks.append(np.asarray(jt))
    bk = tserve._backend(tsc)
    tc = TT.init_cache(tcfg, B, MAX_SEQ, device="cpu", dtype=tsc.dtypes[1])
    with torch.no_grad():
        tl, tc = tserve.prefill_step(bk, tp, tcfg, tc, torch.from_numpy(toks))
        tt = torch.argmax(tl[:, -1], -1)
        ttoks, tlogits = [tt.numpy()], []
        for i in range(steps):
            tt, last, tc = tserve.decode_step(bk, tp, tcfg, tc, tt[:, None],
                                              PROMPT + i)
            ttoks.append(tt.numpy())
            tlogits.append(last)
    return (np.asarray(jl[:, -1], np.float32), np.stack(jtoks, 1), jc,
            _np(tl[:, -1]), np.stack(ttoks, 1), tlogits, tc)


# the rules, from the measured worst cases over the model tests below (12.75
# bf16 ulps of max |logit| on Qwen2 with e4m3 params and cache, 4.44 ulps
# on Gemma-2's bf16 cache, 0.89 of e4m3's unit on RWKV6's state): XLA keeps
# the rmsnorm's squares in f32 where the port rounds them (one bf16 ulp of
# the mean in a few percent of rows), and that spreads through the layers
LOGIT_ULPS, BF16_CACHE_ULPS, E4M3_CACHE_UNITS = 16, 6, 1.5


def _check_model(out, logit_ulps=LOGIT_ULPS, cache_ulps=BF16_CACHE_ULPS,
                 e4m3_units=E4M3_CACHE_UNITS):
    """Prefill logits within ``logit_ulps`` bf16 ulps of max |logit|;
    tokens equal, or the port's top-1 gap at the first differing step
    within that bound; every float cache buffer within ``cache_ulps`` bf16
    ulps of its max (``e4m3_units`` of 2⁻³·max for an e4m3 one). Returns
    the measured worst cases."""
    jl, jtoks, jc, tl, ttoks, tlogits, tc = out
    tol = logit_ulps * float(_ulp_bf16(np.abs(jl).max()))
    err = float(np.abs(tl - jl).max())
    assert err <= tol, f"prefill logits {err} > {tol}"
    if not np.array_equal(jtoks, ttoks):
        step = int(np.argmax((jtoks != ttoks).any(0)))
        lg = _np(tlogits[step - 1]) if step else tl
        top2 = np.sort(lg, -1)[:, -2:]
        gap = float((top2[:, 1] - top2[:, 0]).min())
        assert gap <= 2 * tol, (f"tokens differ at step {step} with a top-1 "
                                f"gap {gap}")
    worst = {}
    for name, buf in tc.items():
        if not buf.is_floating_point():
            continue
        want = np.asarray(jc[name].astype(jnp.float32))
        got = _np(buf)
        assert got.shape == want.shape, name
        unit = (float(_ulp_bf16(np.abs(want).max())) if buf.dtype != FP8
                else float(np.abs(want).max()) * 2.0 ** -3)
        worst[name] = float(np.abs(got - want).max()) / unit
        assert worst[name] <= (cache_ulps if buf.dtype != FP8
                               else e4m3_units), (name, worst[name])
    return err / float(_ulp_bf16(np.abs(jl).max())), worst


QWEN_PATHS = {"plain": {}, "k": {"precision_k": 12},
              "format": {"precision_layer_format": FMT_MAP}}


@pytest.mark.parametrize("cache,param", [("bfloat16", "same"),
                                         ("fp8", "fp8")],
                         ids=["bf16_cache", "fp8_cache_params"])
@pytest.mark.parametrize("path", list(QWEN_PATHS))
def test_qwen2_smoke_narrow_serving_against_build_serve_steps(path, cache,
                                                              param):
    """Qwen2 SMOKE in bf16 on the plain, k = 12 and format backends, with a
    bf16 cache and bf16 params, then an e4m3 cache and e4m3 params, against
    the reference's ``build_serve_steps`` given the same. Rule: LOGIT_ULPS
    on the prefill logits, the caches within theirs (_check_model)."""
    _check_model(_serve_both("qwen2_7b", cache, param, **QWEN_PATHS[path]))


def test_gemma2_smoke_bf16_softcap_against_build_serve_steps():
    """Gemma-2 SMOKE in bf16 (softcapped attention and logits, local /
    global layers) under the format map: the composed bf16 decode of the
    reference against the port's. Rule as Qwen2's."""
    _check_model(_serve_both("gemma2_27b", "bfloat16", "same",
                             precision_layer_format=FMT_MAP))


def test_rwkv6_smoke_e4m3_state_against_build_serve_steps():
    """RWKV6 SMOKE in bf16 with its state S and token-shift rows stored in
    e4m3 (upcast at use), plain backend. Rule as Qwen2's."""
    _check_model(_serve_both("rwkv6_1p6b", "fp8", "same"))


def test_minicpm3_smoke_bf16_latent_cache_against_build_serve_steps():
    """MiniCPM3 SMOKE with a bf16 latent cache (c and the rope key), k =
    12, written by rounding and read by upcasting. In f32 compute: the
    reference's bf16-compute MLA step does not run on XLA's CPU backend
    ("Unsupported element type for DotThunk::Execute: BF16 x BF16 = F32").
    Rule as Qwen2's (the logits in bf16 ulps, though f32)."""
    _check_model(_serve_both("minicpm3_4b", "bfloat16", "same",
                             compute="float32", precision_k=12))


# ----------------------------------------------------------- the engine

def test_engine_lanes_in_bf16():
    """The engine in bf16 (params in bf16, its f32 cache as the reference
    engine's) under the format map: every request's tokens equal the
    request alone (``reference_generate``); its logits are bf16; a
    ServeConfig asking the engine for a narrower cache raises."""
    cfg = tconfigs.get("qwen2_7b").SMOKE
    params = TT.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu", dtype=BF16)
    sc = tserve.ServeConfig(arch="qwen2_7b", batch=2, max_seq=48,
                            compute_dtype="bfloat16", device="cpu",
                            precision_layer_format=FMT_MAP)
    rng = np.random.RandomState(8)
    reqs = [tbatching.Request(rid=i, prompt=rng.randint(
        0, cfg.vocab, int(rng.randint(5, 20))).tolist(), max_new_tokens=5,
        arrival_step=2 * i) for i in range(4)]
    engine = tbatching.ContinuousBatchingEngine(
        cfg, sc, params, n_lanes=2, max_seq=48, page_size=16, device="cpu",
        keep_logits=True)
    assert engine.cache["k"].dtype == torch.float32
    out = {r["id"]: r for r in engine.run(reqs)}
    for req in reqs:
        want = tbatching.reference_generate(cfg, sc, params, req.prompt, 5,
                                            max_seq=48)
        assert out[req.rid]["tokens"] == want
        assert out[req.rid]["logits"].dtype == BF16
    with pytest.raises(ValueError):
        tbatching.ContinuousBatchingEngine(
            cfg, dataclasses.replace(sc, cache_dtype="bfloat16"), params,
            n_lanes=2, max_seq=48, device="cpu")


# ------------------------------------------------------ config and route

def test_serve_config_dtype_names():
    """The reference's fields and defaults; any other name raises
    ValueError (the reference reads an unknown compute_dtype as f32)."""
    sc = tserve.ServeConfig()
    assert (sc.compute_dtype, sc.cache_dtype, sc.param_dtype) == (
        "float32", "float32", "same")
    assert sc.dtypes == (torch.float32, torch.float32, torch.float32)
    assert tserve.ServeConfig(compute_dtype="bfloat16", cache_dtype="fp8",
                              param_dtype="fp8").dtypes == (BF16, FP8, FP8)
    for bad in ({"compute_dtype": "float16"}, {"compute_dtype": "fp8"},
                {"cache_dtype": "float16"}, {"param_dtype": "bfloat16"}):
        with pytest.raises(ValueError):
            tserve.ServeConfig(**bad)
    assert tserve._backend(tserve.ServeConfig(
        compute_dtype="bfloat16")).compute_dtype == BF16
    assert tserve._backend(tserve.ServeConfig(
        compute_dtype="bfloat16", precision_k=12)).compute_dtype == BF16


def test_serve_main_allocates_narrow_cache_and_params(monkeypatch):
    """``serve.main`` stores params in the compute dtype or e4m3 and
    allocates the cache in the cache dtype (the CLI's three flags)."""
    seen = {}
    real_cache, real_params = TT.init_cache, TT.init_params

    def cache(*a, **kw):
        seen["cache"] = kw.get("dtype")
        return real_cache(*a, **kw)

    def params(*a, **kw):
        seen["params"] = kw.get("dtype")
        return real_params(*a, **kw)

    monkeypatch.setattr(TT, "init_cache", cache)
    monkeypatch.setattr(TT, "init_params", params)
    res = tserve.main(["--device", "cpu", "--batch", "2", "--prefill-len",
                       "6", "--decode-steps", "2", "--compute-dtype",
                       "bfloat16", "--cache-dtype", "fp8", "--param-dtype",
                       "fp8"])
    assert seen == {"cache": FP8, "params": FP8}
    assert res.prefill_logits.dtype == BF16
    assert res.params["layers"]["attn"]["wq"].dtype == FP8


def test_card_route_refuses_other_dtypes(monkeypatch):
    """The card's product route: with the route predicate told that every
    tensor lies on the card, an f16 product raises instead of reaching
    ``torch.matmul``, an f32 / bf16 one (e4m3 weights too) goes to the
    fixed-order kernel's dispatch, and f64 (the analysis's exact model)
    stays a library product."""
    monkeypatch.setattr(tbackend, "_on_card", lambda t: True)
    called = []
    monkeypatch.setattr(tbackend.row_order, "matmul_dispatch",
                        lambda a, b: called.append((a.dtype, b.dtype)) or a
                        @ b.float().to(a.dtype))

    def no_library(*a, **kw):
        raise AssertionError("torch.matmul reached")

    x16 = torch.ones(2, 3, dtype=torch.float16)
    w16 = torch.ones(3, 4, dtype=torch.float16)
    monkeypatch.setattr(torch, "matmul", no_library)
    with pytest.raises(ValueError):
        TorchOps(torch.float16).matmul(x16, w16)
    with pytest.raises(ValueError):
        TorchOps(torch.float16).einsum("bsd,vd->bsv", x16[None], w16.t())
    bk = TorchOps(BF16)
    bk.matmul(torch.ones(2, 3, dtype=BF16), dtypes.cast(torch.ones(3, 4),
                                                         FP8))
    TorchOps(torch.float32).matmul(torch.ones(2, 3), torch.ones(3, 4))
    assert called == [(BF16, FP8), (torch.float32, torch.float32)]
    monkeypatch.undo()
    out = TorchOps(torch.float64).matmul(torch.ones(2, 3, dtype=torch.float64),
                                         torch.ones(3, 4,
                                                    dtype=torch.float64))
    assert out.dtype == torch.float64


def test_card_latent_decode_route(monkeypatch):
    """MLA's decode step with the route predicate told that every tensor
    lies on the card: in f32 a bf16 latent cache reaches kernel 4 upcast
    (exact) in the one copy the step makes; a bf16 step reaches the latent
    kernel with the cache's own buffers (no copy) and q as [B, H, R] /
    [B, H, Dr]; any other dtype raises instead of composing library
    products; f64 (the analysis's exact model) keeps the composed path."""
    monkeypatch.setattr(tbackend, "_on_card", lambda t: True)
    seen = []
    monkeypatch.setattr(
        tbackend.flash_decode, "flash_decode_attention",
        lambda q, k, v, lengths, scale: seen.append((q.dtype, k.dtype))
        or q)
    latent = []

    def fake_latent(q_lat, q_rope, c, k_rope, lengths, scale):
        latent.append((q_lat.shape, q_rope.shape, c, k_rope, scale))
        return q_lat

    monkeypatch.setattr(tbackend.flash_decode, "latent_decode_bf16",
                        fake_latent)
    B, S, H, R, Dr = 2, 5, 3, 8, 4
    c = torch.randn(B, S, R).to(BF16)
    k_rope = torch.randn(B, S, Dr).to(BF16)
    lengths = torch.tensor([5, 2], dtype=torch.int32)
    out = TorchOps(torch.float32).latent_decode_attention(
        torch.randn(B, 1, H, R), torch.randn(B, 1, H, Dr), c, k_rope,
        lengths, 0.5)
    assert seen == [(torch.float32, torch.float32)]
    assert out.shape == (B, 1, H, R)
    out = TorchOps(BF16).latent_decode_attention(
        torch.randn(B, 1, H, R).to(BF16), torch.randn(B, 1, H, Dr).to(BF16),
        c, k_rope, lengths, 0.5)
    assert out.shape == (B, 1, H, R) and out.dtype == BF16
    [(ql, qr, c_in, r_in, scale)] = latent
    assert (ql, qr, scale) == ((B, H, R), (B, H, Dr), 0.5)
    assert c_in is c and r_in is k_rope
    with pytest.raises(ValueError, match="latent decode"):
        TorchOps(torch.float16).latent_decode_attention(
            torch.randn(B, 1, H, R).half(), torch.randn(B, 1, H, Dr).half(),
            c, k_rope, lengths, 0.5)
    assert TorchOps(torch.float64).latent_decode_attention(
        *(t.double() for t in (torch.randn(B, 1, H, R),
                               torch.randn(B, 1, H, Dr), c, k_rope)),
        lengths, 0.5) is None
