"""MLA's latent decode in bf16 (MiniCPM3 under ``compute_dtype``
"bfloat16"), the port against the JAX package on the CPU.

* ``latent_decode_bf16_ref`` (the plain version of
  ``csrc/latent_decode_bf16.cu``) against the reference's composed bf16
  path through its own ``JOps(bfloat16)`` (the absorbed einsums, their
  sum, the scale, the mask, softmax, the mix of c; jitted; the einsums
  given f32 copies of their bf16 operands, as XLA's CPU backend has no
  bf16 × bf16 → f32 dot): within two
  bf16 ulps of max |c|, the rule ``tests/test_torch_dtypes.py`` sets for
  kernel 4's bf16 instance: XLA keeps some of that chain in f32
  inside its fusions, and the two sum the chunks in other orders.
* The plain version's own contract: positions past a lane's length are
  never read, a lane of length 0 attends every position uniformly, the
  chunked fold equals one chunk where S ≤ 64. Exact.
* MiniCPM3 SMOKE decoding in bf16 with the latent route taken (the
  wrapper runs its plain version on the CPU) against the reference's f32
  step: the reference's bf16 MLA step does not run on XLA's CPU backend
  ("Unsupported element type for DotThunk::Execute: BF16 x BF16 = F32",
  ``ROADMAP.md`` §3), so the bf16 port is held to the f32 reference within
  the bf16 model rule of ``tests/test_torch_dtypes.py`` (16 bf16 ulps of
  max |logit|; tokens equal or the top-1 gap within it).
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.backend import JOps
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import backend as tbackend
from repro_torch.core import dtypes
from repro_torch.kernels import flash_decode as tfd
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT

BF16, FP8 = torch.bfloat16, torch.float8_e4m3fn
LOGIT_ULPS = 16          # tests/test_torch_dtypes.py's model rule


def _np(t):
    return t.float().numpy()


def _ulp_bf16(x):
    """bf16's spacing at |x| (f64), 2⁻¹³³ at least."""
    _, e = np.frexp(np.abs(np.asarray(x, np.float64)))
    return np.ldexp(1.0, np.maximum(e - 1, -126) - 7)


def _operands(seed, B, H, R, Dr, S, cdt):
    """q_lat, q_rope in bf16 and c, k_rope in ``cdt`` (torch), seeded."""
    rng = np.random.RandomState(seed)
    f = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32))
    return (f(B, H, R).to(BF16), f(B, H, Dr).to(BF16),
            dtypes.cast(f(B, S, R), cdt), dtypes.cast(f(B, S, Dr), cdt))


class _F32DotJOps(JOps):
    """The reference's ``JOps`` whose einsums take f32 copies of their bf16
    operands (exact): XLA's CPU backend has no BF16 × BF16 = F32 dot, and
    with f32 accumulation and the cast back (``JOps.einsum``) the product
    is the same function."""

    def einsum(self, subscripts, a, b):
        f32 = jnp.float32
        return jnp.einsum(subscripts, a.astype(f32), b.astype(f32),
                          preferred_element_type=f32).astype(
                              self.compute_dtype)


def _composed_reference(q_lat, q_rope, c, k_rope, lens, scale):
    """The reference's composed bf16 MLA decode attention (its
    ``mla_attention`` after the cache read), jitted on its ``JOps``
    (:class:`_F32DotJOps`)."""
    bk = _F32DotJOps(jnp.bfloat16)
    S = c.shape[1]
    jdt = {torch.float32: jnp.float32, BF16: jnp.bfloat16,
           FP8: jnp.float8_e4m3fn}[c.dtype]
    ql, qr = (jnp.asarray(_np(t)).astype(jnp.bfloat16)[:, None]
              for t in (q_lat, q_rope))
    cc, kr = (jnp.asarray(_np(t)).astype(jdt) for t in (c, k_rope))

    def composed(ql, qr, cc, kr):
        cc, kr = bk.input(cc), bk.input(kr)
        s_nope = bk.einsum("bqhr,bsr->bhqs", ql, cc)
        s_rope = bk.einsum("bqhd,bsd->bhqs", qr, kr)
        s = bk.scale(bk.add(s_nope, s_rope), scale)
        ok = jnp.arange(S)[None, :] < jnp.asarray(lens)[:, None]
        s = bk.where(ok[:, None, None, :], s, bk.const(-1e9))
        return bk.einsum("bhqs,bsr->bqhr", bk.softmax(s, axis=-1), cc)

    return np.asarray(jax.jit(composed)(ql, qr, cc, kr), np.float32)[:, 0]


@pytest.mark.parametrize("cdt", [torch.float32, BF16, FP8],
                         ids=["f32", "bf16", "e4m3"])
@pytest.mark.parametrize("shape", [(2, 4, 16, 8, 150, (150, 37)),
                                   (3, 5, 256, 32, 200, (200, 65, 1))],
                         ids=["smoke", "minicpm3_widths"])
def test_latent_plain_version_against_the_reference(cdt, shape):
    """The plain version against the reference's composed bf16 path on the
    same operands, ragged lengths over several chunks, with a bf16 cache,
    an e4m3 one and an f32 one (the engine's, read as bf16 by RNE). Rule:
    two bf16 ulps of max |c| (module docstring; worst in the message)."""
    B, H, R, Dr, S, lens = shape
    q_lat, q_rope, c, k_rope = _operands(11, B, H, R, Dr, S, cdt)
    scale = (R // 4 + Dr) ** -0.5
    lengths = torch.tensor(lens, dtype=torch.int32)
    got = tfd.latent_decode_bf16_ref(q_lat, q_rope, c, k_rope, lengths,
                                     scale)
    want = _composed_reference(q_lat, q_rope, c, k_rope, lens, scale)
    assert got.dtype == BF16 and got.shape == (B, H, R)
    cmax = float(np.abs(_np(c.to(BF16))).max())
    err = float(np.abs(_np(got) - want).max())
    assert err <= 2 * _ulp_bf16(cmax), (
        f"{err} against {2 * _ulp_bf16(cmax)} (max |c| {cmax})")


def test_latent_plain_version_rules():
    """The plain version's own contract. Rule: exact."""
    B, H, R, Dr, S = 2, 3, 16, 8, 200
    q_lat, q_rope, c, k_rope = _operands(12, B, H, R, Dr, S, BF16)
    lengths = torch.tensor([150, 0], dtype=torch.int32)
    base = tfd.latent_decode_bf16_ref(q_lat, q_rope, c, k_rope, lengths, 0.3)
    # never read past a lane's length
    c2, r2 = c.clone(), k_rope.clone()
    c2[0, 150:] = r2[0, 150:] = float("nan")
    again = tfd.latent_decode_bf16_ref(q_lat, q_rope, c2, r2, lengths, 0.3)
    assert torch.equal(base[0].float(), again[0].float())
    # length 0: every position at NEG_BIG, uniform weights bf16(1/S)
    p = tfd._rbf(torch.tensor(1.0 / S))
    mean = (p * c[1].float()).sum(0)
    assert float((base[1].float() - mean.to(BF16).float()).abs().max()) \
        <= float(_ulp_bf16(float(mean.abs().max())))
    # one chunk: the fold is the chunk's own partials
    short = torch.tensor([64, 40], dtype=torch.int32)
    one = tfd.latent_decode_bf16_ref(q_lat, q_rope, c[:, :64],
                                     k_rope[:, :64], short, 0.3)
    full = tfd.latent_decode_bf16_ref(q_lat, q_rope, c, k_rope, short, 0.3)
    assert torch.equal(one.float(), full.float())
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(tfd.latent_decode_bf16(
        q_lat, q_rope, c, k_rope, lengths, 0.3).float(), base.float())


def test_latent_wrapper_refuses_what_the_kernel_does_not_take():
    """The kernel's argument checks: dtypes, shapes, the widths it takes
    (R ≤ 256, Dr ≤ 128 and the shared memory of H heads), then the device
    (a CPU tensor never reaches the library)."""
    q_lat, q_rope, c, k_rope = _operands(13, 1, 2, 16, 8, 10, BF16)
    lengths = torch.tensor([10], dtype=torch.int32)
    check = tfd._check_latent_args
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        check(q_lat, q_rope, c, k_rope, lengths)
    with pytest.raises(ValueError, match="q_lat: needs"):
        check(q_lat.half(), q_rope, c, k_rope, lengths)
    with pytest.raises(ValueError, match="do not fit"):
        check(q_lat, q_rope, c, k_rope.float(), lengths)
    with pytest.raises(ValueError, match="do not fit"):
        check(q_lat, q_rope, c[:, :, :8].contiguous(), k_rope, lengths)
    for R, Dr, H in ((264, 8, 2), (16, 136, 2), (256, 32, 160)):
        wide = _operands(14, 1, H, R, Dr, 10, BF16)
        with pytest.raises(ValueError, match="the latent kernel takes"):
            check(*wide, lengths)
    # MiniCPM3's widths fit
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        check(*_operands(15, 1, 40, 256, 32, 10, BF16), lengths)


# ------------------------------------------ MiniCPM3 SMOKE, bf16 vs f32 ref

B, PROMPT, STEPS = 2, 70, 3
MAX_SEQ = PROMPT + STEPS + 1


def _latent_route_on_cpu(monkeypatch):
    """The backend's latent route taken on the CPU: the route predicate is
    told that the latent call's tensors lie on the card, so a bf16 step
    reaches ``latent_decode_bf16`` (its plain version on CPU tensors).
    Returns the list of its calls' (q_lat shape, cache dtype)."""
    calls = []
    real = tfd.latent_decode_bf16

    def spy(q_lat, q_rope, c, k_rope, lengths, scale):
        calls.append((tuple(q_lat.shape), c.dtype))
        return real(q_lat, q_rope, c, k_rope, lengths, scale)

    monkeypatch.setattr(tfd, "latent_decode_bf16", spy)
    route = tbackend.TorchOps.latent_decode_attention

    def routed(self, *args):
        on_card = tbackend._on_card
        tbackend._on_card = lambda t: True
        try:
            return route(self, *args)
        finally:
            tbackend._on_card = on_card

    monkeypatch.setattr(tbackend.TorchOps, "latent_decode_attention", routed)
    return calls


@pytest.mark.parametrize("path", ["plain", "k", "format"])
def test_minicpm3_smoke_bf16_decode_against_the_f32_reference(monkeypatch,
                                                              path):
    """MiniCPM3 SMOKE served by the port in bf16 (bf16 params and latent
    cache) through the latent route, on the plain, k = 12 and format
    backends, against the reference's ``build_serve_steps`` in f32 on the
    same params (the bf16 values, read in f32) and prompt, over two chunks
    of cached positions. Rule: each decode step's logits within
    LOGIT_ULPS bf16 ulps of max |logit| while the tokens agree; tokens
    equal, or the port's top-1 gap at the first differing step within
    that bound (module docstring)."""
    extra = {"plain": {}, "k": {"precision_k": 12},
             "format": {"precision_layer_format": {
                 "": {"k": 12, "emax": 15, "emin": -14}}}}[path]
    arch = "minicpm3_4b"
    jcfg, tcfg = jconfigs.get(arch).SMOKE, tconfigs.get(arch).SMOKE
    jp = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16).astype(jnp.float32),
        JT.init_params(jax.random.PRNGKey(0), jcfg))
    tp = _to_bf16(params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    "cpu"))
    jsc = jserve.ServeConfig(arch=arch, batch=B, max_seq=MAX_SEQ,
                             prefill_len=PROMPT, **extra)
    tsc = tserve.ServeConfig(arch=arch, batch=B, max_seq=MAX_SEQ,
                             prefill_len=PROMPT, compute_dtype="bfloat16",
                             cache_dtype="bfloat16", device="cpu", **extra)
    toks = np.random.RandomState(3).randint(0, jcfg.vocab, (B, PROMPT))
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)
    with mesh:
        prefill, _, _ = jserve.build_serve_steps(jcfg, jsc, mesh)
        jbk = jserve._backend(jsc, mesh=mesh)
        decode = jax.jit(lambda p, c, t, pos: JT.forward(
            jbk, p, jcfg, t, cache=c, q_offset=pos))
        jc = JT.init_cache(jcfg, B, MAX_SEQ, jnp.float32)
        jl, jc = prefill(jp, jc, {"tokens": jnp.asarray(toks)})
        jt = jnp.argmax(jl[:, -1], -1)
        jtoks, jlogits = [np.asarray(jt)], []
        for i in range(STEPS):
            lg, jc = decode(jp, jc, jt[:, None],
                            jnp.asarray(PROMPT + i, jnp.int32))
            jlogits.append(np.asarray(lg[:, -1], np.float32))
            jt = jnp.argmax(lg[:, -1], -1)
            jtoks.append(np.asarray(jt))
    calls = _latent_route_on_cpu(monkeypatch)
    bk = tserve._backend(tsc)
    tc = TT.init_cache(tcfg, B, MAX_SEQ, device="cpu", dtype=BF16)
    with torch.no_grad():
        tl, tc = tserve.prefill_step(bk, tp, tcfg, tc,
                                     torch.from_numpy(toks))
        tt = torch.argmax(tl[:, -1], -1)
        ttoks, tlogits = [tt.numpy()], []
        for i in range(STEPS):
            tt, last, tc = tserve.decode_step(bk, tp, tcfg, tc, tt[:, None],
                                              PROMPT + i)
            ttoks.append(tt.numpy())
            tlogits.append(_np(last))
    assert calls == [((B, tcfg.n_heads, tcfg.kv_rank), BF16)] * (
        STEPS * tcfg.n_layers)
    worst = 0.0
    for step, (jl, tl) in enumerate(zip(jlogits, tlogits)):
        unit = float(_ulp_bf16(np.abs(jl).max()))
        if not np.array_equal(jtoks[step], ttoks[step]):
            top2 = np.sort(tlogits[step - 1] if step else tl, -1)[:, -2:]
            gap = float((top2[:, 1] - top2[:, 0]).min())
            assert gap <= 2 * LOGIT_ULPS * unit, (
                f"tokens differ at step {step} with a top-1 gap {gap}")
            break
        worst = max(worst, float(np.abs(tl - jl).max()) / unit)
        assert worst <= LOGIT_ULPS, f"decode step {step}: {worst} bf16 ulps"


def _to_bf16(tree):
    if isinstance(tree, dict):
        return {k: _to_bf16(v) for k, v in tree.items()}
    return tree.to(BF16) if tree.is_floating_point() else tree
