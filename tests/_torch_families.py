"""The helpers shared by the tests of the last three model families
(``tests/test_torch_mla.py``: MiniCPM3; ``tests/test_torch_encdec.py``:
Whisper and PaliGemma): both packages' SMOKE configs on the reference's
own parameters, a serving loop run through a JAX backend and a port
backend side by side with the modality stub's inputs, and the checks
with the tolerances of ``tests/_torch_serve_parity.py`` as
``tests/test_torch_zoo.py``'s docstring states them."""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import certify as jcertify
from repro import configs as jconfigs
from repro.core import caa as jcaa
from repro.core.backend import CaaOps as JCaaOps
from repro.core.backend import JOps
from repro.launch import serve as jserve
from repro.launch.batching import make_backend
from repro.models import transformer as JT
from repro_torch import certify as tcertify
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import caa as tcaa
from repro_torch.core.backend import CaaOps as TCaaOps
from repro_torch.core.backend import TorchOps
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from _torch_serve_parity import top1_gap

B, PROMPT, STEPS = 2, 12, 12
FMT_MAP = {"": {"k": 11, "emax": 15, "emin": -14},
           "layer*/attn": {"k": 8, "emax": 15, "emin": -14},
           "layer0/mlp": {"k": 9, "emax": 7, "emin": -6}}
K_ATTN_FMT = 8
PATHS = ("plain", "k12", "format")
CAA_K, CAA_BATCH = 12, 2                  # certify_lm's profile below too
CERT = dict(batch=CAA_BATCH, seed=0, k_max=24)


def caa_seq(cfg) -> int:
    """The analysis profile's tokens: 6, or as many as Whisper's frames
    (the encoder's and the decoder's ops then share their shapes, which
    halves the reference's eager compilation)."""
    return cfg.frontend_seq if cfg.enc_dec else 6
MLA_OUT_MAG_REL = 1e-5    # MLA's out_mag and final bound: tests/test_torch_mla.py
MLA_BOUND_REL = 1e-4

_PARAMS = {}


def both(arch):
    """(JAX config, JAX params, port config, port params) at SMOKE: the
    reference's ``init_params`` (key 0), carried across through numpy."""
    if arch not in _PARAMS:
        jcfg = jconfigs.get(arch).SMOKE
        tcfg = tconfigs.get(arch).SMOKE
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        _PARAMS[arch] = (jcfg, jp, tcfg, tp)
    return _PARAMS[arch]


def stub_inputs(cfg, batch, rng):
    """The modality stub's inputs [batch, frontend_seq, frontend_dim] f32
    drawn from ``rng``, or None."""
    if not cfg.frontend:
        return None
    return rng.randn(batch, cfg.frontend_seq,
                     cfg.frontend_dim).astype(np.float32)


def serve_both(arch, jbk, tbk):
    """Prefill + STEPS greedy decode steps through both packages, each on
    its own tokens, with the stub's inputs: PaliGemma's patches prepended
    at prefill (decode positions after them), Whisper's frames encoded once
    (``T.encode`` in the reference, ``serve.encode_step`` in the port) and
    the encoder states passed to every step. Returns (per-step (j_logits,
    t_logits, j_cache, t_cache), max_seq)."""
    jcfg, jp, tcfg, tp = both(arch)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, jcfg.vocab, (B, PROMPT))
    fr = stub_inputs(jcfg, B, rng)
    prefix = tserve.prefix_len(tcfg)
    max_seq = PROMPT + STEPS + 1 + prefix
    jkw, jdec, tenc = {}, {}, None
    if jcfg.frontend == "vision":
        jkw = {"frontend_embeds": jnp.asarray(fr)}
    if jcfg.enc_dec:
        jenc = jax.jit(lambda p, f: jbk.value_of(JT.encode(jbk, p, jcfg, f)))
        jkw = jdec = {"enc_out": jenc(jp, jnp.asarray(fr))}
        tenc = tserve.encode_step(tbk, tp, tcfg, torch.from_numpy(fr))
    jstep = jax.jit(lambda p, c, t, pos, kw: JT.forward(
        jbk, p, jcfg, t, cache=c, q_offset=pos, **kw))
    jc = JT.init_cache(jcfg, B, max_seq, jnp.float32)
    tc = TT.init_cache(tcfg, B, max_seq, device="cpu")
    jl, jc = jstep(jp, jc, jnp.asarray(toks), jnp.int32(0), jkw)
    tfr = None if fr is None else torch.from_numpy(fr)
    with torch.no_grad():
        tl, tc = tserve.prefill_step(tbk, tp, tcfg, tc,
                                     torch.from_numpy(toks), tfr, tenc)
    snap = lambda c: {k: v.clone() for k, v in c.items()}
    out = [(np.asarray(jl[:, -1]), tl[:, -1].numpy(), jc, snap(tc))]
    jt = jnp.argmax(jl[:, -1], -1)
    tt = torch.argmax(tl[:, -1], -1)
    for i in range(STEPS):
        pos = prefix + PROMPT + i
        jl, jc = jstep(jp, jc, jt[:, None], jnp.int32(pos), jdec)
        with torch.no_grad():
            tt, tlast, tc = tserve.decode_step(tbk, tp, tcfg, tc,
                                               tt[:, None], pos, tenc)
        jt = jnp.argmax(jl[:, -1], -1)
        out.append((np.asarray(jl[:, -1]), tlast.numpy(), jc, snap(tc)))
    return out, max_seq


def k_cache_tol(k):
    """One ulp at k of itself plus one ulp of the largest value."""
    def tol(got, want):
        u = 2.0 ** (1 - k)
        np.testing.assert_allclose(got, want, rtol=u,
                                   atol=u * float(np.abs(want).max()))
    return tol


def check_steps(arch, steps, max_seq, logit_atol, cache_tol):
    """Tokens equal (a mismatch reports the top-1 gap), logits within
    ``logit_atol(j_logits)``, the index equal and every cache tensor of the
    reference's shape within ``cache_tol`` (MLA: k the latent [L, B, S,
    kv_rank], v the rope key [L, B, S, d_rope])."""
    cfg = both(arch)[0]
    L = cfg.n_layers
    shapes = ({"k": (L, B, max_seq, cfg.kv_rank),
               "v": (L, B, max_seq, cfg.d_rope)} if cfg.mla else
              {n: (L, B, max_seq, cfg.n_kv_heads, cfg.head_dim)
               for n in ("k", "v")})
    for i, (jl, tl, jc, tc) in enumerate(steps):
        jtok, ttok = jl.argmax(-1), tl.argmax(-1)
        assert np.array_equal(jtok, ttok), (
            f"{arch} step {i}: tokens {jtok} vs {ttok}; top-1 gap "
            f"{top1_gap(jl)}")
        np.testing.assert_allclose(tl, jl, rtol=0, atol=logit_atol(jl))
        assert np.array_equal(np.asarray(jc["idx"]), tc["idx"].numpy())
        for name, shape in shapes.items():
            want = np.asarray(jc[name])
            got = tc[name].numpy()
            assert got.shape == want.shape == shape
            cache_tol(got, want)


def serving_steps_match(arch, path):
    """The serving loop on ``path`` ("plain", "k12", "format") against the
    reference, with the tolerances of ``tests/test_torch_zoo.py``: plain,
    logits within 2e-6 and the cache within 1e-5; k = 12, logits within
    1e-3 and the cache within one ulp at k of itself plus one of its
    largest value; the format map (attention at k = 8), the MoE models'
    rule in ``tests/test_torch_zoo.py`` (and Hymba's in
    ``tests/test_torch_ssm_zoo.py``): logits within one ulp at k = 8 of
    the largest logit, 2^(1-k)·max|logits| (at least 1e-3), and the cache
    as on the k path at k = 8. A product that crosses a rounding boundary
    at k = 8 moves by one ulp there: the rope mixes it into its partner
    (a small rope-key entry moved 0.0043, 5.5 % of itself, on MiniCPM3),
    and MLA's latent enters every head's scores and values (its logits
    moved 1.15e-3)."""
    if path == "plain":
        def cache_tol(got, want):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

        steps, S = serve_both(arch, JOps(jnp.float32, jnp.float32),
                              TorchOps())
        check_steps(arch, steps, S, lambda jl: 2e-6, cache_tol)
        return
    kw = (dict(precision_k=12) if path == "k12"
          else dict(precision_layer_format=FMT_MAP))
    jbk = make_backend(jserve.ServeConfig(arch=arch, batch=B, **kw),
                       unrolled=True)
    tbk = tserve._backend(tserve.ServeConfig(arch=arch, **kw))
    steps, S = serve_both(arch, jbk, tbk)
    if path == "k12":
        check_steps(arch, steps, S, lambda jl: 1e-3, k_cache_tol(12))
    else:
        u = 2.0 ** (1 - K_ATTN_FMT)
        check_steps(arch, steps, S,
                    lambda jl: max(1e-3, u * float(np.abs(jl).max())),
                    k_cache_tol(K_ATTN_FMT))


def decode_matches_full_forward(arch, ops=None):
    """Every cached decode step's logits against the last position of a
    full forward (no cache) of the same tokens and stub inputs within 2e-6,
    and the last against the reference's full forward within 2e-6."""
    jcfg, jp, tcfg, tp = both(arch)
    bk = ops or TorchOps()
    rng = np.random.RandomState(2)
    toks = rng.randint(0, tcfg.vocab, (B, PROMPT))
    fr = stub_inputs(tcfg, B, rng)
    tfr = None if fr is None else torch.from_numpy(fr)
    prefix = tserve.prefix_len(tcfg)
    full_kw = {}
    if tcfg.frontend:
        full_kw = {("enc_embeds" if tcfg.enc_dec else "frontend_embeds"): tfr}
    cache = TT.init_cache(tcfg, B, prefix + PROMPT + STEPS + 1, device="cpu")
    with torch.no_grad():
        enc = tserve.encode_step(bk, tp, tcfg, tfr)
        lg, cache = tserve.prefill_step(bk, tp, tcfg, cache,
                                        torch.from_numpy(toks), tfr, enc)
        tok = torch.argmax(lg[:, -1], -1)
        seq = np.concatenate([toks, tok.numpy()[:, None]], 1)
        for i in range(STEPS):
            tok, last, cache = tserve.decode_step(bk, tp, tcfg, cache,
                                                  tok[:, None],
                                                  prefix + PROMPT + i, enc)
            full, _ = TT.forward(TorchOps(), tp, tcfg,
                                 torch.from_numpy(seq), **full_kw)
            torch.testing.assert_close(last, full[:, -1], rtol=0, atol=2e-6)
            seq = np.concatenate([seq, tok.numpy()[:, None]], 1)
    jkw = {k: jnp.asarray(v.numpy()) for k, v in full_kw.items()}
    jfull, _ = JT.forward(JOps(jnp.float32, jnp.float32), jp, jcfg,
                          jnp.asarray(seq[:, :-1]), **jkw)
    np.testing.assert_allclose(last.numpy(), np.asarray(jfull[:, -1]),
                               rtol=0, atol=2e-6)


def params_match_reference(arch):
    """Parameter shapes at SMOKE (the reference's tree, its leaves crossing
    ``params_from_numpy`` bit for bit, the port's own ``init_params``) and
    the configs and ``analytic_params`` at SMOKE and FULL equal the
    reference's; the port's init draws norms as ones and biases as
    zeros."""
    jcfg, jp, tcfg, tp = both(arch)
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert TT.param_shapes(tcfg) == jshapes
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tp))
    for path, leaf in flat_j:
        assert np.array_equal(np.asarray(leaf), flat_t[path].numpy()), path
    own = TT.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), own) == jshapes
    for path, leaf in jax.tree_util.tree_leaves_with_path(own):
        name = path[-1].key
        if name in ("ln1_b", "ln2_b"):
            assert not bool(leaf.any()), path
        elif "norm" in name or name in ("ln1", "ln2"):
            assert bool((leaf == 1).all()), path
    for size in ("SMOKE", "FULL"):
        jc = getattr(jconfigs.get(arch), size)
        tc = getattr(tconfigs.get(arch), size)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert TT.analytic_params(tc) == JT.analytic_params(jc)
        assert TT.analytic_params(tc, True) == JT.analytic_params(jc, True)
    fshapes = jax.eval_shape(lambda: JT.init_params(
        jax.random.PRNGKey(0), jconfigs.get(arch).FULL))
    assert TT.param_shapes(tconfigs.get(arch).FULL) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), fshapes)


def caa_both(arch):
    """The reference's and the port's ``CaaOps`` forward at emulated k = 12
    on the certification profile's tokens and the stub's inputs
    ``certify_lm`` draws: (JAX backend, JAX logits, port backend, port
    logits)."""
    from repro.certify.lm import _frontend_kwargs as jfront
    from repro_torch.certify.lm import frontend_kwargs as tfront

    jcfg, jp, tcfg, tp = both(arch)
    toks = np.random.RandomState(1).randint(0, jcfg.vocab,
                                            (CAA_BATCH, caa_seq(jcfg)))
    ccfg = dict(u_max=2.0 ** (1 - CAA_K), emulate_k=CAA_K)
    jbk = JCaaOps(jcaa.CaaConfig(**ccfg))
    jl, _ = JT.forward(jbk, jp, jcfg, jnp.asarray(toks),
                       **jfront(jcfg, CAA_BATCH, 0))
    tbk = TCaaOps(tcaa.CaaConfig(**ccfg))
    tl, _ = TT.forward(tbk, tp, tcfg, torch.from_numpy(toks),
                       **tfront(tcfg, CAA_BATCH, 0, "cpu"))
    return jbk, jl, tbk, tl


def certify_both(arch, tmp_path, mixed, k_max=24):
    """``certify_lm`` through both packages on the reference's SMOKE
    params, each into its own store: uniform (whose probe forward passes
    no stub input in either package) or the stacked pipeline (``mixed``,
    which passes the stub's inputs)."""
    jcfg, jp, tcfg, tp = both(arch)
    kw = dict(CERT, seq=caa_seq(jcfg), mixed=mixed, k_max=k_max)
    js = jcertify.certify_lm(arch, jcfg, jp, **kw,
                             store=jcertify.CertificateStore(
                                 str(tmp_path / "j")))
    ts = tcertify.certify_lm(arch, tcfg, tp, **kw, device="cpu",
                             store=tcertify.CertificateStore(
                                 str(tmp_path / "t")))
    return js, ts


def serve_cli(arch):
    """``serve.main`` at SMOKE on the CPU, k = 12: tokens in the vocab,
    logits finite; a vision model's patches are in its result."""
    res = tserve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                       "--prefill-len", "6", "--decode-steps", "3",
                       "--precision-k", "12"])
    cfg = tconfigs.get(arch).SMOKE
    assert res.cfg == cfg and res.tokens.shape == (2, 4)
    assert bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all())
    for lg in [res.prefill_logits] + res.decode_logits:
        assert bool(torch.isfinite(lg).all())
    assert res.config.max_seq == 6 + 3 + 1 + tserve.prefix_len(cfg)
    if cfg.frontend:
        assert tuple(res.frontend.shape) == (2, cfg.frontend_seq,
                                             cfg.frontend_dim)
    return res


def stacked_equals_eager(arch):
    """The layer-stacked analyses (``StackedCaaOps``, the stacked IA range
    pass with attn / mlp lanes, the stacked affine pass) equal the eager
    unroll on the port, value for value and scope for scope, with the
    stub's inputs (the port's own invariant, as ``chip_smoke.py``'s
    ``ranges`` phase holds it). Whisper's encoder is a second stack under
    the same ``layer{i}`` keys, merged by name on both sides."""
    from repro_torch.certify.lm import frontend_kwargs
    from repro_torch.certify.tokens import profile_tokens
    from repro_torch.core import analyze as TA
    from repro_torch.core import formats as TF
    from repro_torch.core.backend import StackedCaaOps

    _, _, tcfg, tp = both(arch)
    toks = profile_tokens(1, 1, 6, tcfg.vocab)
    kw = frontend_kwargs(tcfg, 1, 0, "cpu")

    def forward(bk, params, x):
        logits, _ = TT.forward(bk, params, tcfg, toks, **kw)
        return tcaa.slice_(logits, (slice(None), slice(-1, None)))

    x = tcaa.make(torch.zeros((1, 1), dtype=torch.float64))
    cfg = tcaa.CaaConfig(u_max=2.0 ** -20)
    eager = forward(TCaaOps(cfg), tp, x)
    stacked = forward(StackedCaaOps(cfg), tp, x)
    for name in ("val", "dbar", "ebar"):
        assert torch.equal(getattr(eager, name), getattr(stacked, name))
    keys = [f"layer{i}" for i in range(tcfg.n_layers)] + ["embed", "head"]
    sub = ("attn", "mlp")
    fmts = {"layer*": TF.custom(12)}
    for a, b in (
            (TA.analyze_ranges(forward, tp, x, cfg, keys=keys),
             TA.analyze_ranges_stacked(forward, tp, x, cfg, keys=keys,
                                       sublanes=sub)),
            (TA.analyze_ranges_affine(forward, tp, x, fmts, TF.custom(14),
                                      keys=keys, stacked=False),
             TA.analyze_ranges_affine(forward, tp, x, fmts, TF.custom(14),
                                      keys=keys, stacked=True,
                                      sublanes=sub))):
        assert set(a) == set(b)
        for key in a:
            assert a[key].to_dict() == b[key].to_dict(), key
