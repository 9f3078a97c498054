"""The port's affine range pass (``repro_torch.core.interval``'s ``aff_*``
half, ``AffineRangeCaaOps``, ``StackedAffineRangeCaaOps``,
``analyze_ranges_affine``, ``tighten_range_maps``) against the JAX
package's, on the CPU, on the same numpy-seeded inputs; the reference's own
cases of ``tests/test_affine.py`` run on the port beside them.

Tolerances: affine forms' centres, terms and remainders within 4 f64 ulps
of the reference's (the same f64 expressions; sums over the slot axis may
run in another order), ids equal; every ``RangeStat`` field within 1e-9
relative, ``crosses_zero``, ``n_ops`` and the key set equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analyze as JA
from repro.core import caa as JC
from repro.core import formats as JF
from repro.core import interval as jiv
from repro.core.backend import AffineRangeCaaOps as JAffine
from repro.core.backend import StackedAffineRangeCaaOps as JStackedAffine
from repro_torch.core import analyze as TA
from repro_torch.core import caa as TC
from repro_torch.core import formats as TF
from repro_torch.core import interval as tiv
from repro_torch.core.backend import (AffineRangeCaaOps, RangeStat,
                                      StackedAffineRangeCaaOps, TorchOps)

FINE, COARSE = 50, 5        # custom(k): near-f64, and far coarser than IA
RTOL = 1e-9


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64).copy())


def _ulps_close(got, want, ulps=4):
    """Elementwise within ``ulps`` f64 ulps, or both below the smallest
    normal f64 in magnitude (the reference's CPU arithmetic flushes
    subnormal results to zero; PyTorch's keeps them); ``got`` may be stored
    broadcastable to ``want``'s shape (the port's compact point forms)."""
    want = np.asarray(want, np.float64)
    got = np.broadcast_to(np.asarray(got, np.float64), want.shape)
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    tol = np.maximum(ulps * np.spacing(np.maximum(np.abs(got),
                                                  np.abs(want))),
                     np.finfo(np.float64).tiny)
    with np.errstate(invalid="ignore"):       # inf - inf where equal
        ok = same | (np.abs(got - want) <= tol)
    assert ok.all(), (got[~ok][:5], want[~ok][:5])


def _same_form(tf, jf):
    shape = tuple(np.shape(jf.center))
    assert tf.shape == shape and tf.budget == jf.budget
    _ulps_close(tf.center, jf.center)
    _ulps_close(torch.broadcast_to(tf.terms, (tf.budget,) + shape),
                jf.terms)
    _ulps_close(torch.broadcast_to(tf.rad, shape), jf.rad)
    np.testing.assert_array_equal(tf.ids.numpy(), np.asarray(jf.ids))


def _forms(rng, shape, B=3, first_id=1):
    """The same form in both packages: a random centre and B symbols with
    ids first_id.. (one coefficient row zero, one duplicated)."""
    c = rng.randn(*shape)
    coeffs = np.abs(rng.randn(B, *shape)) * 0.1
    coeffs[1] = 0.0
    coeffs[2] = coeffs[0]
    tf, jf = tiv.aff_make(_t(c), 8), jiv.aff_make(jnp.asarray(c), 8)
    for b in range(B):
        tf = tiv.aff_append_symbol(tf, _t(coeffs[b]), first_id + b, 8)
        jf = jiv.aff_append_symbol(jf, jnp.asarray(coeffs[b]), first_id + b,
                                   8)
    return tf, jf


def test_aff_make_and_interval_match_reference():
    rng = np.random.RandomState(0)
    c = rng.randn(4, 5)
    tf, jf = tiv.aff_make(_t(c), 8), jiv.aff_make(jnp.asarray(c), 8)
    _same_form(tf, jf)
    # a point form keeps its zero terms broadcastable (no [B, *S] copy)
    assert tf.terms.shape == (8, 1, 1) and tf.rad.dim() == 0
    _ulps_close(tiv.aff_tot(tf), jiv.aff_tot(jf))
    ti, ji = tiv.aff_interval(tf), jiv.aff_interval(jf)
    _ulps_close(ti.lo, ji.lo)
    _ulps_close(ti.hi, ji.hi)
    lo = rng.randn(4, 5)
    hi = lo + rng.rand(4, 5)
    hi[0, 0] = np.inf
    for center in (None, lo + 0.3):
        tf = tiv.aff_from_interval(
            tiv.Interval(_t(lo), _t(hi)), 8,
            None if center is None else _t(center))
        jf = jiv.aff_from_interval(
            jiv.Interval(jnp.asarray(lo), jnp.asarray(hi)), 8,
            None if center is None else jnp.asarray(center))
        _same_form(tf, jf)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "where", "scale",
                                "shift", "neg", "intersect"])
def test_aff_ops_match_reference(op):
    rng = np.random.RandomState(1)
    ta, ja = _forms(rng, (3, 4), first_id=1)
    tb, jb = _forms(rng, (3, 4), first_id=3)   # ids 3 shared: cancels
    if op in ("add", "sub", "mul"):
        got = getattr(tiv, f"aff_{op}")(ta, tb, 4)
        want = getattr(jiv, f"aff_{op}")(ja, jb, 4)
    elif op == "where":
        m = rng.rand(3, 4) > 0.5
        got = tiv.aff_where(torch.from_numpy(m), ta, tb, 4)
        want = jiv.aff_where(jnp.asarray(m), ja, jb, 4)
    elif op in ("scale", "shift"):
        c = rng.randn(4)
        got = getattr(tiv, f"aff_{op}")(ta, _t(c))
        want = getattr(jiv, f"aff_{op}")(ja, jnp.asarray(c))
    elif op == "neg":
        got, want = tiv.aff_neg(ta), jiv.aff_neg(ja)
    else:
        lo, hi = np.full((3, 4), -0.5), rng.rand(3, 4)
        got = tiv.aff_intersect(ta, tiv.Interval(_t(lo), _t(hi)))
        want = jiv.aff_intersect(ja, jiv.Interval(jnp.asarray(lo),
                                                  jnp.asarray(hi)))
    _same_form(got, want)


@pytest.mark.parametrize("rank", [tiv.AFF_RANK_SENSITIVITY,
                                  tiv.AFF_RANK_MAGNITUDE])
def test_aff_condense_keeps_the_reference_slots_with_ties(rank):
    """Which symbols a condensation keeps decides the enclosure: the slots
    kept, their order and the folded remainder match the reference's,
    with tied ranks (equal coefficient rows) and an empty slot among
    them."""
    rng = np.random.RandomState(2)
    c = rng.randn(2, 3)
    row = np.abs(rng.randn(2, 3))
    coeffs = [row, row, 2 * row, row, np.zeros((2, 3)), row]
    tf, jf = tiv.aff_make(_t(c), 8), jiv.aff_make(jnp.asarray(c), 8)
    for b, k in enumerate(coeffs):
        tf = tiv.aff_append_symbol(tf, _t(k), 10 + b, 8, rank)
        jf = jiv.aff_append_symbol(jf, jnp.asarray(k), 10 + b, 8, rank)
    for budget in (4, 2, 1):
        got = tiv.aff_condense(tf, budget, rank)
        want = jiv.aff_condense(jf, budget, rank)
        _same_form(got, want)


def test_aff_condense_rejects_unknown_rank():
    f = tiv.aff_make(torch.zeros(2, dtype=torch.float64), 2)
    f = tiv.aff_append_symbol(f, torch.ones(2, dtype=torch.float64), 1, 4)
    with pytest.raises(ValueError):
        tiv.aff_condense(f, 0, "loudest")


def test_aff_sub_cancels_correlated_terms():
    x = tiv.aff_make(_t([2.0, -1.0]), budget=8)
    x = tiv.aff_append_symbol(x, _t([1.0, 2.0]), 1, budget=8)
    d = tiv.aff_interval(tiv.aff_sub(x, x, budget=8))
    # terms sharing a noise-symbol id cancel exactly; only the pass's own
    # f64 slop remains in the remainder
    assert ((d.hi - d.lo) <= 1e-12).all()
    # IA subtraction of the same enclosures doubles the width instead
    ivl = tiv.aff_interval(x)
    s = tiv.sub(ivl, ivl)
    assert ((s.hi - s.lo) >= 2.0).all()


def test_aff_mul_encloses_true_product():
    rng = np.random.RandomState(0)
    lo = rng.randn(8)
    hi = lo + rng.rand(8)
    a = tiv.aff_from_interval(tiv.Interval(_t(lo), _t(hi)))
    prod = tiv.aff_interval(tiv.aff_mul(a, tiv.aff_scale(a, 2.0), budget=8))
    for t in np.linspace(0.0, 1.0, 7):
        v = lo + t * (hi - lo)
        p = v * (2.0 * v)
        assert (prod.lo.numpy() <= p + 1e-12).all()
        assert (prod.hi.numpy() >= p - 1e-12).all()


# ---------------------------------------------------------------------------
# backend pass: soundness, finiteness, cancellation, parity
# ---------------------------------------------------------------------------

def _jfwd(bk, params, x):
    x = bk.input(x)
    with bk.scope("blk"):
        h2 = bk.tanh(bk.matmul(x, bk.param(params["w1"])))
    with bk.scope("head"):
        out = bk.matmul(h2, bk.param(params["w2"]))
        out = bk.add(out, bk.mul(h2, h2))
    return bk.softmax(out, axis=-1)


def _tfwd(bk, params, x):
    x = bk.input(x)
    with bk.scope("blk"):
        h2 = bk.tanh(bk.matmul(x, bk.param(params["w1"])))
    with bk.scope("head"):
        out = bk.matmul(h2, bk.param(params["w2"]))
        out = bk.add(out, bk.mul(h2, h2))
    return bk.softmax(out, dim=-1)


def _setup():
    rng = np.random.RandomState(1)
    params = {"w1": rng.randn(6, 4) * 0.5, "w2": rng.randn(4, 4) * 0.5}
    lo = rng.rand(3, 6) * 0.4
    return params, lo, lo + 0.05


def _same_ranges(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert (g.n_ops, g.crosses_zero) == (w.n_ops, w.crosses_zero), key
        for f in ("max_abs", "min_nonzero"):
            a, b = getattr(g, f), getattr(w, f)
            if np.isinf(b):
                assert a == b, (key, f)
            else:
                np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=key)


def test_affine_pass_encloses_exact_forward_and_stays_finite():
    params, lo, hi = _setup()
    tparams = {k: _t(v) for k, v in params.items()}
    exact = _tfwd(TorchOps(torch.float64), tparams,
                  _t((lo + hi) / 2.0)).numpy()
    for k in (FINE, COARSE):
        ops = AffineRangeCaaOps({}, TF.custom(k))
        out = _tfwd(ops, tparams, TC.from_range(_t(lo), _t(hi)))
        lo_e, hi_e = out.exact.lo.numpy(), out.exact.hi.numpy()
        assert np.isfinite(lo_e).all() and np.isfinite(hi_e).all()
        assert (lo_e <= exact + 1e-12).all()
        assert (hi_e >= exact - 1e-12).all()
        # every recorded scope enclosure is finite, even at k=5
        for s, st in ops.scope_ranges.items():
            assert np.isfinite(st.max_abs), (k, s, st)
        # and equals the reference's pass
        jops = JAffine({}, JF.custom(k))
        jout = _jfwd(jops, {kk: jnp.asarray(v) for kk, v in params.items()},
                     JC.from_range(lo, hi))
        _same_ranges(ops.scope_ranges, jops.scope_ranges)
        _ulps_close(out.val, jout.val, ulps=64)


def test_affine_pass_cancels_rounding_symbols_interval_channel_cannot():
    """The rounding charge of u = x + x is ONE shared noise symbol, so
    sub(u, u)'s form channel cancels it while the interval channel's
    widths add; the exact enclosure follows the tight form side."""
    raw = _t([1.5, 2.0, -3.0, 2.5, -1.0])
    ops = AffineRangeCaaOps({}, TF.custom(COARSE))
    x = ops.input(raw)
    u = ops.add(x, x)
    d = ops.sub(u, u)
    w_exact = d.exact.hi - d.exact.lo
    w_ivl = d.ivl.hi - d.ivl.lo
    assert (w_ivl > 0.1).all()
    assert (w_exact <= 0.01 * w_ivl).all()
    # ids are handed out in op order, as the reference hands them out
    jops = JAffine({}, JF.custom(COARSE))
    jx = jops.input(jnp.asarray(raw.numpy()))
    jd = jops.sub(jops.add(jx, jx), jops.add(jx, jx))
    ops = AffineRangeCaaOps({}, TF.custom(COARSE))
    x = ops.input(raw)
    dd = ops.sub(ops.add(x, x), ops.add(x, x))
    np.testing.assert_array_equal(dd.form.ids.numpy(), np.asarray(jd.form.ids))
    _same_form(dd.form, jd.form)


def _stack(rng, L=3, d=4):
    return rng.randn(L, d, d) * 0.4


def _stack_fwd(L, axis_kw):
    def fwd(bk, params, xin):
        def body(p, h, i, _a):
            with bk.scope("attn"):
                h = bk.tanh(bk.matmul(h, p))
            with bk.scope("mlp"):
                h = bk.add(h, bk.mul(h, h))
            return (h, None) if axis_kw == "axis" else h
        h = bk.input(xin)
        out = bk.layer_loop(body, params, h, L)
        return out[0] if axis_kw == "axis" else out
    return fwd


def test_stacked_affine_matches_eager_and_reference_per_scope():
    """The stacked [L, lanes] accumulation equals the eager unrolled pass
    on every key, sub-layer lanes included, and both equal the reference's
    stacked pass."""
    rng = np.random.RandomState(2)
    L = 3
    w = _stack(rng, L)
    lo = rng.rand(2, 4) * 0.3
    scope_fmts = {"layer*": TF.custom(9), "layer*/mlp": TF.custom(7)}
    eager = AffineRangeCaaOps(scope_fmts, TF.custom(FINE))
    _stack_fwd(L, "dim")(eager, _t(w), TC.from_range(_t(lo), _t(lo + 0.1)))
    stk = StackedAffineRangeCaaOps(scope_fmts, TF.custom(FINE),
                                   sublanes=("attn", "mlp"))
    _stack_fwd(L, "dim")(stk, _t(w), TC.from_range(_t(lo), _t(lo + 0.1)))
    got = stk.collect_ranges()
    want_keys = {f"layer{i}" for i in range(L)}
    want_keys |= {f"layer{i}/{s}" for i in range(L) for s in ("attn", "mlp")}
    assert want_keys <= set(got)
    assert stk.seen_scopes[0] == "layer*"
    for key in sorted(want_keys | {""}):
        e, g = eager.scope_ranges.get(key), got.get(key)
        if e is None and (g is None or g.n_ops == 0):
            continue
        _same_ranges({key: g}, {key: e})
    jfmts = {"layer*": JF.custom(9), "layer*/mlp": JF.custom(7)}
    jstk = JStackedAffine(jfmts, JF.custom(FINE), sublanes=("attn", "mlp"))
    _stack_fwd(L, "axis")(jstk, jnp.asarray(w),
                          JC.from_range(lo, lo + 0.1))
    _same_ranges(got, jstk.collect_ranges())


def test_analyze_ranges_affine_driver():
    params, lo, hi = _setup()
    tparams = {k: _t(v) for k, v in params.items()}
    got = TA.analyze_ranges_affine(
        _tfwd, tparams, TC.from_range(_t(lo), _t(hi)), {},
        TF.custom(COARSE), stacked=False)
    assert {"blk", "head", ""} <= set(got)
    assert all(np.isfinite(st.max_abs) for st in got.values()
               if st.n_ops > 0)
    want = JA.analyze_ranges_affine(
        _jfwd, {k: jnp.asarray(v) for k, v in params.items()},
        JC.from_range(lo, hi), {}, JF.custom(COARSE), stacked=False)
    _same_ranges(got, want)


# ---------------------------------------------------------------------------
# evidence combination
# ---------------------------------------------------------------------------

def test_tighten_range_maps_min_combines():
    from repro.core.backend import RangeStat as JRangeStat

    base = {"a": RangeStat(max_abs=np.inf, min_nonzero=1e-3,
                           crosses_zero=False, n_ops=4),
            "b": RangeStat(max_abs=2.0, min_nonzero=1e-2,
                           crosses_zero=True, n_ops=1),
            "c": RangeStat()}
    tight = {"a": RangeStat(max_abs=5.0, min_nonzero=1e-4,
                            crosses_zero=True, n_ops=4),
             "b": RangeStat(max_abs=8.0, min_nonzero=1e-1,
                            crosses_zero=False, n_ops=2),
             "c": RangeStat(max_abs=1.0, min_nonzero=1e-2,
                            crosses_zero=False, n_ops=9)}
    out = TA.tighten_range_maps(base, tight)
    # the affine evidence de-saturates the inf; underflow stays conservative
    assert out["a"].max_abs == 5.0
    assert out["a"].min_nonzero == 1e-4
    assert out["a"].crosses_zero
    assert out["a"].n_ops == 4
    assert out["b"].max_abs == 2.0 and out["b"].crosses_zero
    # an empty base entry passes through (nothing to tighten)
    assert out["c"].n_ops == 0
    # keys missing from tight pass through unchanged
    assert TA.tighten_range_maps(base, {})["a"].max_abs == np.inf
    conv = lambda m: {k: JRangeStat(**v.to_dict()) for k, v in m.items()}
    want = JA.tighten_range_maps(conv(base), conv(tight))
    assert {k: v.to_dict() for k, v in out.items()} == \
        {k: v.to_dict() for k, v in want.items()}


def test_concat_of_three_parts_of_other_shapes():
    """The reference's concat pads the first form's terms with zeros of the
    next part's shape, which fails from the third part of another length
    on (the ConvNet's patch extraction); the port's keeps each side's
    shape. Each part's slice of the result is that part, its interval
    channel and its enclosure exact movement."""
    rng = np.random.RandomState(4)
    ops = AffineRangeCaaOps({}, TF.custom(COARSE))
    parts = [ops.add(ops.input(_t(rng.randn(2, 3, n))),
                     ops.input(_t(rng.randn(2, 3, n)))) for n in (2, 1, 3)]
    out = ops.concat(parts, dim=-1)
    assert out.shape == (2, 3, 6)
    off = 0
    for p in parts:
        n = p.shape[-1]
        sl = out.exact.lo[..., off:off + n], out.exact.hi[..., off:off + n]
        assert torch.equal(sl[0], p.exact.lo) and torch.equal(sl[1],
                                                              p.exact.hi)
        assert torch.equal(out.val[..., off:off + n], p.val)
        off += n
    with pytest.raises(TypeError):
        jops = JAffine({}, JF.custom(COARSE))
        jparts = [jops.add(jops.input(jnp.asarray(rng.randn(2, 3, n))),
                           jops.input(jnp.asarray(rng.randn(2, 3, n))))
                  for n in (2, 1, 3)]
        jops.concat(jparts, axis=-1)
