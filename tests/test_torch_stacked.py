"""The port's layer-stacked CAA (``StackedCaaOps``, ``StackedRangeCaaOps``,
``discover_scopes_stacked``, ``onehot_scale_vector``,
``sensitivity_stacked``, ``analyze_ranges_stacked``, ``merge_range_maps``)
against the JAX package's scan-native analysis and against the port's own
eager unroll, on the reference's synthetic layer-stacked model
(``tests/test_stacked.py``: 3 layers of 4, weights from
``jax.random.PRNGKey(0)`` handed over through numpy).

PyTorch has no ``lax.scan``: the port's stacked ops run the stack as one
``layer*`` scope whose knobs and range evidence live in ``[L]`` lanes,
filled by a Python loop. What the reference checks of its jaxpr (flat in
depth) has no counterpart; what the stacked API reports — the wildcard in
``seen_scopes``, one ``layer*/…`` trace record a name, the ``[L]``
``layer_stats``, the lanes — is checked here.

Tolerances: δ̄ and every ``RangeStat`` field within 1e-9 relative
(sensitivities 1e-7, the reference's own tolerance); ``n_ops``, key sets,
``seen_scopes`` and sensitivity rankings equal.
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import math

import jax
import numpy as np
import pytest
import torch

from repro import certify as JCert
from repro.core import analyze as JA
from repro.core import caa as JC
from repro.core.backend import StackedCaaOps as JStackedCaaOps
from repro.core.backend import StackedRangeCaaOps as JStackedRange
from repro_torch.core import analyze as TA
from repro_torch.core import caa as TC
from repro_torch.core.backend import (CaaOps, RangeCaaOps, RangeStat,
                                      StackedCaaOps, StackedRangeCaaOps)
from repro_torch.core.scopes import STACK_SCOPE

_L, _D = 3, 4
RTOL = 1e-9


def _jforward(n_layers):
    def forward(bk, params, x):
        def layer(p, h, i, a):
            return bk.relu(bk.matmul(h, bk.param(p))), None

        h, _ = bk.layer_loop(layer, params, x, n_layers)
        with bk.scope("head"):
            return bk.matmul(h, bk.param(np.eye(_D)))

    return forward


def _tforward(n_layers):
    def forward(bk, params, x):
        def layer(p, h, i, a):
            return bk.relu(bk.matmul(h, bk.param(p)))

        h = bk.layer_loop(layer, params, x, n_layers)
        with bk.scope("head"):
            h = bk.matmul(h, bk.param(torch.eye(_D, dtype=torch.float64)))
            return bk.record("out", h, kind="head")

    return forward


@pytest.fixture(scope="module")
def synth():
    W = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                     (_L, _D, _D))) * 0.5
    lo, hi = np.full((2, _D), -0.5), np.full((2, _D), 0.5)
    return dict(W=W, tW=torch.from_numpy(W.astype(np.float64)),
                jx=JC.from_range(lo, hi),
                tx=TC.from_range(torch.from_numpy(lo), torch.from_numpy(hi)),
                jcfg=JC.CaaConfig(u_max=2.0 ** -10),
                tcfg=TC.CaaConfig(u_max=2.0 ** -10))


def _full(c):
    return np.broadcast_to(np.asarray(c.dbar), c.shape)


def _same_ranges(got, want, keys=None):
    keys = sorted(want) if keys is None else keys
    for k in keys:
        g, w = got[k], want[k]
        assert (g.n_ops, g.crosses_zero) == (w.n_ops, w.crosses_zero), k
        for f in ("max_abs", "min_nonzero"):
            a, b = getattr(g, f), getattr(w, f)
            if math.isinf(b):
                assert a == b, (k, f)
            else:
                np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=k)


def test_stacked_uniform_matches_eager_unroll_and_reference(synth):
    s = synth
    eager = _tforward(_L)(CaaOps(s["tcfg"]), s["tW"], s["tx"])
    stacked = _tforward(_L)(StackedCaaOps(s["tcfg"]), s["tW"], s["tx"])
    np.testing.assert_allclose(_full(stacked), _full(eager), rtol=RTOL)
    ref = _jforward(_L)(JStackedCaaOps(s["jcfg"]), s["W"], s["jx"])
    np.testing.assert_allclose(_full(stacked), _full(ref), rtol=RTOL)


def test_stacked_scales_match_eager_mixed_and_wildcard_vector(synth):
    s = synth
    sm = {"layer0": 1.0, "layer1": 0.25, "layer2": 0.5, "head": 0.125}
    by_name = _tforward(_L)(StackedCaaOps(s["tcfg"], sm), s["tW"], s["tx"])
    # the reference's eager per-scope-scaled analysis of the same map
    eager = _jforward(_L)(JCert.MixedCaaOps(s["jcfg"], sm, default_scale=1.0),
                          s["W"], s["jx"])
    np.testing.assert_allclose(_full(by_name), _full(eager), rtol=RTOL)
    # the [L]-vector wildcard form is the same map
    by_vec = _tforward(_L)(StackedCaaOps(
        s["tcfg"], {"layer*": torch.tensor([1.0, 0.25, 0.5]),
                    "head": 0.125}), s["tW"], s["tx"])
    np.testing.assert_allclose(_full(by_vec), _full(by_name), rtol=1e-12)


def test_stacked_layer_stats_seen_scopes_and_one_record(synth):
    s = synth
    ops = StackedCaaOps(s["tcfg"])

    def fwd(bk, params, x):
        def layer(p, h, i, a):
            with bk.scope("blk"):
                h = bk.record("act", bk.relu(bk.matmul(h, bk.param(p))))
            return h
        return bk.layer_loop(layer, params, x, _L)

    fwd(ops, s["tW"], s["tx"])
    assert ops.layer_stats["abs_u"].shape == (_L,)
    # bounds only grow along the stack (monotone accumulation)
    assert (np.diff(ops.layer_stats["abs_u"].numpy()) >= 0).all()
    assert ops.seen_scopes == [STACK_SCOPE, STACK_SCOPE + "/blk"]
    # per-layer records collapse into one layer*/... record, as the
    # reference's scan traces its body once
    assert [r.name for r in ops.trace] == [STACK_SCOPE + "/blk/act"]
    assert math.isnan(ops.trace[0].max_dbar)
    eager = CaaOps(s["tcfg"])
    fwd(eager, s["tW"], s["tx"])
    assert [r.name for r in eager.trace] == [f"layer{i}/blk/act"
                                             for i in range(_L)]
    for i, r in enumerate(eager.trace):
        np.testing.assert_allclose(float(ops.layer_stats["abs_u"][i]),
                                   r.max_dbar, rtol=RTOL)


def test_stacked_range_lanes_match_eager_and_reference(synth):
    s = synth
    keys = [f"layer{i}" for i in range(_L)] + ["head"]
    eager_ops = RangeCaaOps(s["tcfg"])
    _tforward(_L)(eager_ops, s["tW"], s["tx"])
    eager = TA.aggregate_ranges(eager_ops.scope_ranges, keys)
    stacked_ops = StackedRangeCaaOps(s["tcfg"])
    _tforward(_L)(stacked_ops, s["tW"], s["tx"])
    stacked = TA.aggregate_ranges(stacked_ops.collect_ranges(), keys)
    assert set(stacked) == set(eager)
    _same_ranges(stacked, eager)
    ref_ops = JStackedRange(s["jcfg"])
    _jforward(_L)(ref_ops, s["W"], s["jx"])
    ref = JA.aggregate_ranges(ref_ops.collect_ranges(), keys)
    _same_ranges(stacked, ref)


def test_stacked_range_sublanes_match_eager_paths(synth):
    """Sub-layer lanes land at layer{i}/{sub}; a sub-lane never entered is
    not reported."""
    s = synth

    def fwd(bk, params, x):
        def layer(p, h, i, a):
            with bk.scope("attn"):
                h = bk.matmul(h, bk.param(p))
            return bk.relu(h)
        return bk.layer_loop(layer, params, x, _L)

    stk = StackedRangeCaaOps(s["tcfg"], sublanes=("attn", "mlp"))
    fwd(stk, s["tW"], s["tx"])
    got = stk.collect_ranges()
    assert set(got) == {""} | {f"layer{i}" for i in range(_L)} | {
        f"layer{i}/attn" for i in range(_L)}
    eager = RangeCaaOps(s["tcfg"])
    fwd(eager, s["tW"], s["tx"])
    _same_ranges(got, eager.scope_ranges, keys=sorted(eager.scope_ranges))


def test_sensitivity_stacked_matches_eager_gated_and_reference(synth):
    s = synth
    keys = [f"layer{i}" for i in range(_L)] + ["head"]
    stacked = TA.sensitivity_stacked(_tforward(_L), s["tW"], s["tx"], keys,
                                     s["tcfg"])
    eager = TA.sensitivity(_tforward(_L), s["tW"], s["tx"], keys, s["tcfg"])
    ref = JA.sensitivity_stacked(_jforward(_L), s["W"], s["jx"], keys,
                                 s["jcfg"])
    for k in keys:
        np.testing.assert_allclose(stacked[k], eager[k], rtol=1e-7)
        np.testing.assert_allclose(stacked[k], ref[k], rtol=1e-7)
    rank = lambda d: sorted(d, key=lambda k: (-d[k], k))
    assert rank(stacked) == rank(ref)


def test_onehot_scale_vector_matches_reference():
    keys = ["embed", "layer0", "layer1", "head"]
    for k in keys:
        np.testing.assert_array_equal(TA.onehot_scale_vector(keys, k),
                                      JA.onehot_scale_vector(keys, k))


def test_analyze_ranges_stacked_api(synth):
    s = synth
    out = TA.analyze_ranges_stacked(_tforward(_L), s["tW"], s["tx"],
                                    s["tcfg"])
    assert "" in out and "layer0" in out and "head" in out
    assert out["layer0"].n_ops > 0
    ref = JA.analyze_ranges_stacked(_jforward(_L), s["W"], s["jx"],
                                    s["jcfg"])
    assert set(out) == set(ref)
    _same_ranges(out, ref)


def test_merge_range_maps_profile_aggregation():
    a = {"layer0": RangeStat(1.0, 0.5, False, 3),
         "": RangeStat(2.0, 1.0, False, 1)}
    b = {"layer0": RangeStat(4.0, 0.25, True, 2),
         "head": RangeStat(8.0, 1.0, False, 1)}
    got = TA.merge_range_maps([a, b], ["layer0", "head"])
    assert got["layer0"].max_abs == 4.0
    assert got["layer0"].min_nonzero == 0.25
    assert got["layer0"].crosses_zero and got["layer0"].n_ops == 5
    assert got["head"].max_abs == 8.0
    assert got[""].max_abs == 2.0
    from repro.core.backend import RangeStat as JRangeStat

    conv = lambda m: {k: JRangeStat(*v.to_dict().values())
                      for k, v in m.items()}
    want = JA.merge_range_maps([conv(a), conv(b)], ["layer0", "head"])
    assert {k: v.to_dict() for k, v in got.items()} == \
        {k: v.to_dict() for k, v in want.items()}


def test_discover_scopes_stacked(synth):
    s = synth
    got = TA.discover_scopes_stacked(_tforward(_L), s["tW"], s["tx"], _L,
                                     s["tcfg"])
    assert got == ["layer0", "layer1", "layer2", "head"]
    assert got == JA.discover_scopes_stacked(_jforward(_L), s["W"], s["jx"],
                                             _L, s["jcfg"])
