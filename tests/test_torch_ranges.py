"""The port's range analysis (``RangeStat``, ``RangeCaaOps``,
``aggregate_ranges``, ``analyze_ranges``) against the JAX package's, and
the four range drivers on the transformer at ``qwen2_7b.SMOKE`` (2 layers,
the reference's params carried across by ``repro_torch.convert``, one
sequence of 8 seeded tokens, the reference's f32 rope tables), with the
analysis hooks of the port's
transformer (the rmsnorm's √n clamp, the attention's value-hull clamp, the
``attn_probs`` / ``logits`` records).

The reference's layer-stacked passes compile the whole transformer layer
as one XLA scan body, which takes minutes on the CPU at SMOKE (XLA's slow-
compile alarm), so the port's stacked passes over the transformer are held
to the reference's EAGER passes here, which the reference itself holds
equal to its stacked ones (``tests/test_stacked.py``,
``tests/test_affine.py``); ``tests/test_torch_stacked.py`` and
``tests/test_torch_affine.py`` hold the port's stacked classes to the
reference's stacked ones directly on small stacks.

Tolerances: every ``RangeStat`` field within 1e-9 relative; ``n_ops``,
``crosses_zero`` and the key set equal; the scope lists and the
sensitivity ranking equal. The δ̄ of the logits (the sensitivities, the
trace records) within 1e-6 relative: the f64 matmuls of the two packages
add in other orders, 1e-12 apart relative at the first projection, and
the CAA rules carry that through two layers and the head to 2e-7 there
(measured op by op); it stays far inside the ranges' 1e-9, which the
enclosures' magnitudes dominate.
"""
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JCfg
from repro.core import analyze as JA
from repro.core import caa as JC
from repro.core import formats as JF
from repro.core.backend import AffineRangeCaaOps as JAffine
from repro.core.backend import CaaOps as JCaaOps
from repro.core.backend import RangeCaaOps as JRangeCaaOps
from repro.core.backend import RangeStat as JRangeStat
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs as TCfg
from repro_torch.convert import params_from_numpy
from repro_torch.core import analyze as TA
from repro_torch.core import caa as TC
from repro_torch.core import formats as TF
from repro_torch.core.backend import CaaOps, RangeCaaOps, RangeStat
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-9
DBAR_RTOL = 1e-6          # δ̄ at the logits: see the module docstring
U_MAX = 2.0 ** -20
SUBLANES = ("attn", "mlp")
FMT_MAP = {"layer*": 12, "layer*/mlp": 10}      # custom(k) per scope
FMT_DEFAULT = 14


def _same(got, want, keys=None):
    keys = sorted(want) if keys is None else keys
    for k in keys:
        g, w = got[k], want[k]
        assert (g.n_ops, g.crosses_zero) == (w.n_ops, w.crosses_zero), \
            (k, g, w)
        for f in ("max_abs", "min_nonzero"):
            a, b = getattr(g, f), getattr(w, f)
            if math.isinf(b):
                assert a == b, (k, f, a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=k)


def test_range_stat_merge_and_dict_match_reference():
    a, b = RangeStat(2.0, 0.5, False, 3), RangeStat(1.0, 0.25, True, 2)
    ja, jb = JRangeStat(2.0, 0.5, False, 3), JRangeStat(1.0, 0.25, True, 2)
    assert a.merge(b).to_dict() == ja.merge(jb).to_dict()
    assert RangeStat().to_dict() == JRangeStat().to_dict()


def _jfwd(bk, params, x):
    x = bk.input(x)
    with bk.scope("blk"):
        h = bk.tanh(bk.matmul(x, bk.param(params["w1"])))
        h = bk.sub(h, bk.mean(h, axis=-1, keepdims=True))
    with bk.scope("head"):
        out = bk.mul(bk.matmul(h, bk.param(params["w2"])), h)
    return bk.softmax(out, axis=-1)


def _tfwd(bk, params, x):
    x = bk.input(x)
    with bk.scope("blk"):
        h = bk.tanh(bk.matmul(x, bk.param(params["w1"])))
        h = bk.sub(h, bk.mean(h, dim=-1, keepdim=True))
    with bk.scope("head"):
        out = bk.mul(bk.matmul(h, bk.param(params["w2"])), h)
    return bk.softmax(out, dim=-1)


@pytest.mark.parametrize("u_max", [2.0 ** -12, 2.0 ** -30])
def test_range_caa_ops_match_reference(u_max):
    rng = np.random.RandomState(3)
    w = {"w1": rng.randn(5, 4) * 0.6, "w2": rng.randn(4, 4) * 0.6}
    lo = rng.randn(2, 5) * 0.3
    hi = lo + 0.2
    ops = RangeCaaOps(TC.CaaConfig(u_max=u_max))
    out = _tfwd(ops, {k: torch.from_numpy(v) for k, v in w.items()},
                TC.from_range(torch.from_numpy(lo), torch.from_numpy(hi)))
    jops = JRangeCaaOps(JC.CaaConfig(u_max=u_max))
    jout = _jfwd(jops, {k: jnp.asarray(v) for k, v in w.items()},
                 JC.from_range(lo, hi))
    assert set(ops.scope_ranges) == set(jops.scope_ranges) == {
        "", "blk", "head"}
    _same(ops.scope_ranges, jops.scope_ranges)
    # observation is side-effect-only: the values are CaaOps'
    plain = _tfwd(CaaOps(TC.CaaConfig(u_max=u_max)),
                  {k: torch.from_numpy(v) for k, v in w.items()},
                  TC.from_range(torch.from_numpy(lo), torch.from_numpy(hi)))
    assert torch.equal(out.dbar, plain.dbar)
    assert out.shape == tuple(jout.shape)


def test_aggregate_ranges_matches_reference():
    paths = {"layer0": RangeStat(1.0, 0.5, False, 3),
             "layer0/attn": RangeStat(4.0, 0.1, True, 2),
             "layer1/mlp/up": RangeStat(3.0, 0.2, False, 1),
             "head": RangeStat(8.0, 1.0, False, 1),
             "": RangeStat(0.5, 0.5, False, 1),
             "other": RangeStat(9.0, 2.0, False, 1)}
    keys = ["layer0", "layer*/mlp", "layer0/attn", "head"]
    got = TA.aggregate_ranges(paths, keys)
    want = JA.aggregate_ranges(
        {k: JRangeStat(**v.to_dict()) for k, v in paths.items()}, keys)
    assert {k: v.to_dict() for k, v in got.items()} == \
        {k: v.to_dict() for k, v in want.items()}


# ---------------------------------------------------------------------------
# the transformer at qwen2_7b.SMOKE through the four drivers
# ---------------------------------------------------------------------------

def _reference_rope_tables(positions, d_head, theta=10000.0):
    cos, sin = JL.rope_tables(jnp.asarray(positions.cpu().numpy()), d_head,
                              theta)
    return (torch.from_numpy(np.array(cos)).to(positions.device),
            torch.from_numpy(np.array(sin)).to(positions.device))


@pytest.fixture(scope="module")
def lm():
    jcfg = JCfg.get("qwen2_7b").SMOKE
    tcfg = TCfg.get("qwen2_7b").SMOKE
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks = np.random.RandomState(0).randint(0, jcfg.vocab, (1, 8))

    def jfw(bk, p, x):
        lg, _ = JT.forward(bk, p, jcfg, jnp.asarray(toks))
        return JC.slice_(lg, (slice(None), slice(-1, None)))

    def tfw(bk, p, x):
        # the reference's f32 rope tables: torch's and XLA's f32 cos/sin
        # differ in the last ulp, 6e-8 relative, which is not what these
        # tests hold the port to
        own, TL.rope_tables = TL.rope_tables, _reference_rope_tables
        try:
            lg, _ = TT.forward(bk, p, tcfg, torch.from_numpy(toks))
        finally:
            TL.rope_tables = own
        if isinstance(lg, torch.Tensor):
            return lg[:, -1:]
        return TC.slice_(lg, (slice(None), slice(-1, None)))

    jx = JC.make(np.zeros((1, 1)))
    tx = TC.make(torch.zeros((1, 1), dtype=torch.float64))
    jcaa, tcaa = JC.CaaConfig(u_max=U_MAX), TC.CaaConfig(u_max=U_MAX)
    # the reference's eager passes, once: per-path IA and affine evidence
    ia = JRangeCaaOps(jcaa)
    jfw(ia, jp, jx)
    aff = JAffine({k: JF.custom(v) for k, v in FMT_MAP.items()},
                  JF.custom(FMT_DEFAULT))
    jfw(aff, jp, jx)
    keys = JA.discover_scopes(jfw, jp, jx, jcaa)
    return dict(
        jp=jp, tp=tp, jfw=jfw, tfw=tfw, jx=jx, tx=tx, jcaa=jcaa, tcaa=tcaa,
        ia_paths=dict(ia.scope_ranges), ia_seen=list(ia.seen_scopes),
        aff_paths=dict(aff.scope_ranges), keys=keys,
        tfmts={k: TF.custom(v) for k, v in FMT_MAP.items()},
        jsens=JA.sensitivity(jfw, jp, jx, keys, jcaa))


def test_lm_analyze_ranges(lm):
    ops = RangeCaaOps(lm["tcaa"])
    lm["tfw"](ops, lm["tp"], lm["tx"])
    assert ops.seen_scopes == lm["ia_seen"]
    assert set(ops.scope_ranges) == set(lm["ia_paths"])
    _same(ops.scope_ranges, lm["ia_paths"])
    got = TA.analyze_ranges(lm["tfw"], lm["tp"], lm["tx"], lm["tcaa"])
    want = JA.aggregate_ranges(lm["ia_paths"], lm["keys"])
    assert set(got) == set(want) == {"", "embed", "layer0", "layer1", "head"}
    _same(got, want)


def test_lm_analyze_ranges_stacked(lm):
    got = TA.analyze_ranges_stacked(lm["tfw"], lm["tp"], lm["tx"],
                                    lm["tcaa"], sublanes=SUBLANES)
    keys = [k for k in got if k]
    assert sorted(keys) == sorted(
        ["embed", "head"] + [f"layer{i}{s}" for i in range(2)
                             for s in ("", "/attn", "/mlp")])
    _same(got, JA.aggregate_ranges(lm["ia_paths"], keys))


@pytest.mark.parametrize("stacked", [False, True])
def test_lm_analyze_ranges_affine(lm, stacked):
    got = TA.analyze_ranges_affine(
        lm["tfw"], lm["tp"], lm["tx"], lm["tfmts"], TF.custom(FMT_DEFAULT),
        stacked=stacked, sublanes=SUBLANES)
    keys = [k for k in got if k]
    want = JA.aggregate_ranges(lm["aff_paths"], keys)
    assert set(got) == set(want)
    _same(got, want)
    # finite at every scope that ran an op (the pass's point)
    assert all(math.isfinite(s.max_abs) for s in got.values() if s.n_ops)


def test_lm_tighten_and_exact_forward_inside_both_maps(lm):
    """The IA map tightened by the affine one (both per layer/sub-layer),
    as the reference tightens its own; and every value the exact f64
    forward produces (TorchOps(f64), observed per scope like the range
    passes observe) lies within its scope's max_abs in both maps."""
    keys = ["embed", "head"] + [f"layer{i}{s}" for i in range(2)
                                for s in ("", "/attn", "/mlp")]
    ia = TA.analyze_ranges_stacked(lm["tfw"], lm["tp"], lm["tx"], lm["tcaa"],
                                   keys=keys, sublanes=SUBLANES)
    aff = TA.analyze_ranges_affine(
        lm["tfw"], lm["tp"], lm["tx"], lm["tfmts"], TF.custom(FMT_DEFAULT),
        keys=keys, sublanes=SUBLANES)
    tight = TA.tighten_range_maps(ia, aff)
    want = JA.tighten_range_maps(JA.aggregate_ranges(lm["ia_paths"], keys),
                                 JA.aggregate_ranges(lm["aff_paths"], keys))
    _same(tight, want)
    for k in keys:
        assert tight[k].max_abs <= min(ia[k].max_abs, aff[k].max_abs)
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    exact = chip_smoke.exact_maxima(torch, lm["tfw"], lm["tp"], lm["tx"],
                                    keys)
    assert set(exact) <= set(keys) | {""}
    for k, v in exact.items():
        assert v <= ia[k].max_abs and v <= aff[k].max_abs, (k, v)


def test_lm_discover_and_sensitivity_stacked(lm):
    got = TA.discover_scopes_stacked(lm["tfw"], lm["tp"], lm["tx"], 2,
                                     lm["tcaa"])
    assert got == lm["keys"] == ["embed", "layer0", "layer1", "head"]
    sens = TA.sensitivity_stacked(lm["tfw"], lm["tp"], lm["tx"], got,
                                  lm["tcaa"])
    for k in got:
        a, b = sens[k], lm["jsens"][k]
        if math.isinf(b):
            assert a == b, k
        else:
            np.testing.assert_allclose(a, b, rtol=DBAR_RTOL, err_msg=k)
    rank = lambda d: sorted(d, key=lambda k: (-d[k], k))
    assert rank(sens) == rank(lm["jsens"])


def test_lm_caa_trace_records_match_reference(lm):
    """The hooks under CaaOps: the same trace (attn_probs per layer, the
    logits) with the same bounds as the reference's eager analysis."""
    ops = CaaOps(lm["tcaa"])
    out = lm["tfw"](ops, lm["tp"], lm["tx"])
    jops = JCaaOps(lm["jcaa"])
    jout = lm["jfw"](jops, lm["jp"], lm["jx"])
    assert [(r.name, r.kind) for r in ops.trace] == \
        [(r.name, r.kind) for r in jops.trace]
    assert [r.name for r in ops.trace] == [
        "layer0/attn/attn_probs", "layer1/attn/attn_probs", "head/logits"]
    for r, jr in zip(ops.trace, jops.trace):
        for f in ("out_mag", "max_dbar", "max_ebar"):
            a, b = getattr(r, f), getattr(jr, f)
            if math.isinf(b):
                assert a == b
            else:
                np.testing.assert_allclose(a, b, rtol=DBAR_RTOL)
    np.testing.assert_allclose(out.dbar.numpy(), np.asarray(jout.dbar),
                               rtol=DBAR_RTOL)
