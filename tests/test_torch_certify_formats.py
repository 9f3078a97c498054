"""The port's format synthesis (``repro_torch.certify.formats``: the
format-aware analysis, the probe ladder, ``synthesize_formats``) against
the JAX package's, on the reference's params carried across through numpy.

Models: Digits at h1 = 16 / h2 = 8 (ten class envelopes, mixed + formats,
k_max 24) and Pendulum at h = 16 (abs_tol 1e-3, formats, k_max 32) — the
fixtures of ``tests/test_formats_synthesis.py``. Equal: ``required_k``,
``layer_k``, ``layer_format``, the synthesis history (every probed lattice
point and its verdict), the emax floors, the probe counts and the store
key; within 1e-9 relative: the certified bounds and the confirming pass's
per-class bounds (inf equal to inf). The port's v3 map is then served
through ``FormatQuantJOps`` bit for bit as an eager emulation of the map.
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import math
import os

import jax
import numpy as np
import pytest
import torch

from repro import certify as JC
from repro.certify import formats as JFS
from repro.core import formats as JF
from repro.models import paper_models as JPM
from repro_torch import certify as TC
from repro_torch.certify import formats as TFS
from repro_torch.convert import params_from_numpy
from repro_torch.core import caa as tcaa
from repro_torch.core import formats as TF
from repro_torch.core.quantize import quantize_to_format
from repro_torch.launch import serve as tserve
from repro_torch.models import paper_models as TPM

RTOL = 1e-9
P_STAR, ABS_TOL = 0.6, 1e-3


def _close(a, b):
    return a == b or (math.isfinite(a) and math.isfinite(b)
                      and abs(a - b) <= RTOL * max(abs(a), abs(b)))


def _digits_setup():
    from repro.data import synthetic_digits

    imgs, labels = synthetic_digits.make_dataset(160, seed=0)
    params = JPM.init_digits(jax.random.PRNGKey(0), h1=16, h2=8)
    los, his = [], []
    for c in range(10):
        m = imgs[labels == c].mean(0)
        los.append(np.clip(m - 0.02, 0.0, 1.0))
        his.append(np.clip(m + 0.02, 0.0, 1.0))
    return params, los, his


def _port(jp):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def digits_case(tmp_path_factory):
    jp, los, his = _digits_setup()
    tp = _port(jp)
    kw = dict(p_star=P_STAR, model_id="digits/fmt-test", k_max=24,
              mixed=True, formats=True)
    roots = [str(tmp_path_factory.mktemp(n)) for n in ("jd", "td")]
    js = JC.certify(JPM.digits_forward, jp, los, his,
                    store=JC.CertificateStore(roots[0]), **kw)
    ts = TC.certify(TPM.digits_forward, tp, los, his,
                    store=TC.CertificateStore(roots[1]), **kw)
    return jp, tp, los, his, js, ts, roots


@pytest.fixture(scope="module")
def pendulum_case(tmp_path_factory):
    jp = JPM.init_pendulum(jax.random.PRNGKey(2), h=16)
    tp = _port(jp)
    lo, hi = np.full(2, -6.0), np.full(2, 6.0)
    kw = dict(abs_tol=ABS_TOL, model_id="pendulum/fmt-test", k_max=32,
              formats=True)
    roots = [str(tmp_path_factory.mktemp(n)) for n in ("jp", "tp")]
    js = JC.certify(JPM.pendulum_forward, jp, [lo], [hi],
                    store=JC.CertificateStore(roots[0]), **kw)
    ts = TC.certify(TPM.pendulum_forward, tp, [lo], [hi],
                    store=TC.CertificateStore(roots[1]), **kw)
    return jp, tp, [lo], [hi], js, ts, roots


@pytest.mark.parametrize("case", ["digits_case", "pendulum_case"])
def test_format_certificates_equal_reference(case, request):
    *_, js, ts, roots = request.getfixturevalue(case)
    assert len(js.certificates) == len(ts.certificates)
    for a, b in zip(js.certificates, ts.certificates):
        assert a.required_k == b.required_k and a.required_k is not None
        assert a.satisfied_by == b.satisfied_by
        assert a.layer_k == b.layer_k
        assert a.layer_format == b.layer_format and b.layer_format
        assert _close(a.final_abs_u, b.final_abs_u)
        assert _close(a.final_rel_u, b.final_rel_u)
    assert js.meta["probes"] == ts.meta["probes"]
    assert os.listdir(roots[0]) == os.listdir(roots[1])
    assert js.serving_layer_format == ts.serving_layer_format


@pytest.mark.parametrize("case", ["digits_case", "pendulum_case"])
def test_format_synthesis_trail_equals_reference(case, request):
    *_, js, ts, _ = request.getfixturevalue(case)
    jf, tf = js.meta["formats"], ts.meta["formats"]
    assert tf["applied"] and jf["applied"]
    for key in ("layer_format", "uniform_k", "k_ref", "baseline_bits",
                "emax_floor_bits", "history", "probes"):
        assert jf[key] == tf[key], key
    for key in ("abs_u_ref", "rel_u_ref"):
        assert all(_close(a, b) for a, b in zip(jf[key], tf[key])), key
    assert math.isclose(jf["mean_bits_flop_weighted"],
                        tf["mean_bits_flop_weighted"])
    assert jf["scope_ranges"].keys() == tf["scope_ranges"].keys()
    for s, r in jf["scope_ranges"].items():
        for field in ("max_abs", "min_nonzero"):
            assert _close(r[field], tf["scope_ranges"][s][field]), (s, field)
    assert tf["ladder_compiles"] == 0


def test_mixed_map_of_the_format_run_equals_reference(digits_case):
    *_, js, ts, _ = digits_case
    assert js.meta["mixed"]["layer_k"] == ts.meta["mixed"]["layer_k"]
    assert js.meta["mixed"]["probes"] == ts.meta["mixed"]["probes"]


def test_eager_format_report_equals_reference(digits_case):
    """One eager format-aware pass of the certified map: the per-class
    bounds and every scope's range enclosure."""
    jp, tp, los, his, js, _, _ = digits_case
    lf = {s: JF.from_dict(d) for s, d in js.serving_layer_format.items()
          if s}
    df = JF.from_dict(js.serving_layer_format[""])
    keys = sorted(lf)
    ja, jr, jk, jranges = JFS.eager_format_report(
        JPM.digits_forward, jp, JC.stack_class_ranges(los, his), lf, df,
        keys)
    tlf = {s: TF.from_dict(d) for s, d in js.serving_layer_format.items()
           if s}
    ta, tr, tk, tranges = TFS.eager_format_report(
        TPM.digits_forward, tp, TC.stack_class_ranges(los, his), tlf,
        TF.from_dict(js.serving_layer_format[""]), keys)
    assert jk == tk
    assert all(_close(a, b) for a, b in zip(np.asarray(ja), ta))
    assert all(_close(a, b) for a, b in zip(np.asarray(jr), tr))
    assert jranges.keys() == tranges.keys()
    for s in jranges:
        assert _close(jranges[s].max_abs, tranges[s].max_abs)
        assert jranges[s].n_ops == tranges[s].n_ops


def test_format_ladder_probes_equal_eager_report(digits_case):
    """The port's ladder is the eager analysis: its bounds equal an eager
    format-aware pass of the same map, in both the flat and the stacked
    form (no layer loop here, so both are the plain per-scope pass)."""
    _, tp, los, his, js, _, _ = digits_case
    x = TC.stack_class_ranges(los, his)
    lf = {s: TF.from_dict(d) for s, d in js.serving_layer_format.items()
          if s}
    df = TF.from_dict(js.serving_layer_format[""])
    keys = sorted(lf)
    ea, er, ek, _ = TFS.eager_format_report(TPM.digits_forward, tp, x, lf,
                                            df, keys)
    for stacked in (False, True):
        lad = TFS.FormatProbeLadder(TPM.digits_forward, tp, x, keys,
                                    stacked=stacked)
        a, r, k = lad(lf, df)
        assert k == ek and np.array_equal(a, ea) and np.array_equal(r, er)
        view = lad.mixed_view()
        ma, _, mk = view({s: f.k for s, f in lf.items()}, df.k)
        assert lad.probes == 2 and view.probes == 2 and view.compiles == 0
        assert mk == min(f.k for f in list(lf.values()) + [df])


def test_min_exponent_bits_equals_reference():
    for k in (3, 8, 11, 24):
        for m in (0.0, 1e-3, 0.75, 1.0, 3.5, 448.0, 6.5e4, 1e30,
                  float("inf")):
            assert (TFS.min_exponent_bits_for_range(k, m, 2, 8)
                    == JFS.min_exponent_bits_for_range(k, m, 2, 8)), (k, m)


def test_scope_vectors_equal_reference():
    keys = ["a", "b", "c"]
    jm = {"a": JF.from_bits(12, 5), "b": JF.from_bits(9, 4),
          "c": JF.from_bits(20, 8)}
    tm = {s: TF.from_bits(f.k, TF.exponent_bits(f.emax, f.emin))
          for s, f in jm.items()}
    ju, js_, jr = JFS.scope_vectors(jm, JF.from_bits(16, 6), keys)
    tu, ts_, tr = TFS.scope_vectors(tm, TF.from_bits(16, 6), keys)
    assert ju == tu and np.array_equal(js_, ts_) and np.array_equal(jr, tr)


def test_serving_backend_applies_the_ports_v3_map_bitwise(digits_case):
    """``FormatQuantJOps`` under the port's merged serving map equals an
    eager emulation of exactly that map (the CPU dispatch: operands and
    result rounded into each scope's format, the product by
    ``torch.matmul``)."""
    _, tp, _, _, _, ts, _ = digits_case
    sm = ts.serving_layer_format
    bk = tserve.FormatQuantJOps(sm)
    x = torch.from_numpy(np.random.RandomState(1).rand(4, 784)
                         .astype(np.float32))
    got = TPM.digits_forward(bk, tp, x)

    def q(v, fd):
        return quantize_to_format(v.to(torch.float32), fd["k"], fd["emax"],
                                  fd["emin"])

    def mm(a, w, b, fd):
        return q(torch.matmul(q(a, fd), q(w, fd)), fd) + b

    h = torch.relu(mm(x, tp["w1"], tp["b1"], sm["dense1"]))
    h = torch.relu(mm(h, tp["w2"], tp["b2"], sm["dense2"]))
    o = mm(h, tp["w3"], tp["b3"], sm["dense3"])
    want = torch.softmax(o, dim=-1)
    assert torch.equal(got, want)


def test_format_caa_ops_unit_scales_equal_uniform_analysis(digits_case):
    """FormatCaaOps with every scale 1 and every underflow 0 is the
    uniform batched analysis, as in the reference."""
    _, tp, los, his, _, _, _ = digits_case
    x = TC.stack_class_ranges(los, his)
    cfg = tcaa.CaaConfig(u_max=2.0 ** -15)
    ops = TFS.FormatCaaOps(cfg, {"dense1": 1.0}, {"dense1": 0.0})
    a = TPM.digits_forward(ops, tp, x)
    b = TPM.digits_forward(TC.batch.CaaOps(cfg), tp, x)
    assert torch.equal(a.dbar, b.dbar) and torch.equal(a.ebar, b.ebar)

