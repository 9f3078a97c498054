"""The port's paper drivers (``repro_torch.benchmarks``) against the JAX
package's ``benchmarks/`` scripts, on the CPU, at narrow widths.

On params made by the JAX package and carried across through numpy
(``repro_torch.convert.params_from_numpy``):

* the Table-I row functions (``table1.digits_row`` / ``convnet_row`` /
  ``pendulum_row``) equal the reference's ``_analyze_point`` and its
  Pendulum and ``decide_iterative`` steps: actual errors and bounds within
  a relative 1e-9 (f64 sums in another order; the rule of
  ``tests/test_torch_analyze.py``), required k equal;
* ``bound_tightness.measure`` equals the reference's measured error
  (the emulated dots are elementwise, so their bits agree) and its CAA
  bound within 1e-9, at every k and order of the table;
* ``analysis_speed`` reports the reference's row names, less the one that
  times a JAX recompilation (``gemm_format_sweep_recompile_s``), and
  ``run.main`` prints the CSV and appends one bench entry.
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import analysis_speed as janalysis_speed
from benchmarks import table1 as jtable1
from repro.core import caa as JC
from repro.core import formats as JF
from repro.core import precision as JP
from repro.core import quantize as JQ
from repro.core.backend import CaaOps as JCaaOps
from repro.data import synthetic_digits as jdigits
from repro.models import paper_models as JPM
from repro_torch.benchmarks import analysis_speed, bound_tightness, run, table1
from repro_torch.convert import params_from_numpy

RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs six workers on the machine's
    cores, and these full-width runs would otherwise oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _to_torch(jp):
    return params_from_numpy(jax.tree_util.tree_map(
        lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, jp),
        "cpu")


def _close(a, b):
    a, b = float(a), float(b)
    if not (np.isfinite(a) and np.isfinite(b)):
        assert a == b or (np.isnan(a) and np.isnan(b))
    else:
        np.testing.assert_allclose(b, a, rtol=RTOL)


@pytest.fixture(scope="module")
def digits():
    imgs, labels = jdigits.make_dataset(200, seed=0)
    jp = JPM.init_digits(jax.random.PRNGKey(0), h1=32, h2=16)
    jp = jtable1._train_digits(jp, imgs, labels, steps=40)
    return jp, _to_torch(jp), imgs, labels


def test_table1_digits_row_equals_the_reference(digits):
    jp, tp, imgs, labels = digits
    name, a, r, _, k, note = table1.digits_row(tp, imgs, labels)
    ja, jr = [], []
    for cls in range(10):
        idx = int(np.nonzero(labels == cls)[0][0])
        a_c, r_c, _, _ = jtable1._analyze_point(JPM.digits_forward, jp,
                                                imgs[idx])
        ja.append(a_c)
        jr.append(r_c)
    x0 = imgs[0].astype(np.float64)

    # the reference's bounds_at, jitted once with u traced (its eager form
    # takes the same numbers op by op, ten times slower)
    @jax.jit
    def worst(u):
        cfg = JC.CaaConfig(u_max=u)
        out = JPM.digits_forward(JCaaOps(cfg), jp, JC.weight(x0, cfg))
        return jnp.max(out.dbar), jnp.max(out.ebar)

    jk = JP.decide_iterative(
        lambda u: tuple(float(v) for v in worst(jnp.asarray(u))),
        p_star=0.60).required_k
    assert name == "Digits" and "paper: 1.1u/3.4u/12s/k=8" in note
    _close(max(ja), a)
    _close(max(jr), r)
    assert k == jk


def test_table1_convnet_and_pendulum_rows_equal_the_reference(digits):
    _, _, imgs, _ = digits
    jc = JPM.init_convnet(jax.random.PRNGKey(1), img=28, c1=4, c2=8)
    _, a, r, _, _, _ = table1.convnet_row(_to_torch(jc), imgs)
    ja, jr, _, _ = jtable1._analyze_point(JPM.convnet_forward, jc,
                                          imgs[0].reshape(1, 28, 28, 1))
    _close(ja, a)
    _close(jr, r)

    pp = JPM.init_pendulum(jax.random.PRNGKey(2), h=8)
    pp = jtable1._train_pendulum(pp, steps=20)
    _, d, e, _, _, _ = table1.pendulum_row(_to_torch(pp))
    cfg = JC.CaaConfig(u_max=2 ** -7)

    @jax.jit                      # as the reference's Table I runs it
    def pend(lo, hi):
        out = JPM.pendulum_forward(JCaaOps(cfg), pp, JC.from_range(lo, hi))
        return jnp.max(out.dbar), jnp.max(out.ebar)

    jd, je = (float(v) for v in pend(np.full(2, -6.0), np.full(2, 6.0)))
    _close(jd, d)
    _close(je if np.isfinite(je) else float("nan"), e)


@pytest.mark.parametrize("k", bound_tightness.KS)
def test_bound_tightness_equals_the_reference(k):
    x, W, exact = bound_tightness.operands()
    fmt = JF.custom(k)
    for order in bound_tightness.ORDERS:
        meas, bound = bound_tightness.measure(x, W, exact, k, order, "cpu")
        cfg = JC.CaaConfig(u_max=fmt.u, emulate_k=k, acc_order=order)
        res = JC.matmul(JC.weight(x, cfg), JC.weight(W, cfg), cfg)
        dot = JQ.seq_dot if order == "sequential" else JQ.pairwise_dot
        emp = dot(jnp.asarray(x)[None], jnp.asarray(W), fmt)[0]
        _close(float(jnp.max(jnp.abs(emp - exact))) / fmt.u, meas)
        _close(float(jnp.max(res.dbar)), bound)


def test_analysis_speed_rows_are_the_references(monkeypatch):
    """Both drivers with their measurements stubbed out: the row names."""
    jstubs = {
        "_time_analysis": lambda h1, h2, **k: (1000 * (h1 + h2), 1.0, 1.0),
        "_bench_batched_vs_sequential": lambda **k: (1.0, 1.0),
        "_bench_certified_store": lambda **k: (1.0, 1.0),
        "_bench_probe_ladder": lambda **k: (1.0, 1.0, 1.0),
        "_bench_mixed_vs_uniform_serving": lambda **k: (1.0, 1.0, 21, 18.0),
        "_bench_format_sweep_vs_mantissa": lambda **k: (1.0, 1.0, 1.0, 1),
        "_bench_scalar_prefetch_vs_recompile": lambda **k: (1.0, 1.0, 8),
        "_bench_stacked_vs_unrolled": lambda **k: [
            (L, 1.0, 1.0, 1.0) for L in (2, 4, 8)]}
    tstubs = {
        "_time_analysis": lambda h1, h2, dev, **k: (1000 * (h1 + h2), 1.0),
        "_bench_batched_vs_sequential": lambda dev, **k: (1.0, 1.0),
        "_bench_certified_store": lambda dev, **k: (1.0, 1.0),
        "_bench_probe_ladder": lambda dev, **k: (1.0, 1.0, 1.0),
        "_bench_mixed_vs_uniform_serving":
            lambda dev, **k: (1.0, 1.0, 21, 18.0),
        "_bench_format_sweep_vs_mantissa":
            lambda dev, **k: (1.0, 1.0, 1.0, 1),
        "_bench_format_sweep": lambda dev, **k: (1.0, 8),
        "_bench_stacked_vs_unrolled": lambda dev, **k: [
            (L, 1.0, 1.0) for L in (2, 4, 8)]}
    for name, value in jstubs.items():
        monkeypatch.setattr(janalysis_speed, name, value)
    for name, value in tstubs.items():
        monkeypatch.setattr(analysis_speed, name, value)
    want = [r[0] for r in janalysis_speed.run()]
    got = [r[0] for r in analysis_speed.run("cpu")]
    assert "gemm_format_sweep_recompile_s" in want
    assert got == [n for n in want if n != "gemm_format_sweep_recompile_s"]


def test_analysis_speed_measurements_run_small():
    """The port's own measurements, at small sizes, on the CPU."""
    n, st = analysis_speed._time_analysis(16, 8, "cpu", reps=1)
    assert n == 784 * 16 + 16 + 16 * 8 + 8 + 8 * 10 + 10 and st > 0
    t, nf = analysis_speed._bench_format_sweep("cpu", M=4, K=8, N=4, reps=1)
    assert nf == 8 and t > 0
    assert analysis_speed.format_sweep() == [
        (8, 3, -2), (9, 7, -6), (10, 15, -14), (11, 31, -30),
        (12, 3, -2), (13, 7, -6), (14, 15, -14), (15, 31, -30)]
    rows = analysis_speed._bench_stacked_vs_unrolled("cpu", depths=(1, 2),
                                                     reps=1)
    assert [r[0] for r in rows] == [1, 2]
    t_uni, t_mix, uk, mk = analysis_speed._bench_mixed_vs_uniform_serving(
        "cpu", d_in=8, h1=8, h2=8, batch=4, reps=1)
    assert uk == 21 and mk < uk and t_uni > 0 and t_mix > 0


def test_run_prints_csv_and_appends_one_bench_entry(monkeypatch, tmp_path,
                                                    capsys):
    from repro_torch.obs.bench import read_bench

    monkeypatch.setenv("REPRO_TORCH_BENCH_DIR", str(tmp_path))
    monkeypatch.setattr(table1, "run", lambda dev: [("table1_Digits", 1.0,
                                                     0.5)])
    monkeypatch.setattr(analysis_speed, "run", lambda dev: [
        ("digits_speedup_x", 2.0, 3.0)])
    rows = run.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "name,us_per_call,derived" in out and "tightness_k16_pairwise" \
        in out
    assert [r[0] for r in rows][:2] == ["table1_Digits", "digits_speedup_x"]
    entries = read_bench("micro", str(tmp_path))
    assert len(entries) == 1 and entries[0]["device"] == "cpu"
    assert [r["name"] for r in entries[0]["rows"]] == [r[0] for r in rows]
