"""The recurrent layers of the port (``repro_torch.models.ssm``) and the
recurrence rules of its analysis backends, against the JAX package's, on
the CPU, on the same inputs (made with numpy from a seed; the layers on
the reference's own SMOKE parameters, carried across through numpy).

* ``_wkv_chunked`` at T = 1, 32 and 40 (zero padding past one chunk of 32),
  from a zero state and from a given one; ``rwkv_tmix`` with and without a
  state, ``rwkv_cmix`` with and without the previous token, ``mamba_lite``
  with and without an initial state: outputs and states within 2e-6 of
  the reference's, relative to their largest magnitude (the plain serving
  tolerance of ``tests/_torch_serve_parity.py::check_steps``: f32 sums in
  other orders; 1.54e-6 the largest measured).
* The same layers under ``CaaOps`` (emulated k = 12): values equal, δ̄, ε̄
  and the enclosures within 1e-9 relative (the f64 rules in the
  reference's order).
* ``ssm_scan`` on ``TorchOps`` (values, f32 within 2e-6 relative; f64 within
  1e-12), and on ``CaaOps``, ``RangeCaaOps``, ``AffineRangeCaaOps`` and
  their layer-stacked subclasses: values, δ̄, ε̄ and the enclosures within
  1e-9 relative (∞ only where the reference has ∞), the range passes'
  ``scope_ranges`` likewise. Cases: a contracting decay (the geometric
  branch), a decay reaching 1 (the clamp and the linear branch of
  ``scan_affine_fixpoint``; the affine rule's ∞), and a decay above 1 with
  the clamp off (the exponential branch).
"""

import _torch_test_setup  # noqa: F401  (before any reference compile)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import caa as JC
from repro.core import formats as JF
from repro.core import interval as jiv
from repro.core.backend import AffineRangeCaaOps as JAffine
from repro.core.backend import CaaOps as JCaaOps
from repro.core.backend import JOps
from repro.core.backend import RangeCaaOps as JRange
from repro.core.backend import StackedAffineRangeCaaOps as JStackedAffine
from repro.core.backend import StackedCaaOps as JStacked
from repro.core.backend import StackedRangeCaaOps as JStackedRange
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.convert import params_from_numpy
from repro_torch.core import caa as TC
from repro_torch.core import formats as TF
from repro_torch.core import interval as tiv
from repro_torch.core.backend import (AffineRangeCaaOps, CaaOps,
                                      RangeCaaOps, StackedAffineRangeCaaOps,
                                      StackedCaaOps, StackedRangeCaaOps,
                                      TorchOps)
from repro_torch.models import ssm as TS

PLAIN = 2e-6        # relative to the largest magnitude (plain serving's)
REL = 1e-9          # the analysis rules
K = 12
U = 2.0 ** (1 - K)


def _rel_close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _bounds_close(got, want, what=""):
    """Equal, ∞ where the reference has ∞, else within REL relative."""
    got = np.broadcast_to(np.asarray(got, np.float64), np.shape(want))
    want = np.asarray(want, np.float64)
    inf = ~np.isfinite(want)
    assert np.array_equal(~np.isfinite(got), inf), what
    g, w = got[~inf], want[~inf]
    tol = REL * np.maximum(np.abs(g), np.abs(w))
    assert np.all(np.abs(g - w) <= tol), (
        what, float(np.max(np.abs(g - w) - tol)))


def _same_caa(t, j, what=""):
    """A port CaaTensor against the reference's: values, enclosure, δ̄, ε̄."""
    shape = tuple(j.val.shape)
    assert tuple(t.shape) == shape, what
    _bounds_close(t.val.numpy(), np.asarray(j.val), what + " val")
    for name, a, b in (("lo", t.exact.lo, j.exact.lo),
                       ("hi", t.exact.hi, j.exact.hi),
                       ("dbar", t.dbar, j.dbar), ("ebar", t.ebar, j.ebar)):
        _bounds_close(np.broadcast_to(a.numpy(), shape),
                      np.broadcast_to(np.asarray(b), shape),
                      f"{what} {name}")


_PARAMS = {}


def layer_params(arch):
    """(JAX, port) parameters of layer 0 of ``arch``'s SMOKE config (the
    reference's ``init_params``, key 0)."""
    if arch not in _PARAMS:
        cfg = jconfigs.get(arch).SMOKE
        jp = JT.init_params(jax.random.PRNGKey(0), cfg)
        j0 = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
        t0 = params_from_numpy(jax.tree_util.tree_map(np.asarray, j0),
                               "cpu")
        _PARAMS[arch] = (cfg, j0, t0)
    return _PARAMS[arch]


# ---------------------------------------------------------------------------
# the plain layers
# ---------------------------------------------------------------------------

def _wkv_inputs(T, B=2, H=3, C=8, seed=0):
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(B, T, H, C).astype(np.float32) for _ in range(3))
    w_log = -np.exp(rng.randn(B, T, H, C).astype(np.float32) - 0.6)
    u = (0.3 * rng.randn(H, C)).astype(np.float32)
    S0 = rng.randn(B, H, C, C).astype(np.float32)
    return r, k, v, w_log, u, S0


@pytest.mark.parametrize("with_state", (False, True))
@pytest.mark.parametrize("T", (1, 32, 40))
def test_wkv_chunked_matches_reference(T, with_state):
    r, k, v, w_log, u, S0 = _wkv_inputs(T)
    jo, jS = JS._wkv_chunked(JOps(jnp.float32, jnp.float32), *map(
        jnp.asarray, (r, k, v, w_log, u)), chunk=32,
        S0=jnp.asarray(S0) if with_state else None)
    to, tS = TS._wkv_chunked(TorchOps(), *map(torch.from_numpy,
                                              (r, k, v, w_log, u)),
                             chunk=32,
                             S0=torch.from_numpy(S0) if with_state else None)
    _rel_close(to.numpy(), jo, PLAIN, "out")
    _rel_close(tS.numpy(), jS, PLAIN, "state")


def _x(cfg, S=6, B=2, seed=1):
    return np.random.RandomState(seed).randn(B, S, cfg.d_model).astype(
        np.float32)


@pytest.mark.parametrize("with_state", (False, True))
def test_rwkv_time_and_channel_mix_match_reference(with_state):
    cfg, jp, tp = layer_params("rwkv6_1p6b")
    x = _x(cfg)
    rng = np.random.RandomState(2)
    C = cfg.d_model // cfg.n_heads
    S0 = rng.randn(2, cfg.n_heads, C, C).astype(np.float32)
    xp = rng.randn(2, cfg.d_model).astype(np.float32)
    jstate = JS.RwkvState(jnp.asarray(S0), jnp.asarray(xp)) \
        if with_state else None
    tstate = TS.RwkvState(torch.from_numpy(S0), torch.from_numpy(xp)) \
        if with_state else None
    jbk = JOps(jnp.float32, jnp.float32)
    jo, js = JS.rwkv_tmix(jbk, jnp.asarray(x), jp["tmix"],
                          n_heads=cfg.n_heads, state=jstate)
    with torch.no_grad():
        to, ts = TS.rwkv_tmix(TorchOps(), torch.from_numpy(x), tp["tmix"],
                              n_heads=cfg.n_heads, state=tstate)
    _rel_close(to.numpy(), jo, PLAIN, "tmix out")
    _rel_close(ts.S.numpy(), js.S, PLAIN, "tmix state")
    assert np.array_equal(ts.x_prev.numpy(), np.asarray(js.x_prev))
    jc = JS.rwkv_cmix(jbk, jnp.asarray(x), jp["cmix"],
                      jnp.asarray(xp) if with_state else None)
    with torch.no_grad():
        tc = TS.rwkv_cmix(TorchOps(), torch.from_numpy(x), tp["cmix"],
                          torch.from_numpy(xp) if with_state else None)
    _rel_close(tc.numpy(), jc, PLAIN, "cmix")


@pytest.mark.parametrize("with_state", (False, True))
def test_mamba_lite_matches_reference(with_state):
    cfg, jp, tp = layer_params("hymba_1p5b")
    x = _x(cfg)
    din = cfg.mamba_expand * cfg.d_model
    h0 = np.random.RandomState(3).randn(2, din, cfg.ssm_state).astype(
        np.float32)
    jo, jh = JS.mamba_lite(JOps(jnp.float32, jnp.float32), jnp.asarray(x),
                           jp["mamba"], d_state=cfg.ssm_state,
                           h0=jnp.asarray(h0) if with_state else None,
                           return_state=True)
    with torch.no_grad():
        to, th = TS.mamba_lite(TorchOps(), torch.from_numpy(x), tp["mamba"],
                               d_state=cfg.ssm_state,
                               h0=torch.from_numpy(h0) if with_state
                               else None, return_state=True)
    _rel_close(to.numpy(), jo, PLAIN, "out")
    _rel_close(th.numpy(), jh, PLAIN, "state")
    plain = TS.mamba_lite(TorchOps(), torch.from_numpy(x), tp["mamba"],
                          d_state=cfg.ssm_state)
    assert torch.equal(plain, TS.mamba_lite(
        TorchOps(), torch.from_numpy(x), tp["mamba"],
        d_state=cfg.ssm_state, return_state=True)[0])


# ---------------------------------------------------------------------------
# the layers under the analysis
# ---------------------------------------------------------------------------

def _caa_cfgs():
    return (JC.CaaConfig(u_max=U, emulate_k=K),
            TC.CaaConfig(u_max=U, emulate_k=K))


def test_rwkv_time_mix_under_caa_matches_reference():
    cfg, jp, tp = layer_params("rwkv6_1p6b")
    x = _x(cfg, S=4, B=1)
    jc, tc = _caa_cfgs()
    jbk, tbk = JCaaOps(jc), CaaOps(tc)
    jo, _ = JS.rwkv_tmix(jbk, jbk.input(jnp.asarray(x, jnp.float64)),
                         jp["tmix"], n_heads=cfg.n_heads)
    to, _ = TS.rwkv_tmix(tbk, tbk.input(torch.from_numpy(x).double()),
                         tp["tmix"], n_heads=cfg.n_heads)
    _same_caa(to, jo, "rwkv_tmix")


def test_mamba_lite_under_caa_matches_reference():
    cfg, jp, tp = layer_params("hymba_1p5b")
    x = _x(cfg, S=4, B=1)
    jc, tc = _caa_cfgs()
    jbk, tbk = JCaaOps(jc), CaaOps(tc)
    jo = JS.mamba_lite(jbk, jbk.input(jnp.asarray(x, jnp.float64)),
                       jp["mamba"], d_state=cfg.ssm_state)
    to = TS.mamba_lite(tbk, tbk.input(torch.from_numpy(x).double()),
                       tp["mamba"], d_state=cfg.ssm_state)
    _same_caa(to, jo, "mamba_lite")


# ---------------------------------------------------------------------------
# ssm_scan on every backend
# ---------------------------------------------------------------------------

# (decay lo, decay hi): contracting; reaching 1 (the clamp, the linear
# branch; the affine rule's ∞)
DECAYS = {"contracting": (0.2, 0.9), "reaching_one": (0.5, 1.0)}


def _scan_inputs(case, B=2, T=5, D=3, N=4, seed=4):
    rng = np.random.RandomState(seed)
    lo, hi = DECAYS[case]
    dec = rng.uniform(lo, hi, (B, T, 1, N))
    dec[0, 0, 0, 0] = hi
    drv = rng.randn(B, T, D, N)
    rad = 1e-3 * np.abs(rng.randn(B, T, D, N))
    dbar = np.abs(rng.randn(B, T, D, N))
    return dec, drv, rad, dbar


def _caa_pair(dec, drv, rad, dbar):
    """The scan's operands as (JAX, port) CaaTensors: decays exact points
    with a small δ̄, drives with a radius and a δ̄ of their own."""
    j = (JC.make(jnp.asarray(dec), dbar=jnp.full(dec.shape, 0.25)),
         JC.make(jnp.asarray(drv), jiv.Interval(jnp.asarray(drv - rad),
                                                jnp.asarray(drv + rad)),
                 dbar=jnp.asarray(dbar)))
    t = (TC.make(torch.from_numpy(dec), dbar=torch.full(dec.shape, 0.25,
                                                        dtype=torch.float64)),
         TC.make(torch.from_numpy(drv), tiv.Interval(
             torch.from_numpy(drv - rad), torch.from_numpy(drv + rad)),
                 dbar=torch.from_numpy(dbar)))
    return j, t


@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_torchops_ssm_scan_matches_reference(dtype):
    dec, drv, _, _ = _scan_inputs("contracting")
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jh = JOps(jd, jd).ssm_scan(jnp.asarray(dec, jd), jnp.asarray(drv, jd),
                               dec.shape[1], time_axis=1)
    th = TorchOps(td).ssm_scan(torch.from_numpy(dec).to(td),
                               torch.from_numpy(drv).to(td), dec.shape[1],
                               time_axis=1)
    assert th.dtype == td and tuple(th.shape) == drv.shape
    _rel_close(th.numpy(), jh, PLAIN if dtype == "float32" else 1e-12)
    # the time axis anywhere: the same scan, moved
    th2 = TorchOps(td).ssm_scan(torch.from_numpy(dec).to(td).movedim(1, 2),
                                torch.from_numpy(drv).to(td).movedim(1, 2),
                                dec.shape[1], time_axis=2)
    assert torch.equal(th2.movedim(2, 1), th)


CAA_BACKENDS = {
    "CaaOps": (lambda c: JCaaOps(c), lambda c: CaaOps(c)),
    "RangeCaaOps": (lambda c: JRange(c), lambda c: RangeCaaOps(c)),
    "StackedCaaOps": (lambda c: JStacked(c), lambda c: StackedCaaOps(c)),
    "StackedRangeCaaOps": (lambda c: JStackedRange(c),
                           lambda c: StackedRangeCaaOps(c)),
}


@pytest.mark.parametrize("case", tuple(DECAYS))
@pytest.mark.parametrize("backend", tuple(CAA_BACKENDS))
def test_caa_ssm_scan_matches_reference(backend, case):
    dec, drv, rad, dbar = _scan_inputs(case)
    (jdec, jdrv), (tdec, tdrv) = _caa_pair(dec, drv, rad, dbar)
    jc, tc = _caa_cfgs()
    make_j, make_t = CAA_BACKENDS[backend]
    jbk, tbk = make_j(jc), make_t(tc)
    jh = jbk.ssm_scan(jdec, jdrv, dec.shape[1], time_axis=1)
    th = tbk.ssm_scan(tdec, tdrv, dec.shape[1], time_axis=1)
    _same_caa(th, jh, backend)
    assert np.all(np.isfinite(th.dbar.numpy()))
    if "Range" in backend:
        jr = (jbk.collect_ranges() if hasattr(jbk, "collect_ranges")
              else jbk.scope_ranges)
        tr = (tbk.collect_ranges() if hasattr(tbk, "collect_ranges")
              else tbk.scope_ranges)
        assert set(jr) == set(tr)
        for key in jr:
            a, b = jr[key], tr[key]
            assert (a.n_ops, a.crosses_zero) == (b.n_ops, b.crosses_zero)
            _bounds_close(b.max_abs, a.max_abs, f"{key} max_abs")
            _bounds_close(b.min_nonzero, a.min_nonzero, f"{key} min_nz")


@pytest.mark.parametrize("decay_le_one", (True, False))
def test_scan_affine_fixpoint_branches_match_reference(decay_le_one):
    """The fixpoint rule's three branches, m < 1, m = 1 and m > 1 (the
    last only with the clamp off), on worst-over-time operands."""
    rng = np.random.RandomState(5)
    dec = np.array([[0.5, 0.9], [1.0, 1.0], [1.1, 1.3]])
    drv = rng.randn(3, 2)
    for T in (1, 7, 500):
        j = JC.scan_affine_fixpoint(
            JC.make(jnp.asarray(dec), dbar=jnp.full(dec.shape, 0.5)),
            JC.make(jnp.asarray(drv), dbar=jnp.full(drv.shape, 2.0)), T,
            JC.CaaConfig(u_max=U, round_abs=1e-6), decay_le_one)
        t = TC.scan_affine_fixpoint(
            TC.make(torch.from_numpy(dec), dbar=torch.full(dec.shape, 0.5,
                                                          dtype=torch.float64)),
            TC.make(torch.from_numpy(drv), dbar=torch.full(
                drv.shape, 2.0, dtype=torch.float64)), T,
            TC.CaaConfig(u_max=U, round_abs=1e-6), decay_le_one)
        _same_caa(t, j, f"T={T}")
        # with the clamp, bounds stay finite and at most linear in T
        if decay_le_one:
            assert np.all(np.isfinite(t.dbar.numpy()))


AFF_BACKENDS = {
    "AffineRangeCaaOps": (lambda: JAffine({}, JF.custom(K)),
                          lambda: AffineRangeCaaOps({}, TF.custom(K))),
    "StackedAffineRangeCaaOps": (
        lambda: JStackedAffine({}, JF.custom(K)),
        lambda: StackedAffineRangeCaaOps({}, TF.custom(K))),
}


@pytest.mark.parametrize("case", tuple(DECAYS))
@pytest.mark.parametrize("backend", tuple(AFF_BACKENDS))
def test_affine_ssm_scan_matches_reference(backend, case):
    """The interval fixpoint B'/(1−w') with its inflation, ∞ when the
    rounded decay reaches 1; the values from the f64 scan."""
    dec, drv, _, _ = _scan_inputs(case)
    make_j, make_t = AFF_BACKENDS[backend]
    jbk, tbk = make_j(), make_t()
    jh = jbk.ssm_scan(jnp.asarray(dec), jnp.asarray(drv), dec.shape[1],
                      time_axis=1)
    th = tbk.ssm_scan(torch.from_numpy(dec), torch.from_numpy(drv),
                      dec.shape[1], time_axis=1)
    _bounds_close(th.val.numpy(), np.asarray(jh.val), "val")
    for name in ("lo", "hi"):
        _bounds_close(getattr(th.exact, name).numpy(),
                      np.asarray(getattr(jh.exact, name)), name)
    finite = bool(np.all(np.isfinite(th.exact.hi.numpy())))
    assert finite == (case == "contracting")
    tr = (tbk.collect_ranges() if hasattr(tbk, "collect_ranges")
          else tbk.scope_ranges)
    jr = (jbk.collect_ranges() if hasattr(jbk, "collect_ranges")
          else jbk.scope_ranges)
    assert set(tr) == set(jr)
    for key in jr:
        _bounds_close(tr[key].max_abs, jr[key].max_abs, key)
        assert tr[key].n_ops == jr[key].n_ops
