"""Uniform- and per-layer-k certified serving on the CPU: the port's k-bit
GEMM pair (``quant_matmul_ref``, ``quant_matmul_dynamic_k``) against the JAX
package's oracle, its dynamic-k function and its Pallas kernel in interpret
mode, and the port's ``QuantJOps``/``MixedQuantJOps`` serving against the
reference's backends, with the backend precedence and the certificate-set
resolution of ``launch/serve.py``. (The CUDA kernel itself is held against
its plain version on a card by tests/test_torch_kernels_cuda.py and
chip_smoke.py.)

Tolerances. GEMM: equal, or apart by at most one ulp at k plus
2·√K·2⁻²⁴·(|q_k(x)|@|q_k(w)|) — what two f32 sums of the same K terms
differ by when they add in another order (their rounding errors have random
signs). On exact-sum operands (every partial sum an exact f32), and where
NaN, ±inf or near-f32-max inputs decide the result, the two are equal bit
for bit. Serving: as in tests/test_torch_serve.py for the format path —
tokens equal (a mismatch reports the top-1 gap), logits within 1e-3 — and
cache entries within one ulp at the smallest attention k, u = 2^(1-k), of
themselves plus u·max|cache| (rope mixes two rounded values, which may
cancel).
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.certify as jcertify
from repro.certify import spec as jspec
from repro.kernels import ops as jops
from repro.kernels import quant_matmul as jqm
from repro.kernels import ref as jref
from repro.launch import serve as jserve
from repro.launch.batching import make_backend
from repro_torch.certify import spec as tspec
from repro_torch.core.backend import TorchOps
from repro_torch.core.quantize import _quantize_normal
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.launch import serve as tserve
from _torch_serve_parity import both_params, check_steps, run_both

KS = [2, 8, 12, 23, 24]
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "v1_certificate_set.json")


def _ulp_at_k(a, k):
    _, e = np.frexp(np.abs(a))
    return np.ldexp(1.0, np.maximum(e - 1, -126) - (k - 1))


def assert_k_rule(got, want, k, pre_tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    diff = np.abs(got - want)
    ulp = _ulp_at_k(np.maximum(np.abs(got), np.abs(want)), k)
    bad = ~((got == want) | (diff <= ulp + pre_tol))
    assert not bad.any(), (int(bad.sum()), float(diff.max()))


def assert_same_bits(got, want):
    """Equal bit for bit, except that any NaN equals any NaN."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


def _pre_tol(x, w, k):
    q = lambda a: np.abs(_quantize_normal(torch.from_numpy(a), k)
                         .double().numpy())
    return 2 * np.sqrt(x.shape[1]) * 2.0 ** -24 * (q(x) @ q(w))


def _random(M, K, N, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(M, K).astype(np.float32),
            (rng.randn(K, N) / np.sqrt(K)).astype(np.float32))


def _coarse(M, K, N, seed):
    """Integers in [-3, 3] times 2^-2 resp. 2^-3: two mantissa bits, and
    every partial sum of their products is an exact f32."""
    rng = np.random.RandomState(seed)
    return ((rng.randint(-3, 4, (M, K)) * 2.0 ** -2).astype(np.float32),
            (rng.randint(-3, 4, (K, N)) * 2.0 ** -3).astype(np.float32))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("shape", [(4, 64, 32), (7, 96, 40)])
def test_quant_matmul_ref_vs_jax_oracle_and_pallas(k, shape):
    M, K, N = shape
    x, w = _random(M, K, N, seed=M + K + N + k)
    got = tqm.quant_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                               k).numpy()
    oracle = np.asarray(jref.quant_matmul_ref(jnp.asarray(x),
                                              jnp.asarray(w), k))
    pallas = np.asarray(jops.quant_matmul_emulated(
        jnp.asarray(x), jnp.asarray(w), k=k, block_k=K, interpret=True))
    pre = _pre_tol(x, w, k)
    assert_k_rule(oracle, got, k, pre)
    assert_k_rule(pallas, got, k, pre)


@pytest.mark.parametrize("k", KS)
def test_quant_matmul_dynamic_k_vs_jax_on_batched_input(k):
    x, w = _random(6, 48, 24, seed=k)
    x3 = x.reshape(2, 3, 48)
    tqm.quant_matmul.launches = 0
    got = tqm.quant_matmul_dynamic_k(torch.from_numpy(x3),
                                     torch.from_numpy(w), k)
    assert got.shape == (2, 3, 24)
    assert tqm.quant_matmul.launches == 0          # the plain version
    want = np.asarray(jqm.quant_matmul_dynamic_k(jnp.asarray(x3),
                                                 jnp.asarray(w),
                                                 jnp.int32(k)))
    assert_k_rule(want.reshape(6, 24), got.reshape(6, 24).numpy(), k,
                  _pre_tol(x, w, k))
    assert torch.equal(got.reshape(6, 24), tqm.quant_matmul_ref(
        torch.from_numpy(x), torch.from_numpy(w), k))


@pytest.mark.parametrize("k", KS)
def test_quant_matmul_exact_sums_and_nonfinite_bit_for_bit(k):
    x, w = _coarse(9, 64, 40, seed=k)
    big = np.float32(3.4028234663852886e38)
    x[0, 3] = np.nan
    x[1, 5] = np.inf
    x[2, 7] = -np.inf
    x[3, 0] = big                  # carries into inf at k < 24
    x[4, 1] = -big
    x[5, 2] = np.float32(3.3e38)
    x[6, 9] = np.float32(-1.5e38)
    # weights of ±1/8, ±1/4 or 0 against the near-max inputs keep their
    # products exact, so no tie can be broken by the order of the sum
    w[[0, 1, 2, 9]] = np.clip(w[[0, 1, 2, 9]], -0.25, 0.25)
    got = tqm.quant_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                               k).numpy()
    for want in (jref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(w), k),
                 jqm.quant_matmul_dynamic_k(jnp.asarray(x), jnp.asarray(w),
                                            jnp.int32(k)),
                 jops.quant_matmul_emulated(jnp.asarray(x), jnp.asarray(w),
                                            k=k, block_k=64,
                                            interpret=True)):
        assert_same_bits(got, np.asarray(want))
    assert np.isnan(got[0]).all()
    if k < 24:
        assert not np.isfinite(got[3]).any()       # +max rounded to +inf


# ---------------------------------------------------------------------------
# serving: QuantJOps / MixedQuantJOps against the reference's backends
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    return both_params()


SERVE_CASES = {
    # tests/test_serving_engine.py: uniform k, and a per-layer map with a
    # sub-layer key over precision_k = 12
    "uniform_k12": dict(precision_k=12),
    "uniform_k11": dict(precision_k=11),
    "mixed_layer0_layer1mlp": dict(
        precision_k=12,
        precision_layer_k={"layer0": 9, "layer1/mlp": 10}),
    # tests/test_stacked.py: layer and sub-layer keys over a default of 20
    "mixed_sublayer": dict(
        precision_k=20,
        precision_layer_k={"layer0": 16, "layer0/attn": 11, "layer1": 14,
                           "layer1/mlp": 10, "head": 9}),
    "mixed_wildcard": dict(
        precision_k=16,
        precision_layer_k={"layer*/attn": 12, "layer*/mlp": 10,
                           "layer0/mlp": 14}),
}


def _attn_k_min(sc, bk):
    if sc.precision_layer_k is None:
        return sc.precision_k
    return min(bk.k_for([f"layer{i}", "attn"]) for i in range(2))


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_k_serving_matches_jax_backends(params, case):
    sc = jserve.ServeConfig(arch="qwen2_7b", batch=2, max_seq=32,
                            **SERVE_CASES[case])
    jbk = make_backend(sc, unrolled=True)
    tbk = tserve._backend(tserve.ServeConfig(**SERVE_CASES[case]))
    want = (tserve.MixedQuantJOps if "precision_layer_k" in SERVE_CASES[case]
            else tserve.QuantJOps)
    assert type(tbk) is want
    k_attn = _attn_k_min(sc, tbk)

    def cache_tol(got, want):
        # rope mixes two rounded projections (x1·cos - x2·sin), so where
        # they cancel a one-ulp change is large relative to the result:
        # bound it by one ulp of the largest cache value as well
        u = 2.0 ** (1 - k_attn)
        np.testing.assert_allclose(got, want, rtol=u,
                                   atol=u * float(np.abs(want).max()))

    check_steps(run_both(jbk, tbk, params), 1e-3, cache_tol)


def test_k_backend_really_rounds(params):
    """Uniform k=8 changes the arithmetic, and k=24 on the f32 carrier
    rounds nothing: it equals plain TorchOps bit for bit."""
    _, tp = params
    from repro_torch import configs
    from repro_torch.models import transformer as TT
    cfg = configs.get("qwen2_7b").SMOKE
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab,
                                                             (1, 8)))
    plain, _ = TT.forward(TorchOps(), tp, cfg, toks)
    k8, _ = TT.forward(tserve.QuantJOps(8), tp, cfg, toks)
    k24, _ = TT.forward(tserve.QuantJOps(24), tp, cfg, toks)
    assert not torch.equal(plain, k8)
    assert torch.equal(plain, k24)


def _paths():
    out = [[], ["embed"], ["head"]]
    for i in range(3):
        for sub in ([], ["attn"], ["mlp"]):
            out.append([f"layer{i}", *sub])
    return out


@pytest.mark.parametrize("case", sorted(k for k in SERVE_CASES
                                        if "precision_layer_k" in
                                        SERVE_CASES[k]))
def test_mixed_scope_resolution_matches_reference(case):
    c = SERVE_CASES[case]
    jbk = make_backend(jserve.ServeConfig(arch="qwen2_7b", **c),
                       unrolled=True)
    tbk = tserve.MixedQuantJOps(c["precision_layer_k"], c["precision_k"])
    for path in _paths():
        assert tbk.k_for(path) == int(jbk._lane_static(path)), path


def test_backend_precedence_and_guards():
    fmt = {"": {"k": 11, "emax": 15, "emin": -14}}
    lk = {"layer0": 9}
    S = tserve.ServeConfig
    assert type(tserve._backend(S())) is TorchOps
    assert type(tserve._backend(S(precision_k=12))) is tserve.QuantJOps
    assert type(tserve._backend(S(precision_k=12, precision_layer_k=lk))
                ) is tserve.MixedQuantJOps
    for sc in (S(precision_layer_format=fmt, precision_k=12),
               S(precision_layer_format=fmt, precision_k=12,
                 precision_layer_k=lk),
               S(precision_layer_format=fmt)):
        assert type(tserve._backend(sc)) is tserve.FormatQuantJOps
    with pytest.raises(ValueError, match="needs precision_k"):
        tserve._backend(S(precision_layer_k=lk))
    # the reference's order on the same configs
    port_of = {"JOps": "TorchOps"}
    for kw in ({}, {"precision_k": 12},
               {"precision_k": 12, "precision_layer_k": lk},
               {"precision_layer_format": fmt, "precision_k": 12,
                "precision_layer_k": lk}):
        jname = type(jserve._backend(jserve.ServeConfig(**kw))).__name__
        assert (type(tserve._backend(S(**kw))).__name__
                == port_of.get(jname, jname))


def test_monitors_are_refused_not_ignored():
    """The three certified backends carry a violation monitor (as the
    reference's do); the plain backend refuses one with the reference's
    ValueError instead of ignoring it."""
    S = tserve.ServeConfig
    mon = object()
    for sc in (S(precision_k=12),
               S(precision_k=12, precision_layer_k={"layer0": 9}),
               S(precision_layer_format={"": {"k": 11, "emax": 15,
                                              "emin": -14}})):
        assert tserve._backend(sc, monitor=mon).monitor is mon
        assert tserve._backend(sc).monitor is None
    with pytest.raises(ValueError, match="certified quantised backend"):
        tserve._backend(S(), monitor=mon)
    with pytest.raises(ValueError, match="certified quantised backend"):
        jserve._backend(jserve.ServeConfig(), monitor=mon)


# ---------------------------------------------------------------------------
# --certificate-set: v1 / v2 / v3 sets resolved as apply_certificates does
# ---------------------------------------------------------------------------

def _v1_set_json():
    with open(FIXTURE) as fh:
        return json.dumps(json.load(fh)["certificate_set"])


def _cert(class_key, required_k, layer_k=None, layer_format=None):
    return {"model_id": "qwen2-smoke", "params_digest": "ab" * 32,
            "class_key": class_key, "cfg": {}, "bounds_u_max": 2.0 ** -9,
            "final_abs_u": 3.0, "final_rel_u": 4.0,
            "required_k": required_k, "satisfied_by": [],
            "schema_version": 3, "layer_k": layer_k,
            "layer_format": layer_format}


def _set_json(*certs):
    return json.dumps({"schema_version": 3, "model_id": "qwen2-smoke",
                       "params_digest": "ab" * 32,
                       "certificates": list(certs)})


FMT = {"k": 16, "emax": 31, "emin": -30, "has_subnormals": True,
       "saturating": True, "name": "f"}
SETS = {
    "v1_fixture": _v1_set_json(),
    "v2_mixed": _set_json(
        _cert("p0", 12, {"layer0": 9, "layer1/mlp": 10}),
        _cert("p1", 11, {"layer0": 10, "layer1": 8})),
    "v3_format": _set_json(_cert("p0", 12, {"layer0": 9},
                                 {"": FMT, "layer0": dict(FMT, k=10)})),
    "v3_format_only": _set_json(_cert("p0", None, None,
                                      {"": FMT, "layer1": dict(FMT, k=9)})),
}


def _jax_apply(js, monkeypatch):
    monkeypatch.setattr(jcertify, "serving_certificate",
                        lambda *a, **k: jspec.CertificateSet.from_json(js))
    sc, _ = jserve.apply_certificates(
        jserve.ServeConfig(arch="qwen2_7b", certificates="unused"),
        None, None)
    return sc


@pytest.mark.parametrize("name", sorted(SETS))
def test_certificate_set_resolves_as_apply_certificates(name, tmp_path,
                                                        monkeypatch):
    js = SETS[name]
    want = _jax_apply(js, monkeypatch)
    path = tmp_path / "set.json"
    path.write_text(js)
    res = tserve.main(["--device", "cpu", "--batch", "1", "--prefill-len",
                       "4", "--decode-steps", "2", "--certificate-set",
                       str(path)])
    got = res.config
    assert got.precision_k == want.precision_k
    assert got.precision_layer_k == want.precision_layer_k
    assert got.precision_layer_format == want.precision_layer_format
    assert (type(tserve._backend(got)).__name__
            == type(jserve._backend(want)).__name__)
    cs = tspec.CertificateSet.from_json(js)
    bars = res.responses[0]["certificate"]
    assert bars["k"] == cs.serving_k
    assert bars["params_digest"] == cs.params_digest
    assert len(res.responses[0]["tokens"]) == 3


def test_certificate_set_without_precision_raises_and_flags_conflict(
        tmp_path):
    path = tmp_path / "set.json"
    path.write_text(_set_json(_cert("p0", None)))
    with pytest.raises(RuntimeError, match="no certifiable precision"):
        tserve.main(["--device", "cpu", "--certificate-set", str(path)])
    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu", "--certificate-set", str(path),
                     "--precision-k", "12"])


def test_cli_precision_k_serves_quant_backend():
    res = tserve.main(["--device", "cpu", "--batch", "2", "--prefill-len",
                       "5", "--decode-steps", "3", "--precision-k", "12"])
    assert res.config.precision_k == 12
    assert type(tserve._backend(res.config)) is tserve.QuantJOps
    assert res.tokens.shape == (2, 4)
    assert torch.isfinite(res.prefill_logits).all()
