"""Monitored certified serving against the JAX package's, on the CPU.

The same SMOKE params (the reference's, carried across through numpy), the
same prompts and the same certificate set go through the reference's
``build_serve_steps(..., monitor=...)`` (its scanned serving body, whose
health stats reach the host through ``jax.debug.callback``) and the port's
``_backend(sc, monitor)`` with ``prefill_step`` / ``decode_step`` and one
``monitor.flush()`` a step — for the v3 format map, a v2 per-layer k map
and a uniform k. Held:

* the counters are equal, and so are the ``scope_margin_log2`` labels
  (``layer*/attn``, ``layer*/mlp``: the reference observes under its
  stacked scope, the port under the concrete path with the layer segment
  replaced);
* each margin agrees within two ulps at the scope's k, in log2 (one ulp at
  k plus the GEMM rule, whose sum-order part is below 2⁻¹⁶ relative at
  these widths); on the uniform path both packages observe the product
  before its final rounding, at k = 8, 10 and 12;
* at k = 8 and 10 an envelope planted between a label's largest
  unrounded product and its rounding to k (which the monitor's slack of
  1 + 2⁻¹⁰ does not cover below k = 11) gives the reference's counts in
  the port too: the port observes the unrounded product as well;
* the monitored logits equal the unmonitored ones bit for bit;
* a shrunk ``layer*/mlp`` envelope fires in both packages, with the same
  counts, and so do one layer's ``mlp`` weights scaled by 1000 (scaled
  embeddings would not: the rmsnorm undoes them).

The plain backend's refusal of a monitor is held in
``tests/test_torch_quant_k.py``.
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.certify import spec as jspec
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro_torch.certify import spec as tspec
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.obs.monitors import ViolationMonitor
from _torch_serve_parity import JCFG, TCFG, both_params

B, PROMPT, STEPS = 2, 8, 3
MAX_SEQ = PROMPT + STEPS + 1
FMT = {"has_subnormals": True, "saturating": True, "name": "f"}
LAYER_FORMAT = {
    "": dict(FMT, k=12, emax=15, emin=-14),
    "layer*/mlp": dict(FMT, k=10, emax=15, emin=-14),
    "layer0/mlp": dict(FMT, k=16, emax=31, emin=-30),
}
# wide enough that nothing fires, finite so that every label has a margin
RANGES = {"layer0/attn": {"max_abs": 400.0}, "layer1/attn": {"max_abs": 600.0},
          "layer0/mlp": {"max_abs": 500.0}, "layer1/mlp": {"max_abs": 300.0}}
CASES = {
    "format_map": dict(k=12, layer_format=LAYER_FORMAT),
    "k_map": dict(k=16, layer_k={"layer*/attn": 12, "layer*/mlp": 10,
                                 "layer0/mlp": 14}),
    "uniform_k": dict(k=12),
    "uniform_k8": dict(k=8),
    "uniform_k10": dict(k=10),
}


def set_json(case, ranges=RANGES):
    c = CASES[case]
    cert = {"model_id": "qwen2-smoke", "params_digest": "ab" * 32,
            "class_key": "p0", "cfg": {}, "bounds_u_max": 2.0 ** (1 - c["k"]),
            "final_abs_u": 5.0e4, "final_rel_u": 1.0e5, "required_k": c["k"],
            "satisfied_by": [], "schema_version": 3,
            "layer_k": c.get("layer_k"),
            "layer_format": c.get("layer_format")}
    return json.dumps({
        "schema_version": 3, "model_id": "qwen2-smoke",
        "params_digest": "ab" * 32, "certificates": [cert],
        "meta": {"formats": {"applied": True, "scope_ranges": ranges}}})


def _sc(mod, cs, **kw):
    return mod.ServeConfig(arch="qwen2_7b", precision_k=cs.serving_k,
                           precision_layer_k=cs.serving_layer_k,
                           precision_layer_format=cs.serving_layer_format,
                           **kw)


def _prompt():
    return np.random.RandomState(0).randint(0, JCFG.vocab, (B, PROMPT))


class JaxServer:
    """The reference's jitted serving steps with one monitor attached; the
    monitor is reset in place between runs, so one compile serves them."""

    def __init__(self, case):
        self.cs = jspec.CertificateSet.from_json(set_json(case))
        self.mon = jobs.ViolationMonitor.from_certificate_set(self.cs)
        # the reference's host mesh with Auto axes: under this JAX,
        # jax.make_mesh defaults to Explicit axes, which the serving
        # shardings of build_serve_steps do not satisfy
        self.mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(
            jax.sharding.AxisType.Auto,) * 2)
        sc = _sc(jserve, self.cs, batch=B, max_seq=MAX_SEQ,
                 prefill_len=PROMPT)
        with self.mesh:
            self.prefill, self.decode, _ = jserve.build_serve_steps(
                JCFG, sc, self.mesh, monitor=self.mon)

    def run(self, params, envelopes=None):
        m = self.mon
        m.__init__(envelopes or jobs.ViolationMonitor.from_certificate_set(
            self.cs).envelopes, dbar_u=m.dbar_u, u=m.u, slack=m.slack)
        with self.mesh:
            cache = JT.init_cache(JCFG, B, MAX_SEQ, jnp.float32)
            logits, cache = self.prefill(params, cache,
                                         {"tokens": jnp.asarray(_prompt())})
            tok = jnp.argmax(logits[:, -1, :], axis=-1)
            toks = [np.asarray(tok)]
            for i in range(STEPS):
                tok, cache = self.decode(params, cache, {
                    "tokens": tok[:, None],
                    "pos": jnp.asarray(PROMPT + i, jnp.int32)})
                toks.append(np.asarray(tok))
        jax.effects_barrier()
        return np.stack(toks, 1), m.summary()


def port_run(case, params, monitored=True, envelopes=None):
    cs = tspec.CertificateSet.from_json(set_json(case))
    mon = None
    if monitored:
        mon = ViolationMonitor.from_certificate_set(cs)
        if envelopes is not None:
            mon.envelopes = dict(envelopes)
    bk = tserve._backend(_sc(tserve, cs), mon)
    cache = TT.init_cache(TCFG, B, MAX_SEQ, device="cpu")
    logits = []
    with torch.no_grad():
        last, cache = tserve.prefill_step(bk, params, TCFG, cache,
                                          torch.from_numpy(_prompt()))
        tok = torch.argmax(last[:, -1], -1)
        toks, pending = [tok], []
        logits.append(last[:, -1])
        for i in range(STEPS + 1):
            if mon is not None:
                pending.append(mon.pending)
                mon.flush()
            if i == STEPS:
                break
            tok, last, cache = tserve.decode_step(bk, params, TCFG, cache,
                                                  tok[:, None], PROMPT + i)
            toks.append(tok)
            logits.append(last)
    if mon is not None:
        assert pending == [7 * TCFG.n_layers] * (STEPS + 1)
    return (torch.stack(toks, 1).numpy(), torch.stack(logits),
            None if mon is None else mon.summary())


def _k_of(case, label):
    c = CASES[case]
    if "layer_format" in c:
        ks = [f["k"] for s, f in c["layer_format"].items()
              if s == "" or s.endswith(label.split("/")[-1])]
        return min(ks)
    return min([c["k"]] + [v for s, v in c.get("layer_k", {}).items()
                           if s.endswith(label.split("/")[-1])])


def assert_same_monitoring(case, tsum, jsum):
    assert tsum["counters"] == jsum["counters"]
    assert tsum["violations"] == jsum["violations"]
    assert set(tsum["scope_margin_log2"]) == set(jsum["scope_margin_log2"])
    for label, tm in tsum["scope_margin_log2"].items():
        jm = jsum["scope_margin_log2"][label]
        tol = math.log2(1 + 2.0 ** (2 - _k_of(case, label)))
        assert abs(tm - jm) <= tol, (label, tm, jm, tol)


@pytest.fixture(scope="module")
def params():
    return both_params()


@pytest.mark.parametrize("case", sorted(CASES))
def test_monitored_serving_matches_the_reference(params, case):
    jp, tp = params
    server = JaxServer(case)
    jtoks, jsum = server.run(jp)
    ttoks, tlogits, tsum = port_run(case, tp)
    assert np.array_equal(ttoks, jtoks)
    n_obs = 7 * TCFG.n_layers * (1 + STEPS)
    assert tsum["counters"]["obs.scope_observations"] == n_obs
    assert set(tsum["scope_margin_log2"]) == {"layer*/attn", "layer*/mlp"}
    assert tsum["violations"] == 0
    assert_same_monitoring(case, tsum, jsum)
    _, plain_logits, _ = port_run(case, tp, monitored=False)
    assert torch.equal(tlogits, plain_logits)

    # a shrunk layer*/mlp envelope fires in both, and only that label
    shrunk = dict(ViolationMonitor.from_certificate_set(
        tspec.CertificateSet.from_json(set_json(case))).envelopes)
    shrunk["layer*/mlp"] = {"max_abs": 1e-3}
    jtoks, jsum = server.run(jp, envelopes=shrunk)
    _, _, tsum = port_run(case, tp, envelopes=shrunk)
    assert tsum["counters"]["obs.enclosure_violations"] > 0
    assert [lb for lb, m in tsum["scope_margin_log2"].items() if m < 0] == [
        "layer*/mlp"]
    assert_same_monitoring(case, tsum, jsum)

    # one layer's mlp weights scaled by 1000 fire in both, as well
    scale = lambda p, f: {**p, "layers": {**p["layers"], "mlp": {
        **p["layers"]["mlp"],
        "w_down": f(p["layers"]["mlp"]["w_down"])}}}
    jp2 = scale(jp, lambda w: w.at[1].multiply(1000.0))
    tp2 = scale(tp, lambda w: torch.cat([w[:1], w[1:] * 1000.0]))
    jtoks, jsum = server.run(jp2)
    ttoks, _, tsum = port_run(case, tp2)
    assert tsum["counters"]["obs.enclosure_violations"] > 0
    if np.array_equal(ttoks, jtoks):
        assert_same_monitoring(case, tsum, jsum)
    else:
        assert jsum["counters"]["obs.enclosure_violations"] > 0



@pytest.mark.parametrize("k", [8, 10, 12])
def test_uniform_k_envelope_between_unrounded_and_rounded(k):
    """Both packages' ``QuantJOps`` under one envelope set, on products
    whose rounding to k moves them across it: under ``layer*/attn``,
    1 + 2^-(k+1) (rounded: 1) against an envelope whose slack-widened value
    lies between the two; under ``layer*/mlp``, (2 - 2^-k)·2^127, above
    the format's largest finite value (rounded: +inf). The reference
    observes the products before their final rounding, and the port's
    counts (violations, overflow, underflow, non-finite) equal its: two
    violations, one overflow, nothing non-finite. Observing the rounded
    products would have given one violation, no overflow and one
    non-finite value. The served bits are the unmonitored ones."""
    tiny = 2.0 ** -(k + 1)
    mats = {"attn": ([[1.0, tiny]], [[1.0], [1.0]]),
            "mlp": ([[1.5, 0.5 * (1.0 - 2.0 ** (1 - k))]],
                    [[2.0 ** 127], [2.0 ** 127]])}
    u, r = 1.0 + tiny, 1.0
    slack = jobs.ViolationMonitor({}).slack
    env = {"layer*/attn": {"max_abs": math.sqrt(u * r) / slack},
           "layer*/mlp": {"max_abs": 1.0e38}}

    def drive(bk, asarray):
        outs = []
        for sub, (x, w) in mats.items():
            with bk.scope("layer*"), bk.scope(sub):
                outs.append(bk.matmul(asarray(x), asarray(w)))
        return outs

    jm = jobs.ViolationMonitor(env)
    jbk = jserve.QuantJOps(k)
    jbk.monitor = jm
    drive(jbk, lambda a: jnp.asarray(a, jnp.float32))
    jax.effects_barrier()
    tm = ViolationMonitor(env)
    tbk = tserve.QuantJOps(k)
    tbk.monitor = tm
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    outs = drive(tbk, f32)
    assert tm.flush() == 2
    assert tm.summary()["counters"] == jm.summary()["counters"]
    c = tm.summary()["counters"]
    assert (c["obs.enclosure_violations"], c["obs.overflow_events"],
            c["obs.underflow_events"], c["obs.nonfinite_events"]) == (
                2, 1, 0, 0)
    plain = drive(tserve.QuantJOps(k), f32)
    for a, b in zip(outs, plain):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert float(outs[0][0, 0]) == r and math.isinf(float(outs[1][0, 0]))
