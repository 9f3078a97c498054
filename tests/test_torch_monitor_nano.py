"""The nano LM's own certificate under a violation monitor, in both packages.

The 2-layer nano LM of ``tests/test_stacked.py`` (trained in JAX, carried
across through numpy) is certified once with formats by the port
(``certify_lm(..., formats=True)``, k_max 53; the two packages' LM
certificates are held equal in ``tests/test_torch_certify_lm.py``), and that
v3 set is served on its own certification profile — the tokens it was
certified on, then greedy decode steps — through the reference's
``build_serve_steps(..., monitor=...)`` and the port's ``_backend(sc,
monitor)``, each with a monitor built from the set. The counters are equal,
and so are the labels whose margins are recorded. On its certification
profile the monitor stays silent in both packages: every observed product
lies inside the certified enclosures (which fold to ``layer*``: the
serving body observes every layer under the stacked scope).
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.certify import spec as jspec
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro_torch import certify as tcertify
from repro_torch.certify import spec as tspec
from repro_torch.certify.tokens import profile_tokens
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.obs.monitors import ViolationMonitor
from _torch_nano import PROFILE, trained_nano

STEPS = 3


@pytest.fixture(scope="module")
def nano_set():
    nano = trained_nano()
    _, _, tcfg, tp = nano
    ts = tcertify.certify_lm("qwen2_7b", tcfg, tp, **PROFILE, k_max=53,
                             formats=True)
    assert ts.serving_layer_format is not None
    return nano, ts.to_json()


def _jax_run(jcfg, jp, cs, toks):
    mon = jobs.ViolationMonitor.from_certificate_set(cs)
    B, S = toks.shape
    sc = jserve.ServeConfig(arch="qwen2_7b", batch=B, max_seq=S + STEPS + 1,
                            prefill_len=S, precision_k=cs.serving_k,
                            precision_layer_k=cs.serving_layer_k,
                            precision_layer_format=cs.serving_layer_format)
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)
    with mesh:
        prefill, decode, _ = jserve.build_serve_steps(jcfg, sc, mesh,
                                                      monitor=mon)
        cache = JT.init_cache(jcfg, B, sc.max_seq, jnp.float32)
        logits, cache = prefill(jp, cache, {"tokens": jnp.asarray(toks)})
        tok = jnp.argmax(logits[:, -1, :], axis=-1)
        out = [np.asarray(tok)]
        for i in range(STEPS):
            tok, cache = decode(jp, cache, {
                "tokens": tok[:, None], "pos": jnp.asarray(S + i, jnp.int32)})
            out.append(np.asarray(tok))
    jax.effects_barrier()
    return np.stack(out, 1), mon.summary()


def _port_run(tcfg, tp, cs, toks):
    mon = ViolationMonitor.from_certificate_set(cs)
    sc = tserve.apply_certificate_set(tserve.ServeConfig(), cs)
    bk = tserve._backend(sc, mon)
    B, S = toks.shape
    cache = TT.init_cache(tcfg, B, S + STEPS + 1, device="cpu")
    with torch.no_grad():
        logits, cache = tserve.prefill_step(bk, tp, tcfg, cache,
                                            torch.from_numpy(toks))
        mon.flush()
        tok = torch.argmax(logits[:, -1], -1)
        out = [tok]
        for i in range(STEPS):
            tok, _, cache = tserve.decode_step(bk, tp, tcfg, cache,
                                               tok[:, None], S + i)
            mon.flush()
            out.append(tok)
    return torch.stack(out, 1).numpy(), mon.summary()


def test_nano_certificate_monitored_on_its_profile(nano_set):
    (jcfg, jp, tcfg, tp), set_json = nano_set
    js = jspec.CertificateSet.from_json(set_json)
    ts = tspec.CertificateSet.from_json(set_json)
    toks = profile_tokens(PROFILE["seed"], PROFILE["batch"], PROFILE["seq"],
                          tcfg.vocab).numpy()
    jtoks, jsum = _jax_run(jcfg, jp, js, toks)
    ttoks, tsum = _port_run(tcfg, tp, ts, toks)
    assert np.array_equal(ttoks, jtoks)
    assert tsum["counters"]["obs.scope_observations"] == (
        7 * tcfg.n_layers * (1 + STEPS))
    assert tsum["counters"] == jsum["counters"]
    assert set(tsum["scope_margin_log2"]) == set(jsum["scope_margin_log2"])
    assert set(tsum["scope_margin_log2"]) == {"layer*/attn", "layer*/mlp"}
    # silent on its own certification profile, in both packages
    assert tsum["violations"] == jsum["violations"] == 0
    assert all(m > 0 for m in tsum["scope_margin_log2"].values())
