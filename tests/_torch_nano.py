"""The nano LM of ``tests/test_stacked.py`` (2 layers, d 16, 2 heads of 8,
d_ff 32, vocab 256), trained in JAX as that fixture trains it and carried
across to the port through numpy; and the comparison of two LM certificate
sets the port's LM certification tests share.

δ̄ agrees within 1e-6 relative, not 1e-9: the f64 products of the two
packages add in other orders, and the CAA rules carry that through two
layers and the head (the rule of ``tests/test_torch_ranges.py``; the
uniform bounds are within 8e-10, the mixed ones within 2e-8). ε̄ agrees
within 1e-4: the relative bound of a logit divides by its enclosure's
endpoint nearest 0, which the two packages' sums reach through
cancellation (the mixed certificate's ε̄ is 1.8e-5 apart), and no LM
decision reads it (the argmax rule is 2·δ̄·u < gap)."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jconfigs
from repro.core.backend import JOps
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy

LM_RTOL = 1e-6
LM_EBAR_RTOL = 1e-4
PROFILE = dict(seq=6, batch=2, seed=0)


def nano_config(configs):
    return dataclasses.replace(
        configs.get("qwen2_7b").SMOKE, name="qwen2-nano", n_layers=2,
        d_model=16, n_heads=2, n_kv_heads=2, d_head=8, d_ff=32, vocab=256)


def trained_nano():
    """(JAX config, JAX params, port config, port params) of the nano LM
    overfit to its profile (``tests/test_stacked.py``'s ``_train_nano``)."""
    cfg = nano_config(jconfigs)
    bk = JOps()
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.RandomState(0)
    tokens = jnp.asarray(rng.randint(0, cfg.vocab, (2, 6)))
    targets = jnp.roll(tokens, -1, axis=1)

    @jax.jit
    def step(p):
        loss, g = jax.value_and_grad(
            lambda pp: JT.next_token_loss(bk, pp, cfg, tokens, targets))(p)
        return loss, jax.tree_util.tree_map(lambda a, b: a - 0.5 * b, p, g)

    for _ in range(200):
        loss, params = step(params)
    assert float(loss) < 0.1
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return cfg, params, nano_config(tconfigs), tp


def certify_both(jcertify, tcertify, nano, roots, **kw):
    """The same LM request through both packages, each into its store."""
    jcfg, jp, tcfg, tp = nano
    js = jcertify.certify_lm("qwen2_7b", jcfg, jp, **PROFILE, **kw,
                             store=jcertify.CertificateStore(roots[0]))
    ts = tcertify.certify_lm("qwen2_7b", tcfg, tp, **PROFILE, **kw,
                             store=tcertify.CertificateStore(roots[1]))
    return js, ts, roots, kw


def close(a, b, rel=LM_RTOL):
    return a == b or (math.isfinite(a) and math.isfinite(b)
                      and abs(a - b) <= rel * max(abs(a), abs(b)))


def same_lm_sets(js, ts):
    assert len(js.certificates) == len(ts.certificates)
    for a, b in zip(js.certificates, ts.certificates):
        assert a.class_key == b.class_key
        assert a.required_k == b.required_k
        assert a.satisfied_by == b.satisfied_by
        assert a.layer_k == b.layer_k
        assert a.layer_format == b.layer_format
        assert a.meta.get("map_provenance") == b.meta.get("map_provenance")
        assert a.meta.get("sample_next_tokens") == \
            b.meta.get("sample_next_tokens")
        assert close(a.final_abs_u, b.final_abs_u), (a.final_abs_u,
                                                     b.final_abs_u)
        assert close(a.final_rel_u, b.final_rel_u, LM_EBAR_RTOL), (
            a.final_rel_u, b.final_rel_u)
    assert js.meta["probes"] == ts.meta["probes"]
