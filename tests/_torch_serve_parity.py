"""The serve-parity harness shared by the port's serving tests: the SMOKE
Qwen2 config of both packages, the reference's parameters carried across
through numpy, and a greedy prefill + decode loop run through a JAX backend
and a port backend side by side, with the per-step checks."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT

JCFG = jconfigs.get("qwen2_7b").SMOKE
TCFG = tconfigs.get("qwen2_7b").SMOKE
B, PROMPT, STEPS = 2, 8, 8
MAX_SEQ = PROMPT + STEPS + 1


def both_params():
    """The reference's SMOKE parameters (JAX ``init_params``, key 0) and
    the same numbers as port tensors on the CPU."""
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jp, tp


def run_both(jbk, tbk, params):
    """Prefill + STEPS decode steps through both packages, greedy, each on
    its own tokens. Yields per-step (j_logits, t_logits, j_cache, t_cache)."""
    jp, tp = params
    toks = np.random.RandomState(0).randint(0, JCFG.vocab, (B, PROMPT))
    # jitted as the reference's serve jits it (the position is traced)
    jstep = jax.jit(lambda p, c, t, pos: JT.forward(jbk, p, JCFG, t,
                                                    cache=c, q_offset=pos))
    jc = JT.init_cache(JCFG, B, MAX_SEQ, jnp.float32)
    tc = TT.init_cache(TCFG, B, MAX_SEQ, device="cpu")
    jl, jc = jstep(jp, jc, jnp.asarray(toks), jnp.int32(0))
    with torch.no_grad():
        tl, tc = tserve.prefill_step(tbk, tp, TCFG, tc,
                                     torch.from_numpy(toks))
    # the port writes its cache in place: keep a copy per step
    snap = lambda c: {k: v.clone() for k, v in c.items()}
    out = [(np.asarray(jl[:, -1]), tl[:, -1].numpy(), jc, snap(tc))]
    jt = jnp.argmax(jl[:, -1], -1)
    tt = torch.argmax(tl[:, -1], -1)
    for i in range(STEPS):
        jl, jc = jstep(jp, jc, jt[:, None], jnp.int32(PROMPT + i))
        with torch.no_grad():
            tt, tlast, tc = tserve.decode_step(tbk, tp, TCFG, tc,
                                               tt[:, None], PROMPT + i)
        jt = jnp.argmax(jl[:, -1], -1)
        out.append((np.asarray(jl[:, -1]), tlast.numpy(), jc, snap(tc)))
    return out


def top1_gap(logits):
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def check_steps(steps, logit_atol, cache_tol):
    for i, (jl, tl, jc, tc) in enumerate(steps):
        jtok, ttok = jl.argmax(-1), tl.argmax(-1)
        assert np.array_equal(jtok, ttok), (
            f"step {i}: tokens {jtok} vs {ttok}; top-1 gap "
            f"{top1_gap(jl)}")
        np.testing.assert_allclose(tl, jl, rtol=0, atol=logit_atol)
        assert np.array_equal(np.asarray(jc["idx"]), tc["idx"].numpy())
        for name in ("k", "v"):
            want = np.asarray(jc[name])
            got = tc[name].numpy()
            assert got.shape == want.shape == (
                JCFG.n_layers, B, MAX_SEQ, JCFG.n_kv_heads, JCFG.head_dim)
            cache_tol(got, want)
