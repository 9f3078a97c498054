"""The port's optimizers (``repro_torch.optim``) against the JAX package's,
on the CPU.

* AdamW on the reference's own gradients (its ``next_token_loss`` on
  Qwen2-7B's SMOKE config cut to 2 layers, seq 16, batch 2, five steps of
  its own trajectory), in the f32 and the 8-bit mode:
  - with the gradient clip off (``grad_clip`` 1e30: the clip factor is
    exactly 1 in both) every parameter, moment, 8-bit payload and scale is
    bit for bit the reference's: the same f32 operations in the same
    order;
  - with the default clip (1.0, active) the clip factor c is 1 / ‖g‖,
    and the two packages sum ‖g‖² in other orders, so the two c differ by
    a relative δ_t of a few ulps (both are computed here). Each moment
    is then held to the bound its recursion carries: for m,
    E_t = 0.9·E_(t-1) + δ_t·0.1·|g_t·c_t| + 8 ulps of the sum of the
    magnitudes that make it (Σ 0.1·0.9^(t-k)·|g_k·c_k|: four roundings a
    step in each package, g·c, two products and the sum); for v, where c
    enters squared, E_t = 0.95·E_(t-1) + 2δ_t·0.05·(g_t·c_t)² + 12 ulps
    of Σ 0.05·0.95^(t-k)·(g_k·c_k)² (six roundings a step in each, g·c
    counting twice), in f64 from the reference's gradients and clip
    factors; each 8-bit scale within 8 ulps + 2δ_t relative,
    each parameter within 8 ulps of Σ_t (|p_(t-1)|
    + |p_t − p_(t-1)| + lr_t) (the terms of its update; m / √v does not
    see a common scale), and the 8-bit payloads equal.
* ``schedule`` equal at every step of the reference's warm-up and decay
  checked here; ``global_norm``, ``_q8`` / ``_dq8`` and
  ``compress_tree`` against the reference; the in-place update equal to
  the functional one.
* The reference's own system tests, mirrored on the port
  (``tests/test_system.py``: AdamW converges on a quadratic, in f32 and
  with 8-bit moments; error feedback converges and keeps its residual
  small); ``compressed_psum_grads`` waits for the mesh slice.
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.launch import train as jtrain
from repro.models import transformer as JT
from repro.optim import grad_compress as jgc
from repro.optim import optimizer as jopt
from repro_torch.convert import params_from_numpy
from repro_torch.optim import grad_compress as tgc
from repro_torch.optim import optimizer as topt

STEPS = 5
U = 2.0 ** -24
_GRADS = {}


def ref_trajectory():
    """The reference's params0 and the gradients of its own five AdamW
    steps (f32 mode, default config), as numpy trees."""
    if not _GRADS:
        cfg = dataclasses.replace(jconfigs.get("qwen2_7b").SMOKE, n_layers=2)
        tc = jtrain.TrainConfig(seq=16, global_batch=2, steps=STEPS)
        vg = jax.jit(jax.value_and_grad(
            jtrain.make_loss_fn(cfg, tc, mesh=None)))
        ocfg = jopt.AdamWConfig(total_steps=STEPS, warmup_steps=2)
        dc = jpipe.DataConfig(vocab=cfg.vocab, seq=16, global_batch=2)
        p = JT.init_params(jax.random.PRNGKey(0), cfg)
        _GRADS["p0"] = jax.tree_util.tree_map(np.asarray, p)
        s, grads = jopt.init(p, ocfg), []
        for i in range(STEPS):
            _, g = vg(p, jpipe.batch_at(dc, i))
            grads.append(jax.tree_util.tree_map(np.asarray, g))
            p, s = jopt.update(p, g, s, ocfg)
        _GRADS["grads"] = grads
    return _GRADS["p0"], _GRADS["grads"]


def leaves(tree):
    return dict(topt.tree_paths(tree))


def j_leaves(tree):
    return {tuple(p.key for p in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def both_runs(quantized: bool, grad_clip: float):
    """Five steps of each package on the reference's gradients; returns
    per step (reference state, reference params, port state, port params,
    the clip factor the reference applied, the two clip factors' relative
    difference, lr)."""
    p0, grads = ref_trajectory()
    kw = dict(total_steps=STEPS, warmup_steps=2, grad_clip=grad_clip,
              quantized_moments=quantized)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = params_from_numpy(p0, "cpu")
    js, ts = jopt.init(jp, jcfg), topt.init(tp, tcfg)
    out = []
    for i, g in enumerate(grads):
        clip = min(1.0, grad_clip / (float(jopt.global_norm(g)) + 1e-9))
        tclip = min(1.0, grad_clip / (float(topt.global_norm(
            params_from_numpy(g, "cpu"))) + 1e-9))
        lr = float(jopt.schedule(jcfg, jnp.asarray(i + 1, jnp.int32)))
        jp, js = jopt.update(jp, jax.tree_util.tree_map(jnp.asarray, g),
                             js, jcfg)
        tp, ts = topt.update(tp, params_from_numpy(g, "cpu"), ts, tcfg)
        out.append((js, j_leaves(jp), ts, leaves(tp), clip,
                    abs(tclip - clip) / clip, lr))
    return out


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "8bit"])
def test_adamw_bitwise_on_reference_grads_clip_off(quantized):
    for js, jp, ts, tp, _, _, _ in both_runs(quantized, grad_clip=1e30):
        assert int(ts.step) == int(js.step)
        for path, a in jp.items():
            assert np.array_equal(a, tp[path].numpy()), path
        fields = ("m", "v", "m_scale", "v_scale") if quantized else ("m", "v")
        for f in fields:
            ja, ta = j_leaves(getattr(js, f)), leaves(getattr(ts, f))
            for path, a in ja.items():
                assert a.dtype == ta[path].numpy().dtype, (f, path)
                assert np.array_equal(a, ta[path].numpy()), (f, path)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "8bit"])
def test_adamw_on_reference_grads_default_clip(quantized):
    p0, grads = ref_trajectory()
    runs = both_runs(quantized, grad_clip=1.0)
    zeros = lambda: {k: np.zeros(a.shape)                  # noqa: E731
                     for k, a in leaves(p0).items()}
    mag_m, mag_v, tol_m, tol_v = zeros(), zeros(), zeros(), zeros()
    tol_p = {k: np.zeros(a.shape) for k, a in leaves(p0).items()}
    prev = {k: a.astype(np.float64) for k, a in leaves(p0).items()}
    for (js, jp, ts, tp, clip, dc, lr), g in zip(runs, grads):
        g = leaves(g)
        for k in prev:
            gc = np.abs(g[k].astype(np.float64) * clip)
            mag_m[k] = 0.9 * mag_m[k] + 0.1 * gc
            mag_v[k] = 0.95 * mag_v[k] + 0.05 * gc * gc
            tol_m[k] = 0.9 * tol_m[k] + dc * 0.1 * gc + 8 * U * mag_m[k]
            tol_v[k] = (0.95 * tol_v[k] + 2 * dc * 0.05 * gc * gc
                        + 12 * U * mag_v[k])
            now = jp[k].astype(np.float64)
            tol_p[k] += 8 * U * (np.abs(prev[k]) + np.abs(now - prev[k]) + lr)
            prev[k] = now
            assert np.all(np.abs(tp[k].numpy() - now) <= tol_p[k]), k
        if quantized:
            for f in ("m", "v"):
                ja, ta = j_leaves(getattr(js, f)), leaves(getattr(ts, f))
                for k, a in ja.items():
                    assert np.array_equal(a, ta[k].numpy()), (f, k)
            for f in ("m_scale", "v_scale"):
                ja, ta = j_leaves(getattr(js, f)), leaves(getattr(ts, f))
                for k, a in ja.items():
                    np.testing.assert_allclose(
                        ta[k].numpy(), a, rtol=8 * U + 2 * dc, atol=0,
                        err_msg=f"{f} {k}")
        else:
            for f, tol in (("m", tol_m), ("v", tol_v)):
                ja, ta = j_leaves(getattr(js, f)), leaves(getattr(ts, f))
                for k, a in ja.items():
                    diff = np.abs(ta[k].numpy().astype(np.float64) - a)
                    assert np.all(diff <= tol[k]), (f, k)


def test_schedule_matches_reference():
    for kw in ({}, {"warmup_steps": 2, "total_steps": 5},
               {"warmup_steps": 0, "total_steps": 1, "min_lr_frac": 0.0}):
        jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
        for s in (0, 1, 2, 3, 5, 50, 99, 100, 101, 6000, 10000, 12000):
            want = np.float32(jopt.schedule(jcfg, jnp.asarray(s, jnp.int32)))
            got = topt.schedule(tcfg, s).numpy()
            assert got.dtype == np.float32 and got == want, (kw, s)


def test_global_norm_and_q8_codec_match_reference():
    rng = np.random.RandomState(3)
    tree = {"b": rng.randn(300).astype(np.float32),
            "a": {"x": rng.randn(7, 19).astype(np.float32)}}
    want = np.float32(jopt.global_norm(tree))
    got = topt.global_norm(params_from_numpy(tree, "cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=2 * U)
    # a block whose scale is exactly 1 (max 127): its halves are ties, and
    # both round them to even (jnp.round / torch.round)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5])
    x = np.concatenate([ties, np.zeros(120), rng.randn(250)]
                       ).astype(np.float32)
    for block in (128, 64):
        jq, js = jopt._q8(jnp.asarray(x), block)
        tq, ts = topt._q8(torch.from_numpy(x), block)
        assert tq[0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
        assert np.array_equal(np.asarray(jq), tq.numpy())
        assert np.array_equal(np.asarray(js), ts.numpy())
        assert np.array_equal(
            np.asarray(jopt._dq8(jq, js, x.shape, block)),
            topt._dq8(tq, ts, x.shape, block).numpy())


def test_inplace_update_equals_functional():
    p0, grads = ref_trajectory()
    for quant in (False, True):
        cfg = topt.AdamWConfig(total_steps=STEPS, quantized_moments=quant)
        fp = params_from_numpy(p0, "cpu")
        ip = params_from_numpy(p0, "cpu")
        fs, is_ = topt.init(fp, cfg), topt.init(ip, cfg)
        for g in grads[:3]:
            tg = params_from_numpy(g, "cpu")
            fp, fs = topt.update(fp, tg, fs, cfg)
            rp, rs = topt.update(ip, tg, is_, cfg, inplace=True)
            assert rp is ip and rs is is_
        assert int(is_.step) == int(fs.step) == 3
        for name in ("m", "v") + (("m_scale", "v_scale") if quant else ()):
            for k, a in leaves(getattr(fs, name)).items():
                assert torch.equal(a, leaves(getattr(is_, name))[k])
        for k, a in leaves(fp).items():
            assert torch.equal(a, leaves(ip)[k])


def test_compress_tree_matches_reference():
    rng = np.random.RandomState(4)
    g = {"w": (rng.randn(700) * 3).astype(np.float32),
         "b": {"x": rng.randn(5, 77).astype(np.float32)}}
    jef, tef = jgc.init_ef(g), tgc.init_ef(params_from_numpy(g, "cpu"))
    for _ in range(3):
        jd, jef = jgc.compress_tree(g, jef)
        td, tef = tgc.compress_tree(params_from_numpy(g, "cpu"), tef)
        for k, a in j_leaves(jd).items():
            assert np.array_equal(a, leaves(td)[k].numpy()), k
        for k, a in j_leaves(jef.residual).items():
            assert np.array_equal(a, leaves(tef.residual)[k].numpy()), k
    q, s = tgc._quant_int8(torch.from_numpy(g["w"]))
    jq, js = jgc._quant_int8(jnp.asarray(g["w"]))
    assert np.array_equal(np.asarray(jq), q.numpy())
    assert np.array_equal(np.asarray(js), s.numpy())


def test_compressed_psum_grads_on_a_one_rank_mesh():
    """On one rank the all-reduce is the int8 round trip: bit for bit the
    reference's on a one-device mesh (the multi-rank cases are in
    ``tests/test_torch_mesh_dist.py``)."""
    from jax.sharding import Mesh
    from repro_torch.launch import mesh as tmesh

    rng = np.random.RandomState(5)
    g = {"w": rng.randn(3, 300).astype(np.float32),
         "b": {"x": (1e-3 * rng.randn(5, 77)).astype(np.float32)}}
    want = jgc.compressed_psum_grads(
        jax.tree_util.tree_map(jnp.asarray, g),
        Mesh(np.array(jax.devices()[:1]), ("data",)))
    got = tgc.compressed_psum_grads(
        params_from_numpy(g, "cpu"),
        tmesh.make_serving_mesh(1, 1, device="cpu"))
    for k, a in j_leaves(want).items():
        assert np.array_equal(a, leaves(got)[k].numpy()), k


# -- the reference's own system tests, mirrored on the port -----------------

def test_adamw_converges_quadratic():
    cfg = topt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=5,
                           total_steps=200)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = topt.init(params, cfg)
    for _ in range(200):
        grads = {"x": 2 * params["x"]}
        params, state = topt.update(params, grads, state, cfg)
    assert float(params["x"].abs().max()) < 0.05


def test_adamw_8bit_moments_converges():
    cfg8 = topt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=5,
                            total_steps=200, quantized_moments=True)
    rng = np.random.RandomState(0)
    params = {"w": torch.from_numpy(rng.randn(64) * 3).float()}
    state = topt.init(params, cfg8)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state = topt.update(params, grads, state, cfg8)
    assert float(params["w"].abs().max()) < 0.1


def test_grad_compression_error_feedback():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(256) * 3).float()
    ef = tgc.init_ef({"x": x})
    params = {"x": x}
    for _ in range(150):
        grads = {"x": 2 * params["x"]}
        dec, ef = tgc.compress_tree(grads, ef)
        params = {"x": params["x"] - 0.05 * dec["x"]}
    assert float(params["x"].abs().max()) < 0.1
    assert float(ef.residual["x"].abs().max()) < 1.0
