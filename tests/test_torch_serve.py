"""The whole slice on the CPU: the port's SMOKE Qwen2 serve path against the
JAX package's, on the reference's own parameters (JAX ``init_params``
through numpy and ``params_from_numpy``), over a prefill and 8 decode
steps — plain ``TorchOps`` against ``JOps``, and the format-certified
backend against the reference's (unrolled, as ``launch/batching.py``
builds it). Plus the guards: no CUDA → the entry point raises unless asked
for the CPU, and nothing of the port imports jax or repro.

Tolerances: the two frameworks' CPU GEMMs and transcendental functions sum
and round in their own ways, a few f32 ulps apart. Plain path: logits
within 2e-6 absolute (|logits| ≤ ~0.5), cache within 1e-5. Format path: a
pre-rounding difference can cross a rounding boundary and move a value by
one ulp at the scope's k, so cache entries may differ by one ulp at the
attention format's k relative (2^-(k-1)) and logits by 1e-3; tokens must be
equal, and a mismatch reports the top-1 gap at that step.
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.backend import JOps
from repro.core.scopes import resolve_scope_value as j_resolve
from repro.launch import serve as jserve
from repro.launch.batching import make_backend
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.certify import spec as tspec
from repro_torch.core.backend import TorchOps
from repro_torch.core.scopes import resolve_scope_value as t_resolve
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from _torch_serve_parity import (B, JCFG, MAX_SEQ, PROMPT, TCFG, both_params,
                                 check_steps, run_both)

ROOT = Path(__file__).resolve().parents[1]
FMT_MAP = {"": {"k": 11, "emax": 15, "emin": -14},
           "layer*/attn": {"k": 8, "emax": 15, "emin": -14},
           "layer0/mlp": {"k": 9, "emax": 7, "emin": -6}}


@pytest.fixture(scope="module")
def params():
    return both_params()


def test_plain_serve_matches_jax_jops(params):
    def cache_tol(got, want):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    steps = run_both(JOps(jnp.float32, jnp.float32), TorchOps(), params)
    check_steps(steps, 2e-6, cache_tol)


def test_format_serve_matches_jax_format_backend(params):
    sc = jserve.ServeConfig(arch="qwen2_7b", batch=B, max_seq=MAX_SEQ,
                            precision_layer_format=FMT_MAP)
    jbk = make_backend(sc, unrolled=True)
    tbk = tserve.FormatQuantJOps(FMT_MAP)
    k_attn = FMT_MAP["layer*/attn"]["k"]

    def cache_tol(got, want):
        np.testing.assert_allclose(got, want, rtol=2.0 ** (1 - k_attn),
                                   atol=1e-6)

    steps = run_both(jbk, tbk, params)
    check_steps(steps, 1e-3, cache_tol)


def test_format_backend_rounds_differently_from_plain(params):
    """The certified map really changes the arithmetic (a vacuous backend
    would pass the parity test against itself)."""
    _, tp = params
    toks = torch.from_numpy(
        np.random.RandomState(1).randint(0, TCFG.vocab, (1, PROMPT)))
    plain, _ = TT.forward(TorchOps(), tp, TCFG, toks)
    fmt, _ = TT.forward(tserve.FormatQuantJOps(FMT_MAP), tp, TCFG, toks)
    assert not torch.equal(plain, fmt)


def test_decode_hook_engages_once_per_layer_per_step(params, monkeypatch):
    _, tp = params
    calls = []
    real = tserve.certified_decode_attention

    def spy(q, k, v, lengths, fmt, **kw):
        calls.append((tuple(q.shape), fmt))
        return real(q, k, v, lengths, fmt, **kw)

    monkeypatch.setattr(tserve, "certified_decode_attention", spy)
    bk = tserve.FormatQuantJOps(FMT_MAP)
    cache = TT.init_cache(TCFG, B, MAX_SEQ, device="cpu")
    tok = torch.zeros((B, PROMPT), dtype=torch.int64)
    with torch.no_grad():
        _, cache = tserve.prefill_step(bk, tp, TCFG, cache, tok)
        assert calls == []                  # prefill takes the composed path
        for i in range(3):
            tok, _, cache = tserve.decode_step(bk, tp, TCFG, cache,
                                               tok[:, -1:], PROMPT + i)
            tok = tok[:, None]
    assert len(calls) == TCFG.n_layers * 3
    G = TCFG.n_heads // TCFG.n_kv_heads
    assert calls[0][0] == (B, TCFG.n_kv_heads, G, TCFG.head_dim)
    assert {c[1] for c in calls} == {(8, 15, -14)}


def _paths():
    out = []
    for outer in ([], ["embed"], ["head"]):
        out.append(outer)
    for i in range(3):
        for sub in ([], ["attn"], ["mlp"]):
            out.append([f"layer{i}", *sub])
    return out


@pytest.mark.parametrize("fmt_map", [
    FMT_MAP,
    {"": {"k": 24, "emax": 127, "emin": -126},
     "layer*/attn": {"k": 12, "emax": 15, "emin": -14},
     "layer*/mlp": {"k": 10, "emax": 15, "emin": -14},
     "layer0/mlp": {"k": 16, "emax": 31, "emin": -30},
     "layer2": {"k": 13, "emax": 15, "emin": -14},
     "head": {"k": 20, "emax": 63, "emin": -62}},
])
def test_scope_resolution_matches_reference(fmt_map):
    sc = jserve.ServeConfig(arch="qwen2_7b", precision_layer_format=fmt_map)
    jbk = make_backend(sc, unrolled=True)
    tbk = tserve.FormatQuantJOps(fmt_map)
    for path in _paths():
        assert tbk.format_for(path) == jbk._lane_static(path), path
    plain = {k: v["k"] for k, v in fmt_map.items() if k}
    for path in _paths():
        assert t_resolve(path, plain, -1) == j_resolve(path, plain, -1)
    lanes = {"layer*": [5, 6, 7], "layer1/mlp": 9}
    for path in _paths():
        assert t_resolve(path, lanes, 0) == j_resolve(path, lanes, 0)


def test_format_backend_guards():
    with pytest.raises(ValueError):
        tserve.FormatQuantJOps({"layer0": {"k": 8, "emax": 7, "emin": -6}})
    with pytest.raises(ValueError):
        tserve.FormatQuantJOps({
            "": {"k": 8, "emax": 7, "emin": -6, "saturating": True},
            "layer0": {"k": 8, "emax": 7, "emin": -6, "saturating": False}})
    with pytest.raises(NotImplementedError):
        tserve.FormatQuantJOps({"": {"k": 4, "emax": 8, "emin": -6,
                                     "max_finite_override": 448.0}})
    with pytest.raises(ValueError):
        tserve.ServeConfig(compute_dtype="float16")
    assert isinstance(tserve._backend(tserve.ServeConfig()), TorchOps)
    assert isinstance(tserve._backend(tserve.ServeConfig(
        precision_layer_format=FMT_MAP)), tserve.FormatQuantJOps)


def test_model_shapes_and_counts_match_reference():
    for name in ("SMOKE", "FULL"):
        jc = getattr(jconfigs.get("qwen2_7b"), name)
        tc = getattr(tconfigs.get("qwen2_7b"), name)
        assert dataclass_dict(tc) == dataclass_dict(jc)
        assert TT.analytic_params(tc) == JT.analytic_params(jc)
    shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                   JCFG))
    want = jax.tree_util.tree_map(lambda s: tuple(s.shape), shapes)
    assert TT.param_shapes(TCFG) == want


def dataclass_dict(cfg):
    import dataclasses
    return dataclasses.asdict(cfg)


def test_init_params_on_device_from_generator():
    gen = torch.Generator().manual_seed(0)
    p = TT.init_params(TCFG, generator=gen, device="cpu")
    L, d = TCFG.n_layers, TCFG.d_model
    assert p["layers"]["mlp"]["w_gate"].shape == (L, d, TCFG.d_ff)
    assert torch.equal(p["layers"]["ln1"], torch.ones(L, d))
    assert torch.equal(p["layers"]["attn"]["bq"],
                       torch.zeros(L, TCFG.n_heads * TCFG.head_dim))
    std = float(p["layers"]["attn"]["wq"].std())
    assert abs(std - d ** -0.5) < 0.1 * d ** -0.5
    again = TT.init_params(TCFG, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    assert torch.equal(again["embed"], p["embed"])


def test_unported_configs_raise():
    """Once the last three families were refused here (MLA, the
    encoder-decoder, the modality frontends); now every arch of the
    reference's registry resolves in the port, by id and by alias, its
    SMOKE and FULL configs field for field the reference's, and builds its
    decode cache; only a name the reference does not know raises."""
    import dataclasses

    from repro.configs import _ALIASES as jaliases

    assert sorted(tconfigs.ARCHS) == sorted(jconfigs.ARCHS)
    for alias, arch in jaliases.items():
        assert tconfigs.get(alias) is tconfigs.get(arch)
    for arch in jconfigs.ARCHS:
        for size in ("SMOKE", "FULL"):
            jc = getattr(jconfigs.get(arch), size)
            tc = getattr(tconfigs.get(arch), size)
            assert dataclasses.asdict(jc) == dataclasses.asdict(tc), arch
    for arch in ("minicpm3_4b", "whisper_medium", "paligemma_3b"):
        tc = tconfigs.get(arch).SMOKE
        cache = TT.init_cache(tc, 1, 4, device="cpu")
        want = ((tc.kv_rank,) if tc.mla else (tc.n_kv_heads, tc.head_dim))
        assert cache["k"].shape == (tc.n_layers, 1, 4) + want
    with pytest.raises(KeyError):
        tconfigs.get("not_an_arch")


def test_main_without_cuda_raises_unless_cpu_requested(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--batch", "1", "--prefill-len", "4",
                     "--decode-steps", "1"])
    res = tserve.main(["--device", "cpu", "--batch", "2", "--prefill-len",
                       "5", "--decode-steps", "3", "--layer-format",
                       json.dumps(FMT_MAP)])
    assert res.tokens.shape == (2, 4)
    assert bool(((res.tokens >= 0) & (res.tokens < TCFG.vocab)).all())
    assert torch.isfinite(res.prefill_logits).all()
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_main_serves_a_certificate_set_with_error_bars(tmp_path):
    fmt = {"k": 11, "emax": 15, "emin": -14, "has_subnormals": True,
           "saturating": True, "name": "f"}
    cert = {"model_id": "qwen2-smoke", "params_digest": "cd" * 32,
            "class_key": "p0", "cfg": {}, "bounds_u_max": 2.0 ** -9,
            "final_abs_u": 3.0, "final_rel_u": 4.0, "required_k": 11,
            "satisfied_by": [], "schema_version": 3,
            "layer_format": {"": fmt, "layer1": dict(fmt, k=9)}}
    cs = tspec.CertificateSet.from_dict({
        "schema_version": 3, "model_id": "qwen2-smoke",
        "params_digest": "cd" * 32, "certificates": [cert]})
    path = tmp_path / "certs.json"
    path.write_text(cs.to_json())
    res = tserve.main(["--device", "cpu", "--batch", "1", "--prefill-len",
                       "4", "--decode-steps", "2", "--certificate-set",
                       str(path)])
    assert res.config.precision_layer_format == cs.serving_layer_format
    bars = res.responses[0]["certificate"]
    assert bars["dbar_u"] == 3.0 and bars["k"] == 11
    assert bars["params_digest"] == "cd" * 32
    assert len(res.responses[0]["tokens"]) == 3


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"src/repro_torch/launch/mesh.py",
            "src/repro_torch/parallel/sharding.py"} <= names
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
