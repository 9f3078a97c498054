"""The port's six examples (``repro_torch.examples``), each through its
``main([..., "--device", "cpu"])`` at its smallest arguments, on the CPU:
each runs, prints the reference script's lines, and returns what it
printed. Where the reference script holds something (quickstart's
certified decisions against the exact model, serve_certified_lm's
differential), the port's holds it too. Their numbers are held against the
JAX package's in ``tests/test_torch_paper_drivers.py`` and
``tests/test_torch_analyze.py``; their kernels run on a card in
``chip_smoke.py``'s ``paper`` phase.
"""
import math

import pytest
import torch

from repro_torch.examples import (lm_precision_analysis, pendulum_certificate,
                                  quickstart, serve_certified,
                                  serve_certified_lm, serve_custom_formats)

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs six workers on the machine's
    cores, and these full-width runs would otherwise oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_quickstart(capsys):
    res = quickstart.main(CPU)
    out = capsys.readouterr().out
    assert "=== 1. train Digits" in out and "0.73M params" in out
    assert "=== 2. CAA analysis at k=8" in out and "required precision k=" \
        in out
    assert f"inputs certified at k=8; {res['n_ok']}/{res['n_cert']}" in out
    assert res["n_params"] == 784 * 700 + 700 + 700 * 256 + 256 + 2570
    assert res["n_cert"] > 0 and res["n_ok"] == res["n_cert"]
    assert res["required_k"] == res["decision"].required_k
    assert len(res["certs"]) == quickstart.N_CERT == len(res["pred"])


def test_pendulum_certificate(capsys):
    res = pendulum_certificate.main(CPU)
    out = capsys.readouterr().out
    assert "absolute error bound:" in out and "relative bound exists: False" \
        in out
    assert [f"k={k:2d}" in out for k in (8, 11, 16, 24)] == [True] * 4
    assert math.isfinite(res["dbar_u"]) and not math.isfinite(res["ebar_u"])
    d = list(res["delta"].values())
    assert d == sorted(d, reverse=True)


def test_serve_custom_formats(capsys, tmp_path):
    args = ["--samples", "150", "--h1", "16", "--h2", "8", "--batch", "32",
            "--store", str(tmp_path)] + CPU
    res = serve_custom_formats.main(args)
    out = capsys.readouterr().out
    assert "certified in" in out and "served 32 requests" in out
    assert "served by the plain version on the CPU" in out
    assert res["layer_format"][""] and res["kernel_vs_plain_rule"] is None
    again = serve_custom_formats.main(args)
    assert "(store hit)" in capsys.readouterr().out
    assert again["layer_format"] == res["layer_format"]


@pytest.mark.parametrize("extra", [["--precision-k", "12"],
                                   ["--certificates", None]])
def test_serve_certified(capsys, tmp_path, extra):
    extra = [str(tmp_path) if a is None else a for a in extra]
    res = serve_certified.main(["--batch", "2", "--prefill-len", "4",
                                "--decode-steps", "2"] + extra + CPU)
    out = capsys.readouterr().out
    assert "served 2 requests (certified k=" in out
    assert "sample continuation:" in out
    assert res["tokens"].shape == (2, 3)
    if "--certificates" in extra:
        assert "certificate fetch:" in out and "error bars" in out
        assert res["responses"][0]["certificate"]["k"] == res["precision_k"]


def test_serve_certified_lm(capsys):
    res = serve_certified_lm.main(["--max-layers", "1", "--prefill-len", "4",
                                   "--decode-steps", "1"] + CPU)
    out = capsys.readouterr().out
    assert "certificate fetch:" in out and "served 2 seqs × 1 tokens" in out
    assert res["layer_k"] and res["differential_bitwise"] is True
    assert "bit for bit" in out


def test_serve_certified_lm_differential_is_a_real_check():
    """The per-layer reference rounds each matmul at its scope's k: a map
    that differs from the served one gives other bits."""
    from repro_torch import configs
    from repro_torch.launch.serve import MixedQuantJOps
    from repro_torch.models import transformer as T

    cfg = configs.get("qwen2_7b").SMOKE
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    tokens = torch.randint(0, cfg.vocab, (1, 4),
                           generator=torch.Generator().manual_seed(1))
    lk = {"layer0": 8, "head": 10}
    ref = serve_certified_lm.LayerByLayerMixedQuantJOps
    with torch.no_grad():
        a = T.forward(MixedQuantJOps(lk, 12), params, cfg, tokens)[0]
        b = T.forward(ref(lk, 12), params, cfg, tokens)[0]
        c = T.forward(ref({"layer0": 9, "head": 10}, 12), params, cfg,
                      tokens)[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_lm_precision_analysis(capsys):
    res = lm_precision_analysis.main(CPU)
    out = capsys.readouterr().out
    assert "=== qwen2_7b (reduced config), emulated k=12" in out
    assert "=== mixtral_8x22b (reduced config), emulated k=12" in out
    assert "=== rwkv6_1p6b (reduced config), emulated k=12" in out
    assert "not analysed" not in out
    assert [r["arch"] for r in res["analysed"]] == ["qwen2_7b",
                                                    "mixtral_8x22b",
                                                    "rwkv6_1p6b"]
    assert set(res) == {"analysed"}
    assert all(math.isfinite(r["max_abs_u"]) for r in res["analysed"])
    assert [r["routers"] for r in res["analysed"]] == [0, 2, 0]
    assert "router layer0/mlp/router: min margin" in out


def test_examples_run_on_the_card_unless_told_otherwise(monkeypatch):
    """Without ``--device cpu`` an example asks for the card, and raises
    where there is none (no silent CPU path)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pendulum_certificate.main([])
