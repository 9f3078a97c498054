"""The port's LM certification (``repro_torch.certify.pipeline.certify_lm``
and the layer-stacked ``repro_torch.certify.lm.certify_lm_stacked``)
against the JAX package's, on the 2-layer nano LM of ``tests/
test_stacked.py`` (d 16, 2 heads of 8, d_ff 32, vocab 256), trained in JAX
as that fixture trains it and carried across through numpy.

Tier 1 runs the mixed descent (``mixed=True``, k_max 53) in both
packages here, and the uniform search (k_max 24) in
``tests/test_torch_certify.py``; ``mixed + formats + profiles (4,)`` runs
under ``slow`` as well. Equal: ``required_k``, ``satisfied_by``,
``layer_k``, ``layer_format``, ``map_provenance``, the ``probes`` and the
store key; the bounds by the rule of ``tests/_torch_nano.py``. Each
package's stored set is a hit for the other's ``serving_certificate``.

Also here: the certification profile's tokens (the reference's
``jax.random.randint`` draw, replayed in numpy), ``lm_layer_flops``, the
CLIs of ``repro_torch.certify`` and ``repro_torch.launch.analyze`` on the
CPU.
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import dataclasses
import math
import os

import jax
import numpy as np
import pytest

from repro import certify as jcertify
from repro import configs as jconfigs
from repro.certify import pipeline as jpipeline
from repro.models import transformer as JT
from repro_torch import certify as tcertify
from repro_torch import configs as tconfigs
from repro_torch.certify import pipeline as tpipeline
from repro_torch.certify.tokens import profile_tokens
from repro_torch.models import transformer as TT
from _torch_nano import PROFILE, certify_both, close, same_lm_sets, \
    trained_nano


@pytest.fixture(scope="module")
def nano():
    return trained_nano()


def _roots(tmp_path_factory):
    return [str(tmp_path_factory.mktemp(n)) for n in ("jlm", "tlm")]


@pytest.fixture(scope="module")
def mixed(nano, tmp_path_factory):
    return certify_both(jcertify, tcertify, nano, _roots(tmp_path_factory),
                        k_max=53, mixed=True)


def test_mixed_certificate_equals_reference(mixed):
    js, ts, roots, _ = mixed
    same_lm_sets(js, ts)
    cert = ts.certificates[0]
    assert cert.required_k == 36
    assert cert.layer_k == {"layer0": 36, "layer1": 30, "head": 16}
    jm, tm = js.meta["mixed"], ts.meta["mixed"]
    for key in ("layer_k", "uniform_k", "probes", "eager_confirms"):
        assert jm[key] == tm[key], key
    for s, v in jm["sensitivity_abs_u"].items():
        assert close(v, tm["sensitivity_abs_u"][s])
    assert ts.meta["scope_keys"] == js.meta["scope_keys"]
    assert ts.meta["ladder_compiles"] == 0
    assert set(ts.meta["stage_seconds"]) >= {
        "uniform_search", "eager_confirmation", "sensitivity_rank",
        "greedy_descent"}
    assert os.listdir(roots[0]) == os.listdir(roots[1])


def test_serving_certificate_hits_across_packages(nano, mixed):
    """The port's ``serving_certificate`` serves what the JAX package
    stored, and the JAX package's serves what the port stored."""
    jcfg, jp, tcfg, tp = nano
    js, ts, roots, kw = mixed
    got_t = tpipeline.serving_certificate("qwen2_7b", tcfg, tp, roots[0],
                                          **PROFILE, **kw)
    got_j = jpipeline.serving_certificate("qwen2_7b", jcfg, jp, roots[1],
                                          **PROFILE, **kw)
    assert got_t.meta["from_store"] and got_j.meta["from_store"]
    same_lm_sets(js, got_t)
    same_lm_sets(got_j, ts)
    assert got_t.serving_k == got_j.serving_k == js.serving_k


@pytest.mark.slow
def test_mixed_formats_profiles_certificate_equals_reference(
        nano, tmp_path_factory):
    js, ts, roots, _ = certify_both(jcertify, tcertify, nano,
                                   _roots(tmp_path_factory), k_max=53,
                                   mixed=True, formats=True, profiles=(4,))
    same_lm_sets(js, ts)
    assert ts.certificates[0].layer_format is not None
    assert len(ts.certificates) == 2
    assert ts.serving_layer_format == js.serving_layer_format
    assert ts.map_provenance() == js.map_provenance()
    jf, tf = js.meta["formats"], ts.meta["formats"]
    for key in ("applied", "attached", "mantissa_mode", "layer_format",
                "emax_floor_bits", "probes", "baseline_bits"):
        assert jf[key] == tf[key], key
    assert js.meta["profile_certificates"].keys() == \
        ts.meta["profile_certificates"].keys()
    assert js.meta["serving"]["map_source"] == ts.meta["serving"]["map_source"]
    assert os.listdir(roots[0]) == os.listdir(roots[1])


# ---------------------------------------------------------------------------
# the profile's tokens, the FLOP weights, unported frontends, the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,batch,seq,vocab", [
    (0, 2, 6, 256), (1, 1, 8, 128), (1, 1, 8, 152064), (7, 3, 17, 1000),
    (2 ** 33 + 5, 2, 4, 50), (3, 1, 1, 2)])
def test_profile_tokens_equal_jax_randint(seed, batch, seq, vocab):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                         (batch, seq), 0, vocab))
    got = profile_tokens(seed, batch, seq, vocab).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("size", ["SMOKE", "FULL"])
def test_lm_layer_flops_equal_reference(size):
    from repro.certify.lm import lm_layer_flops as jflops

    jcfg = getattr(jconfigs.get("qwen2_7b"), size)
    tcfg = getattr(tconfigs.get("qwen2_7b"), size)
    assert tcertify.lm_layer_flops(tcfg) == jflops(jcfg)
    assert TT.analytic_params(tcfg, active=True) == \
        JT.analytic_params(jcfg, active=True)


def test_unported_frontend_raises(nano):
    """Once a modality frontend was refused here; now the stacked pipeline
    draws the stub's inputs as the reference does (audio frames as
    ``enc_embeds``, vision patches as ``frontend_embeds``, f32 from
    ``np.random.RandomState(seed)``; none for text), and the nano LM with a
    vision stub certifies with its patches prepended."""
    from repro.certify.lm import _frontend_kwargs as jfront
    from repro_torch.certify.lm import frontend_kwargs as tfront

    _, _, tcfg, tp = nano
    for kind in ("audio", "vision", None):
        cfg = dataclasses.replace(tcfg, frontend=kind, frontend_seq=4,
                                  frontend_dim=8)
        want, got = jfront(cfg, 2, 3), tfront(cfg, 2, 3, "cpu")
        assert set(want) == set(got)
        for key in want:
            assert np.array_equal(got[key].numpy(), want[key])
    vision = dataclasses.replace(tcfg, frontend="vision", frontend_seq=4,
                                 frontend_dim=8)
    import torch

    params = dict(tp, frontend_proj=torch.randn(
        8, tcfg.d_model, generator=torch.Generator().manual_seed(0)))
    cs = tcertify.certify_lm("qwen2_7b", vision, params, mixed=True,
                             k_max=24, device="cpu")
    assert len(cs.certificates) == 1


def test_certify_cli_on_the_cpu(tmp_path, monkeypatch):
    """``python -m repro_torch.certify --arch transformer --device cpu``:
    the SMOKE config's port-seeded params certify, persist (with one
    ``runs`` entry in the port's bench trajectory, as the reference's CLI
    appends), and the second run is a store hit; without a card and
    without ``--device cpu`` the CLI raises."""
    import torch

    from repro_torch.certify.__main__ import main
    from repro_torch.obs import bench

    monkeypatch.setenv("REPRO_TORCH_BENCH_DIR", str(tmp_path / "bench"))
    argv = ["--arch", "transformer", "--device", "cpu", "--store",
            str(tmp_path)]
    first = main(argv)
    assert first.meta["from_store"] is False
    assert first.serving_k is not None
    assert main(argv).meta["from_store"] is True
    runs = bench.read_bench("runs")
    assert [(r["kind"], r["arch"], r["mixed"]) for r in runs] == [
        ("certify", "qwen2_7b", False)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device cpu"):
            main(argv[:2] + argv[4:])


def test_analyze_cli_on_the_cpu(capsys):
    from repro_torch.launch.analyze import main

    out = main(["--device", "cpu", "--k", "12", "--seq", "4"])
    assert math.isfinite(out["abs_u"]) and out["trace"]
    assert "certified actual |error|" in capsys.readouterr().out
    with pytest.raises(KeyError, match="unknown arch"):
        main(["--device", "cpu", "--arch", "not_an_arch"])
    out = main(["--device", "cpu", "--arch", "minicpm3_4b", "--k", "12",
                "--seq", "4"])
    assert math.isfinite(out["abs_u"])
    out = main(["--device", "cpu", "--arch", "rwkv6_1p6b", "--k", "12",
                "--seq", "4"])
    assert math.isfinite(out["abs_u"])
    assert [r.name for r in out["trace"]] == ["head/logits"]
    out = main(["--device", "cpu", "--arch", "mixtral_8x22b", "--k", "10",
                "--seq", "4", "--routers"])
    assert [r.name for r in out["routers"]] == ["layer0/mlp/router",
                                                "layer1/mlp/router"]
    assert "router records (2):" in capsys.readouterr().out


def test_batching_cli_certifies_a_miss_and_serves_it(tmp_path):
    """``launch/batching.py --certificates STORE --max-layers 1`` on an
    empty store: the first call certifies the cut model's own seeded params
    (no LookupError), the engine serves the certified k with every request
    equal to ``reference_generate``; a second call is a store hit."""
    from repro_torch.launch import batching

    argv = ["--device", "cpu", "--max-layers", "1", "--requests", "3",
            "--max-new", "4", "--certificates", str(tmp_path),
            "--check-ref"]
    engine, responses = batching.main(argv)
    assert len(responses) == 3 and engine.sc.precision_k is not None
    assert len(os.listdir(tmp_path)) == 1
    engine2, _ = batching.main(argv)
    assert engine2.certset.meta["from_store"] is True
