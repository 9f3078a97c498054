"""Continuous batching in the port (repro_torch.launch.batching) on the CPU:
its ragged pieces against the JAX package's, and the engine against the
port's own eager oracle and the JAX engine.

* ``lane_causal_mask`` and the per-lane ``_cache_write`` equal the
  reference's bit for bit.
* The ragged ``forward`` (``q_offset`` a [B] tensor, per-lane cache
  indices) matches JAX's on the reference's SMOKE parameters: logits within
  2e-6 under TorchOps/JOps and 1e-3 under the certified backends, the cache
  within the tolerances of ``tests/test_torch_serve.py`` (a pre-rounding
  difference may move a value by one ulp at the attention scope's k).
* The engine's tokens equal ``reference_generate``'s, request by request,
  under the plain, v2 per-layer-k and v3 format backends, with staggered
  arrivals, padded prefills, early EOS with lane recycling and a
  page-bounded FIFO. Its tokens also equal the JAX engine's on the same
  requests; a mismatch reports the top-1 logit gap.

What the CPU shows about bits: PyTorch's CPU GEMM gives a row other bits
when the product has one or two rows than when it has more, so the
engine's decode steps (one row a lane) and the batch-1 oracle's differ in
their last bits, and a padded prefill equals the unpadded one bit for bit
import _torch_test_setup  # noqa: F401  (before any reference compile)
from three prompt tokens on. Tokens agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import JOps
from repro.launch import batching as jbatching
from repro.launch import serve as jserve
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import obs
from repro_torch.core.backend import TorchOps
from repro_torch.launch import batching as tbatching
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from _torch_serve_parity import JCFG, TCFG, both_params, top1_gap

FMT_MAP = {"": {"k": 11, "emax": 15, "emin": -14},
           "layer*/attn": {"k": 8, "emax": 15, "emin": -14},
           "layer1": {"k": 9, "emax": 15, "emin": -14}}
MIXED = {"precision_k": 12,
         "precision_layer_k": {"layer0": 9, "layer1/mlp": 10}}
BACKENDS = {"plain": {}, "mixed": MIXED,
            "format": {"precision_layer_format": FMT_MAP}}
MAX_SEQ = 48


@pytest.fixture(scope="module")
def params():
    return both_params()


def _sc(case, **kw):
    return tserve.ServeConfig(device="cpu", max_seq=MAX_SEQ,
                              **BACKENDS[case], **kw)


def _requests(n, seed=0, plen_lo=5, plen_hi=12, max_new=5, stride=1):
    rng = np.random.RandomState(seed)
    return [tbatching.Request(
        rid=i, prompt=rng.randint(0, TCFG.vocab,
                                  rng.randint(plen_lo, plen_hi + 1)).tolist(),
        max_new_tokens=max_new, arrival_step=i * stride) for i in range(n)]


def _engine(sc, tp, **kw):
    kw = {"n_lanes": 3, "max_seq": MAX_SEQ, "page_size": 8,
          "queue_depth": 8, **kw}
    return tbatching.ContinuousBatchingEngine(TCFG, sc, tp, device="cpu",
                                              **kw)


def _assert_matches_reference(sc, tp, responses, reqs, eos_id=-1):
    assert sorted(r["id"] for r in responses) == sorted(q.rid for q in reqs)
    for req in reqs:
        got = next(r["tokens"] for r in responses if r["id"] == req.rid)
        want = tbatching.reference_generate(TCFG, sc, tp, req.prompt,
                                            req.max_new_tokens,
                                            max_seq=MAX_SEQ, eos_id=eos_id)
        assert got == want, (req.rid, got, want)


# ---------------------------------------------------------------------------
# the ragged pieces against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_len,kv_len,offsets", [
    (1, 16, [0, 5, 15]), (4, 12, [0, 3, 8]), (6, 6, [0, 0]),
    (3, 40, [37, 1, 0, 20])])
def test_lane_causal_mask_equals_reference(q_len, kv_len, offsets):
    want = np.asarray(JL.lane_causal_mask(q_len, kv_len,
                                          jnp.asarray(offsets, jnp.int32)))
    got = TL.lane_causal_mask(q_len, kv_len,
                              torch.tensor(offsets, dtype=torch.int32))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("S,index", [(1, [0, 7, 3]), (4, [2, 0, 12]),
                                     (3, 5)])
def test_cache_write_per_lane_equals_reference(S, index):
    rng = np.random.RandomState(S)
    buf = rng.randn(3, 16, 2, 4).astype(np.float32)
    upd = rng.randn(3, S, 2, 4).astype(np.float32)
    want = np.asarray(JA._cache_write(jnp.asarray(buf), jnp.asarray(upd),
                                      jnp.asarray(index, jnp.int32)))
    got = torch.from_numpy(buf.copy())
    TA._cache_write(got, torch.from_numpy(upd),
                    torch.tensor(index, dtype=torch.int32))
    assert np.array_equal(got.numpy(), want)


def test_mask5_broadcasts_shared_and_per_lane_masks():
    shared = torch.ones(2, 5, dtype=torch.bool)
    lanes = torch.ones(3, 2, 5, dtype=torch.bool)
    assert TA._mask5(shared).shape == (1, 1, 1, 2, 5)
    assert TA._mask5(lanes).shape == (3, 1, 1, 2, 5)


def test_per_lane_rope_tables_equal_reference():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 2, 4, 16).astype(np.float32)
    pos = np.array([[0, 1], [5, 6], [17, 18]])
    jc, js = JL.rope_tables(jnp.arange(20), 16, 1e4)
    jcos, jsin = jnp.take(jc, pos, axis=0), jnp.take(js, pos, axis=0)
    want = np.asarray(JL.apply_rope(JOps(jnp.float32, jnp.float32),
                                    jnp.asarray(x), jcos, jsin))
    tc, ts = TL.rope_tables(torch.arange(20), 16, 1e4)
    got = TL.apply_rope(TorchOps(), torch.from_numpy(x),
                        tc[torch.from_numpy(pos)], ts[torch.from_numpy(pos)])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_init_cache_per_lane_idx(params):
    c = TT.init_cache(TCFG, 3, 8, device="cpu", per_lane_idx=True)
    assert c["idx"].shape == (TCFG.n_layers, 3)
    assert c["idx"].dtype == torch.int32
    assert TT.init_cache(TCFG, 3, 8, device="cpu")["idx"].shape == (
        TCFG.n_layers,)
    with pytest.raises(ValueError, match="requires a KV cache"):
        TT.forward(TorchOps(), params[1], TCFG,
                   torch.zeros(3, 1, dtype=torch.long),
                   q_offset=torch.zeros(3, dtype=torch.int32))


def _jax_backend(case):
    if case == "plain":
        return JOps(jnp.float32, jnp.float32)
    return jbatching.make_backend(
        jserve.ServeConfig(arch="qwen2_7b", batch=3, max_seq=MAX_SEQ,
                           **BACKENDS[case]), unrolled=True)


def _attn_k(case):
    return {"format": FMT_MAP["layer*/attn"]["k"],
            "mixed": 9}.get(case)


@pytest.mark.parametrize("case", sorted(BACKENDS))
def test_ragged_forward_matches_jax(params, case):
    """A per-lane prefill (q_offset zeros, S = 8) and four ragged decode
    steps with the lanes pinned at lengths 3, 8 and 5, through both
    packages, each greedy on its own tokens."""
    jp, tp = params
    jbk, tbk = _jax_backend(case), tbatching.make_backend(_sc(case))
    B, S = 3, 24
    toks = np.random.RandomState(4).randint(0, JCFG.vocab, (B, 8))
    jfwd = jax.jit(lambda p, c, t, o: JT.forward(jbk, p, JCFG, t, cache=c,
                                                 q_offset=o))
    jc = JT.init_cache(JCFG, B, S, jnp.float32, per_lane_idx=True)
    tc = TT.init_cache(TCFG, B, S, device="cpu", per_lane_idx=True)
    zeros = np.zeros(B, np.int32)
    jl, jc = jfwd(jp, jc, jnp.asarray(toks), jnp.asarray(zeros))
    with torch.no_grad():
        tl, tc = TT.forward(tbk, tp, TCFG, torch.from_numpy(toks), cache=tc,
                            q_offset=torch.from_numpy(zeros))
    steps = [(np.asarray(jl), tl.numpy(), jc,
              {k: v.clone() for k, v in tc.items()})]
    lengths = np.array([3, 8, 5], np.int32)
    jt = jl[jnp.arange(B), lengths - 1].argmax(-1)
    tt = tl[torch.arange(B), torch.from_numpy(lengths).long() - 1].argmax(-1)
    for i in range(4):
        offs = lengths + i
        jc = {**jc, "idx": jnp.broadcast_to(jnp.asarray(offs)[None],
                                            jc["idx"].shape)}
        tc = {**tc, "idx": torch.from_numpy(offs)[None].expand(
            TCFG.n_layers, B).clone()}
        jl, jc = jfwd(jp, jc, jt[:, None], jnp.asarray(offs))
        with torch.no_grad():
            tl, tc = TT.forward(tbk, tp, TCFG, tt[:, None], cache=tc,
                                q_offset=torch.from_numpy(offs))
        steps.append((np.asarray(jl), tl.numpy(), jc,
                      {k: v.clone() for k, v in tc.items()}))
        jt, tt = jl[:, -1].argmax(-1), tl[:, -1].argmax(-1)

    k_attn = _attn_k(case)
    for i, (jl, tl, jc, tc) in enumerate(steps):
        rows = (jl[np.arange(B), lengths - 1] if i == 0 else jl[:, -1])
        assert np.array_equal(rows.argmax(-1), (
            tl[np.arange(B), lengths - 1] if i == 0 else tl[:, -1]
        ).argmax(-1)), (i, top1_gap(rows))
        np.testing.assert_allclose(tl, jl, rtol=0,
                                   atol=2e-6 if k_attn is None else 1e-3)
        assert np.array_equal(np.asarray(jc["idx"]), tc["idx"].numpy())
        for name in ("k", "v"):
            want, got = np.asarray(jc[name]), tc[name].numpy()
            if k_attn is None:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
            else:
                u = 2.0 ** (1 - k_attn)
                np.testing.assert_allclose(
                    got, want, rtol=u, atol=u * float(np.abs(want).max()))


def test_fused_decode_gets_per_lane_lengths(params, monkeypatch):
    """Under a format map every ragged decode step offers each layer's
    attention to the certified decode kernel with the lanes' own lengths
    (int32, contiguous), idle lanes at 1."""
    _, tp = params
    seen = []
    real = tserve.certified_decode_attention

    def spy(q, k, v, lengths, fmt, **kw):
        assert lengths.dtype == torch.int32 and lengths.is_contiguous()
        seen.append(lengths.tolist())
        return real(q, k, v, lengths, fmt, **kw)

    monkeypatch.setattr(tserve, "certified_decode_attention", spy)
    eng = _engine(_sc("format"), tp)
    eng.run([tbatching.Request(rid=0, prompt=[1] * 9, max_new_tokens=5),
             tbatching.Request(rid=1, prompt=[2] * 5, max_new_tokens=5,
                               arrival_step=2)])
    assert len(seen) == TCFG.n_layers * eng.steps
    assert any(len(set(l)) == 3 for l in seen)      # two lanes and an idle
    assert all(min(l) >= 1 for l in seen)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(BACKENDS))
def test_engine_matches_reference_generate(params, case):
    """Staggered arrivals, prompts of 5-12 tokens (prefills padded to
    pages of 8), more requests than lanes."""
    _, tp = params
    sc = _sc(case)
    eng = _engine(sc, tp)
    reqs = _requests(5, seed=1, stride=2)
    responses = eng.run(reqs)
    assert len(responses) == 5
    assert eng.free_pages == eng.total_pages
    assert all(l is None for l in eng.lanes)
    _assert_matches_reference(sc, tp, responses, reqs)


def test_eos_recycles_lane_early(params):
    _, tp = params
    sc = _sc("format")
    prompt = np.random.RandomState(5).randint(0, TCFG.vocab, 6).tolist()
    free_run = tbatching.reference_generate(TCFG, sc, tp, prompt, 8,
                                            max_seq=MAX_SEQ)
    eos = free_run[2]
    stop = free_run.index(eos) + 1
    eng = _engine(sc, tp, n_lanes=1, eos_id=eos)
    reqs = [tbatching.Request(rid=0, prompt=prompt, max_new_tokens=8)]
    reqs += _requests(3, seed=6, max_new=4)[1:]
    responses = eng.run(reqs)
    first = next(r for r in responses if r["id"] == 0)
    assert first["tokens"] == free_run[:stop]       # stopped AT the eos
    assert stop < 8
    assert [r["id"] for r in responses] == [0, 1, 2]
    assert {r["lane"] for r in responses} == {0}    # the lane was recycled
    assert eng.free_pages == eng.total_pages
    _assert_matches_reference(sc, tp, responses, reqs, eos_id=eos)


def test_page_bounded_fifo_and_rejections(params):
    """The head of the queue waits for pages with a lane free, and the
    request behind it, which would fit, does not overtake it."""
    _, tp = params
    sc = _sc("plain")
    reg = obs.MetricsRegistry()
    eng = _engine(sc, tp, n_lanes=3, total_pages=4, queue_depth=3,
                  registry=reg)
    big = tbatching.Request(rid=0, prompt=[3] * 20, max_new_tokens=4)   # 3
    head = tbatching.Request(rid=1, prompt=[4] * 12, max_new_tokens=4)  # 2
    small = tbatching.Request(rid=2, prompt=[5] * 4, max_new_tokens=2)  # 1
    assert not eng.submit(tbatching.Request(rid=9, prompt=[1] * 40,
                                            max_new_tokens=20))
    assert not eng.submit(tbatching.Request(rid=8, prompt=[1] * 30,
                                            max_new_tokens=10))
    assert eng.submit(big) and eng.submit(head) and eng.submit(small)
    assert not eng.submit(tbatching.Request(rid=7, prompt=[1] * 4,
                                            max_new_tokens=2))
    assert reg.counters["serve.requests_rejected{reason=too_long}"] == 2
    assert reg.counters["serve.requests_rejected{reason=queue_full}"] == 1
    eng.step()
    assert [l.req.rid for l in eng.lanes if l is not None] == [0]
    assert [q.rid for q in eng.queue] == [1, 2]     # no head-of-line skip
    assert eng.page_waits >= 1
    responses = eng.run([])
    assert [r["id"] for r in responses] == [0, 2, 1]   # 1 and 2 together
    assert eng.free_pages == eng.total_pages == 4
    _assert_matches_reference(sc, tp, responses, [big, head, small])


def test_gauges_and_per_lane_histograms(params):
    _, tp = params
    reg = obs.MetricsRegistry()
    eng = _engine(_sc("plain"), tp, n_lanes=2, registry=reg)
    for r in _requests(2, seed=6, max_new=3, stride=0):
        assert eng.submit(r)
    eng.step()
    assert reg.gauges["serve.batch_occupancy"] == 1.0
    assert reg.gauges["serve.admission_queue_depth"] == 0.0
    assert reg.gauges["serve.kv_pages_free"] == eng.total_pages - sum(
        l.pages for l in eng.lanes)
    eng.run([])
    assert reg.gauges["serve.batch_occupancy"] == 0.0
    assert reg.gauges["serve.decode_tokens_per_s"] > 0
    for lane in (0, 1):
        assert reg.histograms[f"serve.decode_latency_s{{lane={lane}}}"
                              ].count >= 1
    assert reg.histograms["serve.decode_latency_s"].count == eng.steps
    assert reg.histograms["serve.prefill_latency_s"].count == 2
    assert reg.counters["serve.requests_admitted"] == 2
    assert reg.counters["serve.requests_completed"] == 2
    assert reg.counters["serve.tokens"] == eng.decode_tokens == 4
    prom = reg.render_prometheus()
    assert 'serve_decode_latency_s_bucket{lane="0",le=' in prom


def test_responses_carry_certificate_bars(params):
    class _Set:
        params_digest = "deadbeef"

        def error_bars(self):
            return {"dbar": 1.5e-3, "ebar": 2.0e-4, "k": 12}

    _, tp = params
    eng = _engine(tserve.ServeConfig(device="cpu", precision_k=12), tp,
                  n_lanes=1, certset=_Set())
    responses = eng.run(_requests(2, seed=7, max_new=2, stride=0))
    assert len(responses) == 2
    for r in responses:
        assert r["certificate"] == {"dbar": 1.5e-3, "ebar": 2.0e-4, "k": 12,
                                    "params_digest": "deadbeef"}


@pytest.mark.parametrize("case", sorted(BACKENDS))
@pytest.mark.parametrize("P", [3, 6, 13])
def test_padded_prefill_bitwise_equals_unpadded(params, case, P):
    """Pad columns are causally masked: the real rows' logits and cache
    entries of a prompt padded to 16 equal the unpadded prefill's bit for
    bit (PyTorch's CPU GEMM keeps a row's bits from three rows on)."""
    _, tp = params
    bk = tbatching.make_backend(_sc(case))
    toks = np.random.RandomState(8 + P).randint(0, TCFG.vocab, P)
    padded = np.zeros(16, np.int64)
    padded[:P] = toks
    out = []
    for t in (toks, padded):
        c = TT.init_cache(TCFG, 1, 32, device="cpu", per_lane_idx=True)
        with torch.no_grad():
            lg, c = TT.forward(bk, tp, TCFG, torch.from_numpy(t[None]),
                               cache=c,
                               q_offset=torch.zeros(1, dtype=torch.int32))
        out.append((lg[0, :P], c["k"][:, :, :P], c["v"][:, :, :P]))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", sorted(BACKENDS))
def test_engine_tokens_equal_jax_engine(params, case):
    """The same requests through the JAX engine and the port's: equal
    tokens, request by request."""
    jp, tp = params
    jsc = jserve.ServeConfig(arch="qwen2_7b", batch=3, max_seq=MAX_SEQ,
                             **BACKENDS[case])
    jreqs = [jbatching.Request(rid=r.rid, prompt=r.prompt,
                               max_new_tokens=r.max_new_tokens,
                               arrival_step=r.arrival_step)
             for r in _requests(4, seed=3, stride=2)]
    jeng = jbatching.ContinuousBatchingEngine(JCFG, jsc, jp, n_lanes=3,
                                              max_seq=MAX_SEQ, page_size=8)
    want = {r["id"]: r["tokens"] for r in jeng.run(jreqs)}
    eng = _engine(_sc(case), tp, keep_logits=True)
    got = eng.run(_requests(4, seed=3, stride=2))
    assert len(got) == len(want) == 4
    for r in got:
        w = want[r["id"]]
        if r["tokens"] != w:
            i = next(j for j, (a, b) in enumerate(zip(r["tokens"], w))
                     if a != b)
            gap = top1_gap(r["logits"][i:i + 1].numpy())[0]
            pytest.fail(f"request {r['id']}: tokens {r['tokens']} vs JAX "
                        f"{w}; first difference at {i}, port top-1 gap "
                        f"{gap:.3g}")


def test_engine_guards(params, monkeypatch):
    _, tp = params
    with pytest.raises(ValueError, match="whole number of pages"):
        _engine(_sc("plain"), tp, max_seq=50)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbatching.ContinuousBatchingEngine(TCFG, _sc("plain"), tp)


def test_main_without_cuda_raises_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbatching.main(["--requests", "2"])
    metrics, prom = tmp_path / "m.jsonl", tmp_path / "m.prom"
    eng, responses = tbatching.main([
        "--device", "cpu", "--requests", "3", "--max-new", "3",
        "--lanes", "2", "--max-seq", "32", "--page-size", "8",
        "--check-ref", "--metrics", str(metrics), "--prom", str(prom)])
    assert sorted(r["id"] for r in responses) == [0, 1, 2]
    assert all(len(r["tokens"]) == 3 for r in responses)
    assert '"serve.requests_completed": 3' in metrics.read_text()
    assert "serve_requests_completed 3" in prom.read_text()
    with pytest.raises(SystemExit):
        tbatching.main(["--device", "cpu", "--certify-formats"])


# ---------------------------------------------------------------------------
# the recurrent families: Hymba's Mamba state per lane, RWKV refused
# ---------------------------------------------------------------------------

HYMBA = "hymba_1p5b"
HYMBA_PROMPTS = (5, 21)          # off the page grid of 8, one past the window


@pytest.fixture(scope="module")
def hymba_params():
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs
    from repro_torch.convert import params_from_numpy

    jcfg, tcfg = jconfigs.get(HYMBA).SMOKE, tconfigs.get(HYMBA).SMOKE
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


def _jax_alone(jcfg, jp, prompt, max_new):
    """The JAX package's ``reference_generate`` loop (batch 1, unpadded
    prefill, the unrolled backend), keeping each step's logit row."""
    jsc = jserve.ServeConfig(arch=HYMBA, batch=1, max_seq=MAX_SEQ)
    bk = jbatching.make_backend(jsc, mesh=None, unrolled=True)
    cache = JT.init_cache(jcfg, 1, MAX_SEQ, jnp.float32, per_lane_idx=True)
    logits, cache = JT.forward(bk, jp, jcfg, jnp.asarray([prompt]),
                               cache=cache,
                               q_offset=jnp.zeros((1,), jnp.int32))
    rows = [np.asarray(logits[0, -1])]
    while len(rows) < max_new:
        tok = int(np.argmax(rows[-1]))
        offs = jnp.asarray([len(prompt) + len(rows) - 1], jnp.int32)
        logits, cache = JT.forward(bk, jp, jcfg, jnp.asarray([[tok]]),
                                   cache=cache, q_offset=offs)
        rows.append(np.asarray(logits[0, -1]))
    return np.stack(rows)


@pytest.mark.parametrize("n_lanes", (1, 2))
def test_hymba_engine_matches_reference_generate(hymba_params, n_lanes):
    """Hymba SMOKE through the port's engine, prompts of 5 and 21 tokens
    (not whole pages of 8; 21 is past the window of 16), the second
    arriving while the first decodes: each request's tokens equal the JAX
    package's ``reference_generate``'s and the port's own request alone's.
    With one lane the second request reuses the first's lane, whose Mamba
    state it must start from zero again: its logits equal the port's
    request alone bit for bit and are within 2e-6 of the JAX request alone
    (the plain tolerance of ``check_steps``). With two lanes the CPU's
    library products give a decode row other bits than alone (the module
    docstring; up to 2.0e-6 here), so tokens are held here and the
    lane-bit contract on the card (``tests/test_torch_batching_cuda.py``)."""
    jcfg, jp, tcfg, tp = hymba_params
    sc = tserve.ServeConfig(arch=HYMBA, device="cpu", max_seq=MAX_SEQ)
    rng = np.random.RandomState(7)
    reqs = [tbatching.Request(rid=i, prompt=rng.randint(
        0, tcfg.vocab, n).tolist(), max_new_tokens=6, arrival_step=i)
        for i, n in enumerate(HYMBA_PROMPTS)]
    eng = tbatching.ContinuousBatchingEngine(
        tcfg, sc, tp, n_lanes=n_lanes, max_seq=MAX_SEQ, page_size=8,
        device="cpu", keep_logits=True)
    responses = eng.run(reqs)
    assert sorted(r["id"] for r in responses) == [0, 1]
    jsc = jserve.ServeConfig(arch=HYMBA, batch=1, max_seq=MAX_SEQ)
    for r in responses:
        req = reqs[r["id"]]
        assert r["tokens"] == jbatching.reference_generate(
            jcfg, jsc, jp, req.prompt, req.max_new_tokens, max_seq=MAX_SEQ)
        toks, rows = tbatching.reference_generate(
            tcfg, sc, tp, req.prompt, req.max_new_tokens, max_seq=MAX_SEQ,
            return_logits=True)
        assert r["tokens"] == toks
        if n_lanes == 1:
            assert torch.equal(r["logits"], rows), r["id"]
            np.testing.assert_allclose(
                r["logits"].numpy(), _jax_alone(jcfg, jp, req.prompt,
                                                req.max_new_tokens),
                rtol=0, atol=2e-6)


def test_hymba_prefill_state_is_the_unpadded_prefills(hymba_params):
    """The port's engine prefills a Hymba prompt unpadded into a zeroed
    state: the lane's h_ssm equals an unpadded batch-1 prefill's bit for
    bit, though the lane held another request's state before."""
    _, _, tcfg, tp = hymba_params
    sc = tserve.ServeConfig(arch=HYMBA, device="cpu", max_seq=MAX_SEQ)
    eng = tbatching.ContinuousBatchingEngine(
        tcfg, sc, tp, n_lanes=2, max_seq=MAX_SEQ, page_size=8, device="cpu")
    eng.cache["h_ssm"].normal_(generator=torch.Generator().manual_seed(0))
    prompt = np.random.RandomState(8).randint(0, tcfg.vocab, 5).tolist()
    with torch.no_grad():
        eng._prefill(1, prompt)
        cache = TT.init_cache(tcfg, 1, MAX_SEQ, device="cpu",
                              per_lane_idx=True)
        TT.forward(eng.bk, tp, tcfg, torch.tensor([prompt]), cache=cache,
                   q_offset=torch.zeros(1, dtype=torch.int32))
    assert torch.equal(eng.cache["h_ssm"][:, 1:2], cache["h_ssm"])
    assert torch.equal(eng.cache["k"][:, 1:2, :5], cache["k"][:, :, :5])


def test_jax_engine_padded_prefill_runs_pads_into_the_mamba_state(
        hymba_params):
    """The reference fault the port does not copy: the JAX engine prefills
    a request padded to whole pages and takes that for the unpadded prefill
    because "pad columns are causally masked"; the pad tokens run through
    Mamba's scan into h_ssm all the same. A 5-token prompt padded to a page
    of 16 (the engine's own prefill function): its h_ssm is not the
    unpadded prompt's (SMOKE, seed 0)."""
    jcfg, jp, _, _ = hymba_params
    jsc = jserve.ServeConfig(arch=HYMBA, batch=2, max_seq=MAX_SEQ)
    eng = jbatching.ContinuousBatchingEngine(jcfg, jsc, jp, n_lanes=2,
                                             max_seq=MAX_SEQ, page_size=16)
    prompt = np.random.RandomState(9).randint(0, jcfg.vocab, 5)
    padded = np.zeros((1, 16), np.int32)
    padded[0, :5] = prompt
    _, sl_pad = eng._prefill(eng.params, jnp.asarray(padded),
                             jnp.asarray(5, jnp.int32))
    _, sl_one = eng._prefill(eng.params, jnp.asarray(prompt[None, :]),
                             jnp.asarray(5, jnp.int32))
    h_pad, h_one = np.asarray(sl_pad["h_ssm"]), np.asarray(sl_one["h_ssm"])
    assert float(np.abs(h_pad - h_one).max()) > 1e-3 * float(
        np.abs(h_one).max())
    # the keys of the prompt's positions agree: the fault is the state's
    np.testing.assert_allclose(np.asarray(sl_pad["k"])[:, :, :5],
                               np.asarray(sl_one["k"])[:, :, :5],
                               rtol=0, atol=1e-6)


def test_engines_refuse_rwkv():
    """RWKV has no indexed KV cache (its context is a recurrent state):
    both engines raise NotImplementedError."""
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs

    arch = "rwkv6_1p6b"
    jcfg, tcfg = jconfigs.get(arch).SMOKE, tconfigs.get(arch).SMOKE
    with pytest.raises(NotImplementedError, match="indexed KV cache"):
        jbatching.ContinuousBatchingEngine(
            jcfg, jserve.ServeConfig(arch=arch, batch=2, max_seq=MAX_SEQ),
            JT.init_params(jax.random.PRNGKey(0), jcfg), n_lanes=2,
            max_seq=MAX_SEQ)
    tp = TT.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="indexed KV cache"):
        tbatching.ContinuousBatchingEngine(
            tcfg, tserve.ServeConfig(arch=arch, device="cpu"), tp,
            n_lanes=2, max_seq=MAX_SEQ, device="cpu")
