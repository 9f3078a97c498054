"""Continuous batching on a card: a lane's bits do not depend on the batch.

These tests need a CUDA device and skip without one; they import nothing of
JAX, so they run on a machine that has only PyTorch:
``python -m pytest -q --noconftest -m cuda tests/test_torch_batching_cuda.py``.

* One ragged decode step at SMOKE width, 4 lanes at lengths 1, 17, 64 and
  65 with every stale cache position NaN: the outputs of the format GEMM
  (kernel 1) and of the certified decode attention (kernel 2) for each lane
  equal, bit for bit, those of the same lane run alone at B = 1, whatever
  its place in the batch.
* The engine's tokens equal ``reference_generate``'s, request by request,
  under the format map (kernels 1 and 2), a uniform k (kernel 3) and the
  plain backend.
* The library products on the engine's path (``chip_smoke.
  library_lane_bits``): the ones the card keeps lane-invariant are asserted
  here; the others are named in ROADMAP §3.
* At Qwen2-7B's full width (depth cut to 2 layers), EVERY op of one ragged
  decode step on the format path (``chip_smoke.op_lane_bits``: kernels 1
  and 2, the rmsnorm's mean through ``row_mean``, the LM head through
  ``f32_matmul``, the elementwise ops) gives each lane the bits it gives
  alone; and on the format path the engine's logits equal
  ``reference_generate``'s bit for bit.
* The same on the k path (``QuantJOps``: kernel 3, and the decode attention
  of ``TorchOps.decode_attention`` through kernel 4) and on the plain
  backend (``TorchOps.matmul`` through ``f32_matmul``, reading the stacked
  weights where they lie); outside kernel 4's limits the card path raises.
  On the CPU, ``TorchOps.decode_attention`` returns None (the composed path
  the CPU tests hold against the reference) and ``TorchOps.matmul`` is
  ``torch.matmul`` (an unmarked test).
"""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.launch import batching, serve
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]
CFG = configs.get("qwen2_7b").SMOKE
FMT = {"": {"k": 11, "emax": 15, "emin": -14},
       "layer*/attn": {"k": 8, "emax": 15, "emin": -14},
       "layer1": {"k": 9, "emax": 15, "emin": -14}}
LENGTHS = [1, 17, 64, 65]
SMAX = 96


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    serve.configure_precision()
    return torch.device("cuda")


def _params(dev):
    return T.init_params(CFG, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)


def _poisoned_cache(dev, lengths):
    """A per-lane cache whose lane b holds seeded values below
    ``lengths[b] - 1`` (the step writes that position) and NaN from
    ``lengths[b]`` on."""
    gen = torch.Generator(device=dev).manual_seed(1)
    c = T.init_cache(CFG, len(lengths), SMAX, device=dev, per_lane_idx=True)
    for name in ("k", "v"):
        c[name].normal_(generator=gen)
        for b, n in enumerate(lengths):
            c[name][:, b, n:] = float("nan")
    return c


def _step(bk, params, cache, tokens, lengths, dev):
    """One ragged decode step (lane b at offset lengths[b] - 1); returns
    the outputs of every kernel-1 and kernel-2 call, in order."""
    outs = {"gemm": [], "attn": []}
    d_qmm, d_fd = serve.quant_matmul_format_dispatch, \
        serve.certified_decode_attention

    def spy_qmm(*a, **kw):
        outs["gemm"].append(d_qmm(*a, **kw))
        return outs["gemm"][-1]

    def spy_fd(*a, **kw):
        outs["attn"].append(d_fd(*a, **kw))
        return outs["attn"][-1]

    offs = torch.tensor(lengths, dtype=torch.int32, device=dev) - 1
    cache["idx"].copy_(offs[None, :].expand_as(cache["idx"]))
    serve.quant_matmul_format_dispatch = spy_qmm
    serve.certified_decode_attention = spy_fd
    try:
        with torch.no_grad():
            T.forward(bk, params, CFG, tokens[:, None], cache=cache,
                      q_offset=offs)
    finally:
        serve.quant_matmul_format_dispatch = d_qmm
        serve.certified_decode_attention = d_fd
    return outs


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("order", [(0, 1, 2, 3), (3, 1, 0, 2)])
def test_ragged_step_lane_bits_equal_lane_alone(cuda_device, order):
    dev = cuda_device
    params = _params(dev)
    bk = serve.FormatQuantJOps(FMT)
    lengths = [LENGTHS[i] for i in order]
    tokens = torch.tensor([5, 17, 99, 3], device=dev)[list(order)]
    batch = _step(bk, params, _poisoned_cache(dev, lengths), tokens,
                  lengths, dev)
    assert len(batch["gemm"]) == 7 * CFG.n_layers
    assert len(batch["attn"]) == CFG.n_layers
    full = _poisoned_cache(dev, lengths)
    for b, n in enumerate(lengths):
        one = {name: full[name][:, b:b + 1].clone() for name in ("k", "v")}
        one["idx"] = torch.zeros((CFG.n_layers, 1), dtype=torch.int32,
                                 device=dev)
        alone = _step(bk, params, one, tokens[b:b + 1], [n], dev)
        for kind in ("gemm", "attn"):
            for got, want in zip(batch[kind], alone[kind]):
                assert torch.isfinite(got[b]).all()
                assert torch.equal(_bits(got[b:b + 1]), _bits(want)), (
                    kind, b, n)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["format", "k", "plain"])
def test_engine_matches_reference_generate_on_card(cuda_device, case):
    dev = cuda_device
    params = _params(dev)
    sc = serve.ServeConfig(device="cuda", max_seq=64, **{
        "format": {"precision_layer_format": FMT},
        "k": {"precision_k": 12}, "plain": {}}[case])
    gen = torch.Generator().manual_seed(2)
    reqs = [batching.Request(
        rid=i, prompt=torch.randint(0, CFG.vocab, (int(n),),
                                    generator=gen).tolist(),
        max_new_tokens=8, arrival_step=2 * i)
        for i, n in enumerate(torch.randint(3, 40, (6,), generator=gen))]
    eos = batching.reference_generate(CFG, sc, params, reqs[1].prompt, 8,
                                      max_seq=64)[2]
    eng = batching.ContinuousBatchingEngine(
        CFG, sc, params, n_lanes=4, max_seq=64, page_size=16,
        total_pages=12, eos_id=eos)
    responses = eng.run(reqs)
    assert sorted(r["id"] for r in responses) == list(range(6))
    for req in reqs:
        got = next(r["tokens"] for r in responses if r["id"] == req.rid)
        want = batching.reference_generate(CFG, sc, params, req.prompt,
                                           req.max_new_tokens, max_seq=64,
                                           eos_id=eos)
        assert got == want, (req.rid, got, want)


@pytest.mark.cuda
def test_engine_format_logits_bitwise_equal_reference_generate(cuda_device):
    dev = cuda_device
    params = _params(dev)
    sc = serve.ServeConfig(device="cuda", max_seq=64,
                           precision_layer_format=FMT)
    gen = torch.Generator().manual_seed(4)
    reqs = [batching.Request(
        rid=i, prompt=torch.randint(0, CFG.vocab, (int(n),),
                                    generator=gen).tolist(),
        max_new_tokens=6, arrival_step=i)
        for i, n in enumerate(torch.randint(3, 40, (5,), generator=gen))]
    eng = batching.ContinuousBatchingEngine(
        CFG, sc, params, n_lanes=4, max_seq=64, page_size=16,
        keep_logits=True)
    for r in eng.run(reqs):
        req = reqs[r["id"]]
        toks, rows = batching.reference_generate(
            CFG, sc, params, req.prompt, req.max_new_tokens, max_seq=64,
            return_logits=True)
        assert r["tokens"] == toks
        assert torch.equal(_bits(r["logits"]), _bits(rows)), r["id"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k", "plain"])
def test_engine_k_and_plain_logits_bitwise_equal_reference_generate(
        cuda_device, case):
    dev = cuda_device
    params = _params(dev)
    sc = serve.ServeConfig(device="cuda", max_seq=64, **{
        "k": {"precision_k": 12}, "plain": {}}[case])
    gen = torch.Generator().manual_seed(4)
    reqs = [batching.Request(
        rid=i, prompt=torch.randint(0, CFG.vocab, (int(n),),
                                    generator=gen).tolist(),
        max_new_tokens=6, arrival_step=i)
        for i, n in enumerate(torch.randint(3, 40, (5,), generator=gen))]
    eng = batching.ContinuousBatchingEngine(
        CFG, sc, params, n_lanes=4, max_seq=64, page_size=16,
        keep_logits=True)
    for r in eng.run(reqs):
        req = reqs[r["id"]]
        toks, rows = batching.reference_generate(
            CFG, sc, params, req.prompt, req.max_new_tokens, max_seq=64,
            return_logits=True)
        assert r["tokens"] == toks
        assert torch.equal(_bits(r["logits"]), _bits(rows)), r["id"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k", "plain"])
def test_k_and_plain_step_every_op_lane_bits_at_full_width(cuda_device,
                                                           case):
    """Every op of one ragged decode step at Qwen2-7B's width (2 layers):
    the k path's decode attention goes through kernel 4, the plain
    backend's matmuls through ``f32_matmul`` on the weights as they lie."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import row_order as ro

    cfg = dataclasses.replace(configs.get("qwen2_7b").FULL, n_layers=2)
    params = T.init_params(cfg, generator=torch.Generator(
        device=cuda_device).manual_seed(0), device=cuda_device)
    bk = serve.QuantJOps(12) if case == "k" else serve.TorchOps()
    stacked = [(t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
               for g in ("attn", "mlp") for t in params["layers"][g].values()
               if t.dim() == 3]
    seen = {"attn": 0, "mm": []}
    d_fd, d_mm = fd.flash_decode_attention, ro.f32_matmul

    def spy_fd(*a, **kw):
        seen["attn"] += 1
        return d_fd(*a, **kw)

    def spy_mm(x, w):
        seen["mm"].append((w.data_ptr(), w.is_contiguous()))
        return d_mm(x, w)

    # the wrappers count their launches under their module-level names
    spy_fd.launches = spy_mm.launches = 0
    fd.flash_decode_attention, ro.f32_matmul = spy_fd, spy_mm
    try:
        got = chip_smoke.op_lane_bits(torch, serve, T, cfg, params, bk)
    finally:
        fd.flash_decode_attention, ro.f32_matmul = d_fd, d_mm
    print(got)
    assert got["ops"] > 0 and got["differing"] == [], got["differing"]
    assert {"decode_attention", "matmul"} <= set(got["by_op"])
    assert seen["attn"] > 0
    if case == "plain":
        # every projection reads its weights in place: a contiguous view
        # into the layer's slice of a stacked parameter (5 forwards: the
        # batch, then each of the 4 lanes alone; the LM head reads its
        # transposed table)
        in_place = [c for p, c in seen["mm"]
                    if any(lo <= p < hi for lo, hi in stacked)]
        assert len(in_place) == 5 * 7 * cfg.n_layers and all(in_place)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2, 9, 260), (1, 2, 4, 257),
                                   (1, 2, 16, 512)])
def test_card_decode_attention_raises_outside_kernel_limits(cuda_device,
                                                            shape):
    """Kernel 4 takes any G and D (these head dims above 256 run through
    its wide instance); outside its limits, an empty cache or f64, the
    card's path raises (no fallback to the composed attention)."""
    B, K, G, D = shape
    q = torch.zeros(shape, device=cuda_device)
    k = torch.zeros((B, 32, K, D), device=cuda_device)
    lengths = torch.ones(B, dtype=torch.int32, device=cuda_device)
    out = serve.TorchOps().decode_attention(q, k, k.clone(), lengths)
    assert out.shape == shape and bool((out == 0).all())
    with pytest.raises(ValueError):
        serve.TorchOps().decode_attention(q, k[:, :0], k[:, :0], lengths)
    with pytest.raises(ValueError):           # f64 is outside them
        serve.TorchOps(torch.float64).decode_attention(
            q[..., :64].double(), k[..., :64].double(),
            k[..., :64].double(), lengths)


def test_cpu_decode_attention_composes_and_matmul_is_the_library():
    """On the CPU nothing reroutes: the fused hook returns None (the
    composed path) and ``matmul`` equals ``torch.matmul`` bit for bit."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(2, 2, 4, 16, generator=gen)
    k = torch.randn(2, 8, 2, 16, generator=gen)
    lengths = torch.tensor([3, 8], dtype=torch.int32)
    for bk in (serve.TorchOps(), serve.QuantJOps(12)):
        assert bk.decode_attention(q, k, k, lengths) is None
    x, w = torch.randn(3, 5, 64, generator=gen), torch.randn(64, 32,
                                                             generator=gen)
    assert torch.equal(_bits(serve.TorchOps().matmul(x, w)),
                       _bits(torch.matmul(x, w)))


@pytest.mark.cuda
def test_format_step_every_op_lane_bits_at_full_width(cuda_device):
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    cfg = dataclasses.replace(configs.get("qwen2_7b").FULL, n_layers=2)
    params = T.init_params(cfg, generator=torch.Generator(
        device=cuda_device).manual_seed(0), device=cuda_device)
    bk = serve.FormatQuantJOps(
        {"": {"k": 12, "emax": 15, "emin": -14},
         "layer*/mlp": {"k": 10, "emax": 15, "emin": -14}})
    got = chip_smoke.op_lane_bits(torch, serve, T, cfg, params, bk)
    print(got)
    assert got["ops"] > 0 and got["differing"] == [], got["differing"]
    assert {"mean", "einsum", "matmul", "decode_attention"} <= set(
        got["by_op"])


# which library products on the engine's path keep a lane's bits on the
# card (chip_smoke.library_lane_bits: 4 lanes against each alone, a prompt
# of 83 rows padded to 96 against the unpadded one; NVIDIA H100 80GB HBM3,
# torch 2.11 + CUDA 12.8). At SMOKE width only the LM head at decode does
# not; at Qwen2-7B's width no decode-shaped product does (named in ROADMAP
# §3), while every prefill-shaped one and the softmax do.
PREFILL = ("lm_head_prefill", "scores_prefill", "pv_prefill",
           "softmax_prefill", "mean_square_prefill")
DECODE = ("lm_head_decode", "scores_decode", "pv_decode", "softmax_decode",
          "mean_square_decode")
LANE_INVARIANT = {
    "smoke": tuple(n for n in PREFILL + DECODE if n != "lm_head_decode")
    + tuple(f"matmul_{w}_n{n}" for w in ("decode", "prefill")
            for n in (32, 64, 128)),
    "full": PREFILL + ("softmax_decode",)
    + tuple(f"matmul_prefill_n{n}" for n in (512, 3584, 18944)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("size", sorted(LANE_INVARIANT))
def test_library_products_lane_invariance(cuda_device, size):
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    cfg = getattr(configs.get("qwen2_7b"), size.upper())
    got = chip_smoke.library_lane_bits(torch, cfg, device="cuda")
    print(size, got)
    held = {k for k, v in got.items() if v["bitwise"]}
    assert held == set(LANE_INVARIANT[size]), (
        sorted(held ^ set(LANE_INVARIANT[size])))


# Hymba (windowed attention beside Mamba heads): a lane's Mamba state is its
# own; the engine prefills such a request unpadded into a zeroed state
HYMBA = configs.get("hymba_1p5b").SMOKE
HYMBA_FMT = {"": {"k": 11, "emax": 15, "emin": -14},
             "layer*": {"k": 10, "emax": 15, "emin": -14},
             "layer*/attn": {"k": 8, "emax": 15, "emin": -14}}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["format", "k", "plain"])
def test_hymba_engine_logits_bitwise_equal_reference_generate(cuda_device,
                                                              case):
    """Hymba SMOKE batched on the card, 4 lanes, prompts off the page grid
    (lengths 5, 21, 30, 37 with pages of 16) and past the window of 16:
    each request's tokens and logits bit for bit the request alone."""
    dev = cuda_device
    params = T.init_params(HYMBA, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    sc = serve.ServeConfig(arch="hymba_1p5b", device="cuda", max_seq=64, **{
        "format": {"precision_layer_format": HYMBA_FMT},
        "k": {"precision_k": 12}, "plain": {}}[case])
    gen = torch.Generator().manual_seed(6)
    reqs = [batching.Request(
        rid=i, prompt=torch.randint(0, HYMBA.vocab, (n,),
                                    generator=gen).tolist(),
        max_new_tokens=8, arrival_step=i)
        for i, n in enumerate((5, 21, 30, 37, 9, 17))]
    eng = batching.ContinuousBatchingEngine(
        HYMBA, sc, params, n_lanes=4, max_seq=64, page_size=16,
        keep_logits=True)
    responses = eng.run(reqs)
    assert sorted(r["id"] for r in responses) == list(range(len(reqs)))
    for r in responses:
        req = reqs[r["id"]]
        toks, rows = batching.reference_generate(
            HYMBA, sc, params, req.prompt, req.max_new_tokens, max_seq=64,
            return_logits=True)
        assert r["tokens"] == toks
        assert torch.equal(_bits(r["logits"]), _bits(rows)), r["id"]


@pytest.mark.cuda
def test_hymba_step_every_op_and_state_lane_bits(cuda_device):
    """Every op of one ragged Hymba decode step on the format path (kernels
    1 and 4, the Mamba step's library pieces among them) and the Mamba
    state it leaves give each lane the bits it gives alone."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    params = T.init_params(HYMBA, generator=torch.Generator(
        device=cuda_device).manual_seed(0), device=cuda_device)
    got = chip_smoke.op_lane_bits(torch, serve, T, HYMBA, params,
                                  serve.FormatQuantJOps(HYMBA_FMT))
    assert got["ops"] > 0 and got["differing"] == [], got["differing"]
    assert got["state_differing"] == []
    assert {"windowed_decode_attention", "exp", "log", "input"} <= set(
        got["by_op"])


@pytest.mark.cuda
def test_mamba_library_pieces_keep_lane_bits_at_full_width(cuda_device):
    """The Mamba decode step's library pieces at Hymba 1.5B's widths (state
    update, ``einsum("bdn,bn->bd")``, softplus, decay): each lane's bits
    over 4 lanes are its bits alone (NVIDIA H100 80GB HBM3, torch 2.11 +
    CUDA 12.8), so they stay library calls."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    got = chip_smoke.mamba_lane_bits(torch, configs.get("hymba_1p5b").FULL)
    assert all(v["bitwise"] for v in got.values()), got

