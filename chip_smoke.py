#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py``. It builds the
port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc (into
``build/repro_torch/``), checks each against its plain PyTorch version on
the card at the shapes of full-width Qwen2-7B, serves full-width Qwen2-7B
(random weights from a seed) through the certified custom-format path, and
shows through the kernels' launch counters that serving ran through them.

Each phase prints one JSON object on a line of its own; a phase that fails
raises and the script exits non-zero. The last three lines are the kernels'
summary (``{"kernels": [...]}``), the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them, and ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repository beside it, the script exits non-zero and prints no
result. It imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

F32_TFLOPS = 67e12      # H100 SXM f32 outside the tensor cores (data sheet)
HBM_BYTES_S = 3.35e12   # H100 SXM HBM3 (data sheet)
FORMATS = {             # (k, emax, emin)
    "k24_e127": (24, 127, -126),
    "k12_e15": (12, 15, -14),
    "k8_e7": (8, 7, -6),
}
# Qwen2-7B's projections (K, N), d=3584, 28 q / 4 kv heads of 128, d_ff=18944
GEMM_SHAPES = {
    "wq": (3584, 3584), "wk": (3584, 512), "wv": (3584, 512),
    "wo": (3584, 3584), "w_gate": (3584, 18944), "w_up": (3584, 18944),
    "w_down": (18944, 3584),
}
SERVE_FORMAT = {
    "": {"k": 24, "emax": 127, "emin": -126},
    "layer*/attn": {"k": 12, "emax": 15, "emin": -14},
    "layer*/mlp": {"k": 10, "emax": 15, "emin": -14},
    "layer0/mlp": {"k": 16, "emax": 31, "emin": -30},
}
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 128, 16


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events,
    after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / F32_TFLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ulp_at_k(torch, a, k: int, emin: int):
    """Spacing of the k-bit grid at |a| (f64), never below the format's
    subnormal spacing 2^(emin-(k-1))."""
    _, e = torch.frexp(a.abs().double())
    return torch.ldexp(torch.ones_like(a, dtype=torch.float64),
                       (torch.clamp(e - 1, min=emin) - (k - 1)).double())


def compare(torch, got, want, fmt, pre_tol):
    """The tolerance stated for a kernel against its plain version: equal
    (NaN/inf alike), or |Δ| ≤ one ulp at k + ``pre_tol`` — the most the two
    sums can differ before the final rounding because they add in another
    order. Returns (ok, stats)."""
    k, _, emin = fmt
    g, w = got.double(), want.double()
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    diff = (g - w).abs()
    ulp = ulp_at_k(torch, torch.maximum(g.abs(), w.abs()), k, emin)
    ok_el = same | (diff <= ulp + pre_tol)
    finite = torch.isfinite(diff)
    stats = {
        "max_abs_err": float(diff[finite].max()) if finite.any() else 0.0,
        "frac_equal": float(same.double().mean()),
        "frac_within_1ulp": float((same | (diff <= ulp)).double().mean()),
        "max_ulps": float((diff[finite] / ulp[finite]).max())
        if finite.any() else 0.0,
        "n_bad": int((~ok_el).sum()),
    }
    return bool(ok_el.all()), stats


def phase_env(torch, serve):
    serve.configure_precision()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=nvidia_smi_line(),
         tf32=False, float32_matmul_precision="highest")


def phase_build(build):
    t0 = time.perf_counter()
    res = build.build(build.SOURCES, ptxas_verbose=True)
    for name, r in res.items():
        print(f"--- nvcc {name}\n{r['log']}", file=sys.stderr)
    emit("build", seconds=time.perf_counter() - t0,
         sources=list(build.SOURCES),
         per_source_s={n: r["seconds"] for n, r in res.items()})


def phase_rounding(torch, quantize, qmm):
    """quantize_to_format on the card (plain PyTorch and the kernels' device
    function) against the plain version on the CPU, bit for bit, over random
    f32 bit patterns with NaN, ±inf and carrier subnormals."""
    gen = torch.Generator().manual_seed(1)
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1, (1 << 20,),
                         dtype=torch.int64, generator=gen).to(torch.int32)
    sub = torch.randint(0, 1 << 23, (4096,), dtype=torch.int32, generator=gen)
    x = torch.cat([bits.view(torch.float32), sub.view(torch.float32),
                   -sub.view(torch.float32),
                   torch.tensor([float("nan"), float("inf"), -float("inf"),
                                 0.0, -0.0, 3.4028235e38, -3.4028235e38,
                                 1.1754944e-38, 1e-45])])
    xg = x.cuda()
    fmts = list(FORMATS.values()) + [(10, 15, -14), (16, 31, -30),
                                     (3, 3, -2), (8, 127, -126)]
    n_checked = 0
    for fmt in fmts:
        for subn in (True, False):
            for sat in (True, False):
                cpu = quantize.quantize_to_format(x, *fmt, subn, sat)
                gpu = quantize.quantize_to_format(xg, *fmt, subn, sat).cpu()
                dev = qmm.quantize_format_cuda(
                    xg, fmt, has_subnormals=subn, saturating=sat).cpu()
                for name, got in (("torch_cuda", gpu), ("device_fn", dev)):
                    bad = int((got.view(torch.int32)
                               != cpu.view(torch.int32)).sum())
                    if bad:
                        raise AssertionError(
                            f"rounding {name} {fmt} subn={subn} sat={sat}: "
                            f"{bad} values differ from the CPU bits")
                n_checked += 2 * x.numel()
    emit("rounding", values=x.numel(), formats=len(fmts), flag_combos=4,
         compared=n_checked, bitwise_equal=True)


def gemm_order_tol(torch, xq, wq):
    """What two f32 sums of the same K products may differ by before the
    final rounding when they add in other orders: 2·√K·u·(|x̂|@|ŵ|), u =
    2⁻²⁴. The rounding errors of a sum have random signs, so their spread
    grows as √K; the worst case K·u·(|x̂|@|ŵ|) is ~√K times looser and
    would hide a dropped K-tile."""
    K = xq.shape[-1]
    return (2.0 * math.sqrt(K) * 2.0 ** -24
            * torch.matmul(xq.abs().double(), wq.abs().double()))


def check_gemm(torch, qmm, x, w, fmt, flags=(True, True)):
    """Kernel against its plain version on the same card inputs, under
    the ulp rule plus :func:`gemm_order_tol`. Returns (kernel out, stats);
    raises on disagreement."""
    from repro_torch.core.quantize import quantize_to_format

    subn, sat = flags
    got = qmm.quant_matmul_format(x, w, fmt, has_subnormals=subn,
                                  saturating=sat)
    want = qmm.quant_matmul_format_ref(x, w, fmt, has_subnormals=subn,
                                       saturating=sat)
    tol = gemm_order_tol(torch, quantize_to_format(x, *fmt, subn, sat),
                         quantize_to_format(w, *fmt, subn, sat))
    ok, st = compare(torch, got, want, fmt, tol)
    beyond = (got.double() - want.double()).abs() - ulp_at_k(
        torch, torch.maximum(got.abs(), want.abs()), fmt[0], fmt[2])
    st["order_spread"] = float((beyond.clamp(min=0) / (tol / 2)).nan_to_num(
        0.0, posinf=0.0).max())
    if not ok:
        raise AssertionError(f"quant_matmul_format {tuple(x.shape)}@"
                             f"{tuple(w.shape)} {fmt}: {st}")
    return got, st


def phase_quant_matmul(torch, qmm):
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    rows = []
    n_exact = 0
    for proj, (K, N) in GEMM_SHAPES.items():
        # exactness: operands on a coarse grid (integers in [-3, 3] times
        # 2^-2 resp. 2^-3, exact in every format here), so every partial
        # sum is an exact f32 and any order gives the same bits
        wi = torch.randint(-3, 4, (K, N), device="cuda", generator=gen)
        w = wi.float() * 2.0 ** -3
        for M in (4, 512):
            x = torch.randint(-3, 4, (M, K), device="cuda",
                              generator=gen).float() * 2.0 ** -2
            for fname, fmt in FORMATS.items():
                got = qmm.quant_matmul_format(x, w, fmt)
                want = qmm.quant_matmul_format_ref(x, w, fmt)
                if not torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)):
                    n = int((got.view(torch.int32)
                             != want.view(torch.int32)).sum())
                    raise AssertionError(
                        f"quant_matmul_format {proj} M={M} {fname}: {n} "
                        "elements differ on exact-sum operands")
                n_exact += 1
        del wi, w, x
        w = torch.randn(K, N, device="cuda", generator=gen) / math.sqrt(K)
        for M in (4, 512):
            x = torch.randn(M, K, device="cuda", generator=gen)
            for fname, fmt in FORMATS.items():
                got, st = check_gemm(torch, qmm, x, w, fmt)
                worst = max(worst, st["max_abs_err"])
                row = {"proj": proj, "M": M, "K": K, "N": N,
                       "format": fname, **st}
                if M == 512 and fname == "k12_e15":
                    # row invariance: 7 rows alone == the same rows in 512
                    alone = qmm.quant_matmul_format(x[:7].contiguous(), w,
                                                    fmt)
                    if not torch.equal(alone.view(torch.int32),
                                       got[:7].view(torch.int32)):
                        raise AssertionError(
                            f"quant_matmul_format {proj}: 7 rows alone "
                            "differ from the same rows inside M=512")
                    row["row_invariant"] = True
                if fname == "k12_e15":
                    fmt12 = FORMATS["k12_e15"]
                    iters = 20 if M == 4 else 5
                    row["ms"] = time_ms(torch, lambda: qmm.quant_matmul_format(
                        x, w, fmt12), iters)
                    row["plain_ms"] = time_ms(
                        torch, lambda: qmm.quant_matmul_format_ref(
                            x, w, fmt12), iters)
                    row["library_ms"] = time_ms(
                        torch, lambda: torch.matmul(x, w), iters)
                    row["bound_ms"], row["bound_by"] = bound_ms(
                        4.0 * (M * K + K * N + M * N), 2.0 * M * N * K)
                rows.append(row)
            del x
        del w
    emit("quant_matmul_format", exact_checks=n_exact, checks=len(rows),
         max_abs_err=worst,
         max_order_spread=max(r["order_spread"] for r in rows), rows=rows)
    return rows, worst


def flash_tol(torch, v, lengths, fmt):
    """Sums over up to ``len`` positions in another order, plus expf: a few
    f32 ulps of the largest |v̂| attended, per (b, kv-head)."""
    from repro_torch.core.quantize import quantize_to_format

    S = v.shape[1]
    valid = (torch.arange(S, device=v.device)[None, :]
             < lengths[:, None])                              # [B, S]
    vq = quantize_to_format(v, *fmt).abs()
    vmax = torch.where(valid[:, :, None, None], vq, 0).amax(dim=(1, 3))
    slack = 2.0 * (lengths.double() + 16)[:, None] * 2.0 ** -24
    return (slack * vmax.double())[:, :, None, None]


def check_flash(torch, fd, q, k, v, lengths, fmt, flags=(True, True)):
    subn, sat = flags
    got = fd.flash_decode_certified(q, k, v, lengths, fmt,
                                    has_subnormals=subn, saturating=sat)
    want = fd.flash_decode_quantized_ref(q, k, v, lengths, fmt,
                                         has_subnormals=subn, saturating=sat)
    ok, st = compare(torch, got, want, fmt, flash_tol(torch, v, lengths, fmt))
    if not ok:
        raise AssertionError(f"flash_decode_certified S={k.shape[1]} "
                             f"lengths={lengths.tolist()} {fmt}: {st}")
    return st


# (Smax, lengths): ragged lengths, and the serve phase's own cache (Smax =
# prompt + steps + 1) at its first and last decode step's lengths
FLASH_CASES = {
    "ragged": (1024, [1, 255, 256, 1000]),
    "serve_first": (SERVE_PROMPT + SERVE_STEPS + 1, [SERVE_PROMPT + 1] * 4),
    "serve_last": (SERVE_PROMPT + SERVE_STEPS + 1,
                   [SERVE_PROMPT + SERVE_STEPS] * 4),
}


def phase_flash_decode(torch, fd):
    B, H, G, D = SERVE_BATCH, 4, 7, 128
    gen = torch.Generator(device="cuda").manual_seed(3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fmt12 = FORMATS["k12_e15"]
    worst, cases = 0.0, {}
    for case, (S, lens) in FLASH_CASES.items():
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(B, H, G, D, device="cuda", generator=gen)
        k = torch.randn(B, S, H, D, device="cuda", generator=gen)
        v = torch.randn(B, S, H, D, device="cuda", generator=gen)
        rows = []
        for fname, fmt in FORMATS.items():
            st = check_flash(torch, fd, q, k, v, lengths, fmt)
            worst = max(worst, st["max_abs_err"])
            rows.append({"format": fname, **st})
        timing = {
            "ms": time_ms(torch, lambda: fd.flash_decode_certified(
                q, k, v, lengths, fmt12), 50),
            "plain_ms": time_ms(torch, lambda: fd.flash_decode_quantized_ref(
                q, k, v, lengths, fmt12), 20),
        }
        # the yardstick: SDPA with grouped heads on [B, H, S, D] (the
        # transposition is made outside the timing); uniform lengths attend
        # to the prefix with no mask, ragged ones through a boolean mask
        qs = q.reshape(B, H * G, 1, D)
        if len(set(lens)) == 1:
            n = lens[0]
            ks = k[:, :n].permute(0, 2, 1, 3).contiguous()
            vs = v[:, :n].permute(0, 2, 1, 3).contiguous()
            mask = None
        else:
            ks = k.permute(0, 2, 1, 3).contiguous()
            vs = v.permute(0, 2, 1, 3).contiguous()
            mask = (torch.arange(S, device="cuda")[None, :]
                    < lengths[:, None])[:, None, None, :]
        timing["library_ms"] = time_ms(
            torch, lambda: sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True),
            50)
        n_pos = int(lengths.sum())
        n_bytes = 4.0 * (2 * q.numel() + 2 * n_pos * H * D) + 4 * B
        timing["bound_ms"], timing["bound_by"] = bound_ms(
            n_bytes, 4.0 * G * D * H * n_pos)
        cases[case] = {"Smax": S, "lengths": lens, **timing, "rows": rows}
        del q, k, v, ks, vs
    emit("flash_decode_certified",
         shape={"B": B, "K": H, "G": G, "D": D}, max_abs_err=worst,
         cases=cases)
    return cases, worst


def phase_serve(torch, serve, qmm, fd, T):
    L = 28
    argv = ["--size", "full", "--batch", str(SERVE_BATCH),
            "--prefill-len", str(SERVE_PROMPT),
            "--decode-steps", str(SERVE_STEPS),
            "--layer-format", json.dumps(SERVE_FORMAT),
            "--device", "cuda", "--seed", "0"]
    # keep the inputs the path gives each kernel, to hold them against the
    # plain versions after the run: each GEMM (M, K, N, format) at its first
    # launch (a copy of x; weights are not written), decode attention at its
    # first launch (copies) and its last (the cache is not written after).
    # The spies wrap serving's dispatches, which launch the kernels.
    dispatch_qmm = serve.quant_matmul_format_dispatch
    dispatch_fd = serve.certified_decode_attention
    gemm_in, flash_in = {}, {}

    def spy_qmm(x, w, fmt, **kw):
        x2 = x.reshape(-1, x.shape[-1])
        key = (*x2.shape, w.shape[1], tuple(fmt))
        if key not in gemm_in:
            gemm_in[key] = (x2.clone(), w.contiguous(), fmt, kw)
        return dispatch_qmm(x, w, fmt, **kw)

    def spy_fd(q, k, v, lengths, fmt, **kw):
        args = tuple(t.contiguous() for t in (q, k, v, lengths))
        if "first" not in flash_in:
            flash_in["first"] = (*(t.clone() for t in args), fmt, kw)
        flash_in["last"] = (*args, fmt, kw)
        return dispatch_fd(q, k, v, lengths, fmt, **kw)

    torch.cuda.reset_peak_memory_stats()
    kernel_qmm, kernel_fd = qmm.quant_matmul_format, fd.flash_decode_certified
    kernel_qmm.launches = 0
    kernel_fd.launches = 0
    serve.quant_matmul_format_dispatch = spy_qmm
    serve.certified_decode_attention = spy_fd
    try:
        res = serve.main(argv)
    finally:
        serve.quant_matmul_format_dispatch = dispatch_qmm
        serve.certified_decode_attention = dispatch_fd
    launches = {"quant_matmul_format": kernel_qmm.launches,
                "flash_decode_certified": kernel_fd.launches}
    cfg = res.cfg
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff) == (L, 3584, 18944), cfg
    expected = {"quant_matmul_format": 7 * L * (1 + SERVE_STEPS),
                "flash_decode_certified": L * SERVE_STEPS}
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    toks = res.tokens
    assert toks.shape == (SERVE_BATCH, 1 + SERVE_STEPS), toks.shape
    assert bool(((toks >= 0) & (toks < cfg.vocab)).all()), "token out of range"
    for lg in [res.prefill_logits] + res.decode_logits:
        assert bool(torch.isfinite(lg).all()), "non-finite logits"
    n_params = sum(t.numel() for t in _leaves(res.params))
    peak = torch.cuda.max_memory_allocated()

    # the kernels against their plain versions on the path's own inputs
    main_path = {"quant_matmul_format": [], "flash_decode_certified": []}
    for (M, K, N, fmt), (x, w, _, kw) in sorted(gemm_in.items()):
        _, st = check_gemm(torch, qmm, x, w, fmt,
                           (kw["has_subnormals"], kw["saturating"]))
        main_path["quant_matmul_format"].append(
            {"M": M, "K": K, "N": N, "format": list(fmt), **st})
    for when, (q, k, v, lengths, fmt, kw) in flash_in.items():
        st = check_flash(torch, fd, q, k, v, lengths, fmt,
                         (kw["has_subnormals"], kw["saturating"]))
        main_path["flash_decode_certified"].append(
            {"call": when, "Smax": k.shape[1], "lengths": lengths.tolist(),
             "format": list(fmt), **st})
    del gemm_in, flash_in

    # replay request 0's prefill through the plain versions
    class RefFormatOps(serve.FormatQuantJOps):
        def matmul(self, a, b):
            return qmm.quant_matmul_format_ref(
                a, b, self.format_for(self.scope_path),
                has_subnormals=self.has_subnormals,
                saturating=self.saturating)

        def decode_attention(self, q, k, v, lengths):
            return fd.flash_decode_quantized_ref(
                q, k, v, lengths, self.format_for(self.scope_path),
                has_subnormals=self.has_subnormals,
                saturating=self.saturating)

    before = qmm.quant_matmul_format.launches
    cache = T.init_cache(cfg, 1, SERVE_PROMPT + SERVE_STEPS + 1,
                         device="cuda")
    with torch.no_grad():
        ref_logits, _ = serve.prefill_step(RefFormatOps(SERVE_FORMAT),
                                           res.params, cfg, cache,
                                           res.prompt[:1])
    assert qmm.quant_matmul_format.launches == before
    served = res.prefill_logits[0, -1].double()
    ref = ref_logits[0, -1].double()
    top2 = torch.topk(served, 2).values
    emit("serve", config="qwen2_7b.FULL", n_layers=L, d_model=cfg.d_model,
         params=n_params, param_gb=4 * n_params / 1e9,
         batch=SERVE_BATCH, prompt_tokens=SERVE_PROMPT,
         decode_steps=SERVE_STEPS, layer_format=SERVE_FORMAT,
         launches=launches, expected_launches=expected,
         prefill_s=res.timing["prefill_s"],
         decode_ms_per_step=res.timing["decode_ms_per_step"],
         decode_tokens_per_s=res.timing["decode_tokens_per_s"],
         prefill_tokens_per_s=res.timing["prefill_tokens_per_s"],
         init_s=res.timing["init_s"],
         max_memory_allocated_gb=peak / 1e9,
         sample_tokens=toks[0].tolist(),
         main_path_inputs_vs_plain=main_path,
         replay_vs_plain={
             "max_abs_dlogits": float((served - ref).abs().max()),
             "argmax_agrees": bool(served.argmax() == ref.argmax()),
             "top1_gap": float(top2[0] - top2[1]),
             "max_abs_logit": float(served.abs().max())})
    return launches, main_path


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 3
    from repro_torch.core import quantize
    from repro_torch.kernels import _build, flash_decode as fd
    from repro_torch.kernels import quant_matmul as qmm
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    phase_env(torch, serve)
    phase_build(_build)
    phase_rounding(torch, quantize, qmm)
    qrows, qerr = phase_quant_matmul(torch, qmm)
    fcases, ferr = phase_flash_decode(torch, fd)
    launches, main_path = phase_serve(torch, serve, qmm, fd, T)
    qerr = max([qerr] + [r["max_abs_err"]
                         for r in main_path["quant_matmul_format"]])
    ferr = max([ferr] + [r["max_abs_err"]
                         for r in main_path["flash_decode_certified"]])

    decode = [r for r in qrows if r["M"] == SERVE_BATCH and "ms" in r]
    prefill = [r for r in qrows if r["M"] == 512 and "ms" in r]

    def total(rows, key):
        return sum(r[key] for r in rows)

    q_bytes = sum(4.0 * (SERVE_BATCH * K + K * N + SERVE_BATCH * N)
                  for K, N in GEMM_SHAPES.values())
    q_ops = sum(2.0 * SERVE_BATCH * K * N for K, N in GEMM_SHAPES.values())
    q_bound, q_by = bound_ms(q_bytes, q_ops)
    kernels = [
        {"name": "quant_matmul_format", "route": "cuda",
         "source": "src/repro_torch/csrc/quant_matmul_format.cu",
         "replaces": "src/repro/kernels/quant_matmul.py:123",
         "launches": launches["quant_matmul_format"],
         "max_abs_err": qerr,
         "ms": total(decode, "ms"), "plain_ms": total(decode, "plain_ms"),
         "bound_ms": q_bound, "bound_by": q_by,
         "library_ms": total(decode, "library_ms"),
         "what": "the 7 GEMMs of one layer at decode, M=4, format k12_e15",
         "prefill_per_layer": {
             "M": 512, "ms": total(prefill, "ms"),
             "plain_ms": total(prefill, "plain_ms"),
             "library_ms": total(prefill, "library_ms"),
             "bound_ms": total(prefill, "bound_ms")}},
        {"name": "flash_decode_certified", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_decode_certified.cu",
         "replaces": "src/repro/kernels/flash_decode.py:112",
         "launches": launches["flash_decode_certified"],
         "max_abs_err": ferr,
         **{key: fcases["serve_last"][key]
            for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms")},
         "what": "the serve cache at its last step: B=4 K=4 G=7 D=128 "
                 f"Smax={FLASH_CASES['serve_last'][0]} lengths "
                 f"{FLASH_CASES['serve_last'][1][0]}, format k12_e15",
         "other_cases": {
             c: {key: fcases[c][key] for key in ("Smax", "lengths", "ms",
                                                  "plain_ms", "bound_ms",
                                                  "library_ms")}
             for c in fcases if c != "serve_last"}},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
