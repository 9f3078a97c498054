"""Continuous batching: a decode scheduler over a lane-structured KV cache
(PyTorch, one GPU).

The counterpart of the JAX package's ``repro.launch.batching``. The
lock-step serving loop (:mod:`repro_torch.launch.serve`) prefills once and
decodes B sequences that finish together; here a persistent decode batch
of ``n_lanes`` lanes is joined and left by requests independently:

- **Admission control**: a bounded FIFO queue in front of the lanes; a
  request is admitted when a lane is free AND its worst-case KV footprint
  (``ceil((prompt + max_new) / page_size)`` fixed-size pages) fits the page
  pool, so an admitted request never runs out of cache mid-flight. A
  request that can never fit is rejected at the door (``too_long``), as is
  one that finds the queue full (``queue_full``). The queue is honest FIFO:
  a head that waits for pages is not overtaken.
- **Prefill into the lane**: a new request prefills at batch 1, its prompt
  padded to whole pages, straight into its lane's slice of the running
  ``[L, B, Smax, ...]`` cache (a view, written in place); the lane's index
  is then pinned to the true prompt length, so the pad positions are
  overwritten by the first decode steps. A model with a recurrent state
  beside its KV cache (Hymba's Mamba heads, ``h_ssm``) prefills at the
  prompt's true length instead: pad tokens would run through the scan into
  the state, which no mask undoes. The lane's state is zeroed first and
  written whole by the prefill (idle lanes' decode steps advance it). The
  decode batch never drains to let a request in.
- **Lane recycling**: on EOS / max-new-tokens the lane's pages return to
  the pool and the lane is reusable at once. Stale cache contents are never
  scrubbed: the decode kernel reads nothing at or past a lane's length,
  and the composed paths mask those positions to exact zeros (the stale
  values are finite).
- **Ragged decode**: every step decodes one token in every lane, each at
  its own offset (``q_offset`` a [B] device tensor; idle lanes decode token
  0 at offset 0). The next tokens come back to the host once a step.

Contract: a request's tokens equal those of running it alone through
:func:`reference_generate` (batch 1, unpadded prefill). It holds where
every per-lane row of the forward is independent of the batch: the port's
GEMM and decode-attention kernels fix one summation order per element
whatever the batch, the lane or the neighbours; the library products (the
LM head, the composed attention) promise no such thing.

A model without an indexed KV cache (RWKV: its whole context is a
recurrent state) raises ``NotImplementedError``, as in the reference. So
does an encoder-decoder model (Whisper): a request carries tokens only, as
in the reference's engine, whose forward then has no encoder input. A
vision model (PaliGemma) is served text-only, without its patch prefix, as
the reference's engine serves it; MiniCPM3's latent cache has an index, so
the engine serves it.

Mesh execution: with a ("data", "model") mesh from
:func:`repro_torch.launch.mesh.make_serving_mesh`, the params are placed
under the bitwise-safe serving rules (column parallel over "model",
:func:`repro_torch.parallel.sharding.shard_params_serving`) and the cache
under the lane rules (lanes over "data", KV heads over "model" where they
divide). Each "data" rank decodes its own lanes and prefills the requests
admitted to them; the lane's first logit row is broadcast to the other
"data" ranks and a step's logits are gathered, so every rank keeps the same
schedule. Every collective moves exact values (a gather of columns, heads
or lanes); nothing reduces across ranks, so a lane's bits are its bits on
one device wherever the products keep a column's and a row's bits (the
port's kernels on the card). On the card a process has one device, so its
mesh is 1 × 1; multi-rank meshes run on the CPU with gloo. Entry points run
on the card unless the caller asks for the CPU (``device="cpu"``); without
a card they raise.

CLI::

    python -m repro_torch.launch.batching --size full --check-ref \\
        [--precision-k 12 | --certificates STORE_DIR --certify-formats]
    python -m repro_torch.launch.batching ... --data N --model M   # ranks
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import time
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import configs, obs
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding

log = obs.get_logger("batching")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: Sequence[int]
    max_new_tokens: int = 16
    arrival_step: int = 0


@dataclasses.dataclass
class _Lane:
    req: Request
    length: int                 # tokens currently in this lane's cache
    pages: int                  # pages reserved from the pool
    out: List[int] = dataclasses.field(default_factory=list)
    t_admit: float = 0.0
    prefill_s: float = 0.0      # host clock of its prefill
    logits: List[torch.Tensor] = dataclasses.field(default_factory=list)


def make_backend(sc: serve.ServeConfig, *, mesh=None,
                 unrolled: bool = False):
    """The serving backend for a ServeConfig, in the reference's precedence
    (format map, per-layer k map, uniform k, plain), on ``mesh`` when
    given. ``unrolled`` is the reference's signature: the port's layer loop
    is always the unrolled per-layer loop, so it changes nothing."""
    del unrolled
    return serve._backend(sc, mesh=mesh)


def _device_of(params) -> torch.device:
    return params["embed"].device


def _check_cache_dtype(sc: serve.ServeConfig) -> None:
    """The engine's cache is f32, as the reference engine's is (it
    allocates ``init_cache(..., jnp.float32)`` and never reads
    ``cache_dtype``); a ServeConfig asking for a narrower one raises
    instead of being ignored. ``compute_dtype`` is served."""
    if sc.cache_dtype != "float32":
        raise ValueError(f"cache_dtype {sc.cache_dtype!r}: the batching "
                         "engine's cache is float32, as the reference's")


def _check_servable(arch_cfg) -> None:
    """An encoder-decoder model raises: requests carry no encoder input."""
    if arch_cfg.enc_dec:
        raise NotImplementedError(
            f"{arch_cfg.name}: continuous batching serves tokens only, and "
            "an encoder-decoder model needs its encoder input (the "
            "reference's engine passes none either)")


class ContinuousBatchingEngine:
    """Decode scheduler: admission queue → lanes → recycled lanes.

    ``params`` live on ``device`` (the card unless ``"cpu"`` is asked
    for). ``registry`` (a :class:`repro_torch.obs.MetricsRegistry`)
    receives occupancy / queue-depth / free-page gauges and per-lane
    ``serve.decode_latency_s{lane=N}`` histograms. ``keep_logits`` keeps
    each request's logit rows (its prefill's last real row, then one per
    decode step) in its response. ``page_waits`` counts the admissions
    that found a free lane but waited for pages."""

    def __init__(self, arch_cfg, sc: serve.ServeConfig, params, *,
                 n_lanes: int = 4, max_seq: int = 64, page_size: int = 16,
                 queue_depth: int = 8, total_pages: Optional[int] = None,
                 eos_id: int = -1, registry=None, certset=None,
                 device: str = "cuda", keep_logits: bool = False,
                 mesh=None):
        if max_seq % page_size:
            raise ValueError(f"max_seq {max_seq} must be a whole number of "
                             f"pages (page_size {page_size})")
        dev, on = serve.resolve_device(device), _device_of(params)
        if on.type != dev.type or dev.index not in (None, on.index):
            raise ValueError(f"params live on {on}, the engine on {dev}")
        _check_servable(arch_cfg)
        _check_cache_dtype(sc)
        self.device = on
        self.arch_cfg, self.sc, self.params = arch_cfg, sc, params
        self.n_lanes, self.max_seq = n_lanes, max_seq
        self.page_size = page_size
        self.queue_depth = queue_depth
        self.total_pages = (n_lanes * (max_seq // page_size)
                            if total_pages is None else total_pages)
        self.free_pages = self.total_pages
        self.eos_id = eos_id
        self.registry = registry
        self.certset = certset
        self.keep_logits = keep_logits
        self.mesh = mesh
        self.bk = make_backend(sc, mesh=mesh)

        self.queue: Deque[Request] = collections.deque()
        self.lanes: List[Optional[_Lane]] = [None] * n_lanes
        self.responses: List[Dict[str, Any]] = []
        self.steps = 0
        self.decode_tokens = 0
        self.decode_s = 0.0
        self.page_waits = 0
        self.cache = T.init_cache(arch_cfg, n_lanes, max_seq,
                                  device=self.device, per_lane_idx=True)
        if "idx" not in self.cache:
            raise NotImplementedError(
                f"continuous batching needs an indexed KV cache (family "
                f"{arch_cfg.family!r} has none)")
        # this rank's lanes: [lane0, lane0 + rows); all of them off a mesh
        self.lane0, self.rows, self._lane_axis = 0, n_lanes, None
        if mesh is not None:
            self.params = sharding.place(
                params, sharding.shard_params_serving(params, mesh), mesh)
            self.cache = sharding.local(sharding.place(
                self.cache, sharding.shard_cache_serving(self.cache, mesh),
                mesh))
            if sharding.lane_batch_sharding(mesh, n_lanes):
                d = meshlib.axis_size(mesh, "data")
                r = mesh.get_coordinate()[mesh.mesh_dim_names.index("data")]
                self.rows, self.lane0 = n_lanes // d, r * (n_lanes // d)
                self._lane_axis = "data"

    # -- the two forwards ---------------------------------------------------

    def _prefill(self, lane: int, prompt: Sequence[int]):
        """Batch-1 prefill of ``prompt``, padded to whole pages, written
        into lane ``lane`` of the running cache in place. Returns (first
        token, its logit row). Pad columns are causally masked, so the real
        rows are those of the unpadded prefill where the products keep a
        row's bits; the lane's index is pinned to the true length. A cache
        with a recurrent state (``h_ssm``) is prefilled unpadded, from a
        zeroed state: the lane's state is then the request's alone."""
        P = len(prompt)
        recurrent = "h_ssm" in self.cache
        p_pad = (P if recurrent else
                 min(self.max_seq, self.page_size * self._pages_for(P)))
        toks = np.zeros((1, p_pad), np.int64)
        toks[0, :P] = np.asarray(prompt, np.int64)
        dev, L = self.device, self.arch_cfg.n_layers
        owner = lane - self.lane0
        if 0 <= owner < self.rows:
            at = slice(owner, owner + 1)
            view = {"k": self.cache["k"][:, at], "v": self.cache["v"][:, at],
                    "idx": torch.zeros((L, 1), dtype=torch.int32,
                                       device=dev)}
            if recurrent:
                view["h_ssm"] = self.cache["h_ssm"][:, at].zero_()
            logits, _ = T.forward(self.bk, self.params, self.arch_cfg,
                                  torch.from_numpy(toks).to(dev), cache=view,
                                  q_offset=torch.zeros(1, dtype=torch.int32,
                                                       device=dev))
            self.cache["idx"][:, owner] = P
            row = logits[0, P - 1]
        else:
            row = torch.empty(self.arch_cfg.vocab,
                              dtype=self.sc.dtypes[0], device=dev)
        if self._lane_axis:
            row = self._from_lane_owner(row, lane // self.rows)
        return int(torch.argmax(row)), row

    def _from_lane_owner(self, row, owner: int):
        """The "data" rank ``owner``'s ``row``, broadcast to the others."""
        import torch.distributed as dist

        group = self.mesh.get_group(self._lane_axis)
        dist.broadcast(row, src=dist.get_global_rank(group, owner),
                       group=group)
        return row

    def _decode(self, tokens: np.ndarray, offsets: np.ndarray):
        """One token for every lane, lane i at absolute position
        ``offsets[i]``; every lane's write index is pinned to it first, so
        idle lanes neither drift nor reach the buffer's end. Returns (next
        tokens on the host, logits [B, V])."""
        mine = slice(self.lane0, self.lane0 + self.rows)
        both = torch.from_numpy(np.stack([tokens[mine], offsets[mine]])).to(
            self.device)
        toks, offs = both[0], both[1].to(torch.int32)
        self.cache["idx"].copy_(offs[None, :].expand_as(self.cache["idx"]))
        logits, self.cache = T.forward(self.bk, self.params, self.arch_cfg,
                                       toks[:, None], cache=self.cache,
                                       q_offset=offs)
        last = logits[:, -1, :]
        if self._lane_axis:
            last = self.bk.gather(last, 0, self._lane_axis)
        return torch.argmax(last, dim=-1).cpu().numpy(), last

    # -- scheduling ---------------------------------------------------------

    def _pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def submit(self, req: Request) -> bool:
        """Enqueue; False = rejected (queue full / can never fit)."""
        worst = len(req.prompt) + req.max_new_tokens
        if worst > self.max_seq or self._pages_for(worst) > self.total_pages:
            self._count("serve.requests_rejected{reason=too_long}")
            return False
        if len(self.queue) >= self.queue_depth:
            self._count("serve.requests_rejected{reason=queue_full}")
            return False
        self.queue.append(req)
        return True

    def _count(self, name, inc=1):
        if self.registry is not None:
            self.registry.counter(name, inc)

    def _gauges(self):
        if self.registry is None:
            return
        occ = sum(l is not None for l in self.lanes) / self.n_lanes
        self.registry.gauge("serve.batch_occupancy", occ)
        self.registry.gauge("serve.admission_queue_depth", len(self.queue))
        self.registry.gauge("serve.kv_pages_free", self.free_pages)

    def _admit(self):
        while self.queue:
            free = [i for i, l in enumerate(self.lanes) if l is None]
            if not free:
                break
            req = self.queue[0]
            P = len(req.prompt)
            pages = self._pages_for(P + req.max_new_tokens)
            if pages > self.free_pages:
                self.page_waits += 1
                break                      # honest FIFO: no head-of-line skip
            self.queue.popleft()
            lane = free[0]
            t0 = time.perf_counter()
            with torch.no_grad():
                first, row = self._prefill(lane, req.prompt)
            prefill_s = time.perf_counter() - t0
            if self.registry is not None:
                self.registry.observe("serve.prefill_latency_s", prefill_s)
            self.free_pages -= pages
            self.lanes[lane] = _Lane(req=req, length=P, pages=pages,
                                     out=[first], t_admit=t0,
                                     prefill_s=prefill_s,
                                     logits=[row.clone()]
                                     if self.keep_logits else [])
            self._count("serve.requests_admitted")
            self._finish_if_done(lane, first)

    def _finish_if_done(self, i: int, last_tok: int):
        lane = self.lanes[i]
        if lane is None:
            return
        done = (last_tok == self.eos_id
                or len(lane.out) >= lane.req.max_new_tokens
                or lane.length + 1 >= self.max_seq)
        if not done:
            return
        r: Dict[str, Any] = {"id": lane.req.rid, "tokens": list(lane.out),
                             "n_prompt": len(lane.req.prompt),
                             "lane": i, "prefill_s": lane.prefill_s}
        if self.keep_logits:
            r["logits"] = torch.stack(lane.logits)
        if self.certset is not None:
            r["certificate"] = dict(self.certset.error_bars(),
                                    params_digest=self.certset.params_digest)
        self.responses.append(r)
        self.free_pages += lane.pages
        self.lanes[i] = None
        self._count("serve.requests_completed")

    def step(self) -> bool:
        """Admit + one decode step for every active lane. False = idle."""
        self._admit()
        self._gauges()
        active = [i for i, l in enumerate(self.lanes) if l is not None]
        if not active:
            return bool(self.queue)
        tokens = np.zeros((self.n_lanes,), np.int64)
        offsets = np.zeros((self.n_lanes,), np.int64)
        for i, lane in enumerate(self.lanes):
            if lane is not None:
                tokens[i] = lane.out[-1]
                offsets[i] = lane.length
        t0 = time.perf_counter()
        with torch.no_grad():
            nxt, last = self._decode(tokens, offsets)
        dt = time.perf_counter() - t0
        self.steps += 1
        self.decode_tokens += len(active)
        self.decode_s += dt
        if self.registry is not None:
            self.registry.observe("serve.decode_latency_s", dt)
            for i in active:
                self.registry.observe(f"serve.decode_latency_s{{lane={i}}}",
                                      dt)
            self._count("serve.tokens", len(active))
        for i in active:
            lane = self.lanes[i]
            lane.length += 1
            lane.out.append(int(nxt[i]))
            if self.keep_logits:
                lane.logits.append(last[i])
            self._finish_if_done(i, int(nxt[i]))
        return True

    def run(self, requests: Sequence[Request] = (),
            max_steps: int = 100_000) -> List[Dict[str, Any]]:
        """Drive the schedule to completion: requests enter the queue at
        their ``arrival_step``; returns the responses in completion order."""
        pending = sorted(requests, key=lambda r: r.arrival_step)
        pi = 0
        for _ in range(max_steps):
            while pi < len(pending) and pending[pi].arrival_step <= self.steps:
                self.submit(pending[pi])
                pi += 1
            busy = self.step()
            if (not busy and pi >= len(pending)
                    and all(l is None for l in self.lanes)
                    and not self.queue):
                break
        self._gauges()
        if self.registry is not None and self.decode_s > 0:
            self.registry.gauge("serve.decode_tokens_per_s",
                                self.decode_tokens / self.decode_s)
        return self.responses


def reference_generate(arch_cfg, sc: serve.ServeConfig, params,
                       prompt: Sequence[int], max_new_tokens: int, *,
                       max_seq: int, eos_id: int = -1,
                       return_logits: bool = False):
    """The eager oracle the engine must match: the request alone, batch 1,
    unpadded prefill, on the device the params live on. ``max_seq`` must
    equal the engine's (the cache width is part of the masked-softmax
    shape). Returns the tokens, or (tokens, logit rows [n, V]) with
    ``return_logits``."""
    _check_servable(arch_cfg)
    _check_cache_dtype(sc)
    bk = make_backend(sc, unrolled=True)
    dev = _device_of(params)
    cache = T.init_cache(arch_cfg, 1, max_seq, device=dev, per_lane_idx=True)
    P = len(prompt)
    with torch.no_grad():
        toks = torch.tensor([list(prompt)], dtype=torch.int64, device=dev)
        logits, cache = T.forward(bk, params, arch_cfg, toks, cache=cache,
                                  q_offset=torch.zeros(1, dtype=torch.int32,
                                                       device=dev))
        rows = [logits[0, -1]]
        tok = int(torch.argmax(rows[-1]))
        out = [tok]
        while (tok != eos_id and len(out) < max_new_tokens
               and P + len(out) < max_seq):
            offs = torch.tensor([P + len(out) - 1], dtype=torch.int32,
                                device=dev)
            logits, cache = T.forward(
                bk, params, arch_cfg,
                torch.tensor([[tok]], dtype=torch.int64, device=dev),
                cache=cache, q_offset=offs)
            rows.append(logits[0, -1])
            tok = int(torch.argmax(rows[-1]))
            out.append(tok)
    return (out, torch.stack(rows)) if return_logits else out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.batching",
                                 description="continuous-batching serving")
    ap.add_argument("--arch", default="qwen2_7b")
    ap.add_argument("--size", choices=("smoke", "full"), default="smoke",
                    help="the arch's SMOKE or FULL (published) config")
    ap.add_argument("--max-layers", type=int, default=None,
                    help="cap the config's layer count (the certify CLI's "
                         "--max-layers: a certificate of the cut model)")
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--queue-depth", type=int, default=8)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--arrival-stride", type=int, default=2,
                    help="steps between request arrivals (staggered joins)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights' generator and the requests")
    ap.add_argument("--precision-k", type=int, default=None)
    ap.add_argument("--compute-dtype", choices=("float32", "bfloat16"),
                    default="float32",
                    help="activations and products; params are stored in "
                         "it (the cache stays float32, as the reference "
                         "engine's)")
    serve.add_certificate_flags(ap)
    ap.add_argument("--check-ref", action="store_true",
                    help="re-serve every request alone through "
                         "reference_generate and require token-for-token "
                         "equality (exits 1 on any mismatch)")
    ap.add_argument("--metrics", default=None, metavar="OUT.JSONL")
    ap.add_argument("--prom", default=None, metavar="OUT.PROM")
    ap.add_argument("--data", type=int, default=None,
                    help="mesh data-axis size (default: all ranks)")
    ap.add_argument("--model", type=int, default=None,
                    help="mesh model-axis size (default: 1)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.certificates and args.precision_k is not None:
        ap.error("--certificates sets the precision itself: give it "
                 "without --precision-k")
    certify_kw = serve.certify_kwargs(ap, args)

    dev = serve.resolve_device(args.device)
    serve.configure_precision()
    mod = configs.get(args.arch)
    arch_cfg = mod.FULL if args.size == "full" else mod.SMOKE
    if args.max_layers is not None:
        arch_cfg = dataclasses.replace(
            arch_cfg, n_layers=min(args.max_layers, arch_cfg.n_layers))
    sc = serve.ServeConfig(arch=args.arch, batch=args.lanes,
                           max_seq=args.max_seq,
                           precision_k=args.precision_k,
                           certificates=args.certificates, device=str(dev),
                           compute_dtype=args.compute_dtype)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_params(arch_cfg, generator=gen, device=dev,
                           dtype=sc.dtypes[2])
    certset = None
    if args.certificates is not None:
        sc, certset = serve.apply_certificates(sc, arch_cfg, params,
                                               **certify_kw)
        log.info("certificate resolved", k=sc.precision_k,
                 mixed_scopes=(None if sc.precision_layer_k is None
                               else len(sc.precision_layer_k)),
                 format_scopes=(None if sc.precision_layer_format is None
                                else len(sc.precision_layer_format)),
                 error_bars=certset.error_bars())

    mesh = meshlib.make_serving_mesh(data=args.data, model=args.model,
                                     device=str(dev))
    registry = obs.MetricsRegistry()
    registry.meta.update(arch=args.arch, size=args.size, lanes=args.lanes,
                         device=str(dev), precision_k=sc.precision_k,
                         devices=meshlib.device_count(),
                         mesh=meshlib.mesh_shape(mesh))
    engine = ContinuousBatchingEngine(
        arch_cfg, sc, params, n_lanes=args.lanes, max_seq=args.max_seq,
        page_size=args.page_size, queue_depth=args.queue_depth,
        registry=registry, certset=certset, device=str(dev), mesh=mesh)

    rng = np.random.RandomState(args.seed)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.randint(max(1, args.prompt_len // 2),
                               args.prompt_len + 1))
        reqs.append(Request(
            rid=i, prompt=rng.randint(0, arch_cfg.vocab, plen).tolist(),
            max_new_tokens=args.max_new,
            arrival_step=i * args.arrival_stride))
    t0 = time.perf_counter()
    responses = engine.run(reqs)
    wall = time.perf_counter() - t0
    log.info("served", requests=len(responses), steps=engine.steps,
             wall_s=round(wall, 2),
             decode_tokens_per_s=(round(engine.decode_tokens
                                        / engine.decode_s, 1)
                                  if engine.decode_s else None),
             sample=responses[0]["tokens"][:8] if responses else None)
    if args.check_ref:
        bad = []
        for req in reqs:
            got = next(r["tokens"] for r in responses if r["id"] == req.rid)
            want = reference_generate(arch_cfg, sc, params, req.prompt,
                                      req.max_new_tokens,
                                      max_seq=args.max_seq)
            if got != want:
                bad.append((req.rid, got, want))
        if bad:
            log.error("reference mismatch", n=len(bad), first=bad[0])
            raise SystemExit(1)
        log.info("reference check passed", requests=len(reqs),
                 contract="batched == alone, token for token")
    if args.metrics:
        registry.write_jsonl(args.metrics)
    if args.prom:
        registry.write_prometheus(args.prom)
    return engine, responses


if __name__ == "__main__":
    _, out = main()
    print(json.dumps([{k: r[k] for k in ("id", "tokens", "n_prompt")}
                      for r in out]))
