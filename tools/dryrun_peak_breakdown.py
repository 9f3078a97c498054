"""What holds a dry-run cell's peak a rank: the step's live bytes at the
moment they are most, by kind.

Runs one cell as ``repro_torch.launch.dryrun`` does (rank 0 of a fake
process group, fake tensors, the cell's own step) under a dispatch mode
that follows every storage an op creates until it is freed, labels it, and
keeps the labels' bytes at the peak. The labels, first match wins:

* ``logits``: a tensor whose last dim is the vocab (the LM head's output,
  its f32 copy, the loss's temporaries and their gradients);
* ``attention scores``: a tensor whose last two dims are (seq, seq);
* ``gathered params``: made inside ``train.whole_of`` (a layer's params,
  the tables, gathered whole);
* ``gradient pass``: made inside ``MeshGrads.reduce`` (a slice's averaged
  gradient, its EF codes, its block);
* ``saved carry``: made inside ``MeshRematTorchOps._carry_part``;
* ``update``: made inside ``train.update_blocks``;
* ``layer activations``: anything else (norms, projections, the MLP, the
  blocks' accumulated gradients).

The state's blocks (params, optimizer, EF, batch) are the record's
argument bytes. The labels are counts from shapes on fake tensors, not
device measurements. Usage (a process of its own: it starts a fake
group)::

    PYTHONPATH=src python tools/dryrun_peak_breakdown.py --arch qwen2_7b \\
        --shape train_4k [--multi-pod]
"""
import argparse
import contextlib
import json
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import configs
from repro_torch.launch import dryrun, train

_LABEL = threading.local()


@contextlib.contextmanager
def labelled(name):
    prev = getattr(_LABEL, "name", None)
    _LABEL.name = name
    try:
        yield
    finally:
        _LABEL.name = prev


def _wrap(owner, attr, name):
    fn = getattr(owner, attr)

    def wrapped(*args, **kwargs):
        with labelled(name):
            return fn(*args, **kwargs)

    setattr(owner, attr, wrapped)


class PeakLabels(TorchDispatchMode):
    """Live bytes of every storage an op makes, by label; the labels'
    bytes at the moment the total is highest."""

    def __init__(self, vocab: int, seq: int):
        super().__init__()
        self.vocab, self.seq = vocab, seq
        self.live = {}          # id(storage) → (label, bytes)
        self.by_label = {}
        self.total = self.peak = 0
        self.at_peak = {}

    def _label(self, t) -> str:
        shape = tuple(t.shape)
        if shape and shape[-1] == self.vocab:
            return "logits"
        if len(shape) >= 2 and shape[-2:] == (self.seq, self.seq):
            return "attention scores"
        return getattr(_LABEL, "name", None) or "layer activations"

    def _free(self, key):
        label, n = self.live.pop(key)
        self.by_label[label] -= n
        self.total -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self.live:
                continue
            n = st.nbytes()
            label = self._label(t)
            self.live[key] = (label, n)
            self.by_label[label] = self.by_label.get(label, 0) + n
            self.total += n
            weakref.finalize(st, self._free, key)
            if self.total > self.peak:
                self.peak = self.total
                self.at_peak = dict(self.by_label)
        return out


def breakdown(arch: str, shape: str, multi_pod: bool) -> dict:
    cfg = configs.get(arch).FULL
    spec = dryrun.effective_shape(cfg, configs.SHAPES[shape])
    world = 512 if multi_pod else 256
    _wrap(train, "whole_of", "gathered params")
    _wrap(train.MeshGrads, "reduce", "gradient pass")
    _wrap(train.MeshRematTorchOps, "_carry_part", "saved carry")
    _wrap(train, "update_blocks", "update")
    tracker = PeakLabels(cfg.vocab, spec.seq)
    measured = dryrun.measured_step
    held = {}

    def step_under_tracker(fn, parts, fake):
        def run():
            with tracker:
                fn()
        held["rec"] = measured(run, parts, fake)
        return held["rec"]

    dryrun.measured_step = step_under_tracker
    with dryrun.fake_group(world):
        rec = dryrun.dryrun_cell(arch, shape, multi_pod=multi_pod)
    mem = rec["memory"]
    return {"arch": arch, "shape": shape, "mesh": rec["mesh"],
            "peak_bytes": mem["peak_bytes"],
            "argument_parts": mem["argument_parts"],
            "temp_bytes_memtracker": mem["temp_bytes"],
            "temp_bytes_labelled_peak": tracker.peak,
            "at_peak_by_label": {k: v for k, v in sorted(
                tracker.at_peak.items(), key=lambda kv: -kv[1]) if v}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2_7b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    print(json.dumps(breakdown(args.arch, args.shape, args.multi_pod),
                     indent=1))


if __name__ == "__main__":
    main()
