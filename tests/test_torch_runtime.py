"""The port's fault-tolerance runtime (``repro_torch.runtime``, copies of
the reference's pure-Python modules), on the CPU: the reference's own
system tests mirrored (``tests/test_system.py``: a swap and a shrink, the
straggler detector, the failure-injection harness), the copies equal to
the reference's source, and exactly-once data through a real run:
``run_with_failures`` drives the port's SMOKE train step (Qwen2-7B cut to
2 layers, seq 16, batch 2) with its checkpointer through a swap and a
shrink, and every step's loss, re-run ones included, and the final state
equal the uninterrupted run's bit for bit (the stateless pipeline gives a
re-run step its batch again)."""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import dataclasses
import inspect

import pytest
import torch

from repro.runtime import fault_tolerance as jft
from repro.runtime import straggler as jst
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.checkpointing import Checkpointer, _items
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as ttrain
from repro_torch.optim import optimizer as topt
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.runtime import straggler as tst


@pytest.mark.parametrize("ref,port", [(jft, tft), (jst, tst)],
                         ids=["fault_tolerance", "straggler"])
def test_runtime_is_the_reference_copied(ref, port):
    """Every function and class is the reference's, source for source (the
    port's docstring adds where it comes from)."""
    names = [n for n, v in vars(ref).items()
             if inspect.isfunction(v) or inspect.isclass(v)
             and v.__module__ == ref.__name__]
    assert names
    for n in names:
        assert inspect.getsource(getattr(port, n)) == \
            inspect.getsource(getattr(ref, n)), n


def test_fault_tolerance_swap_and_shrink():
    sup = tft.Supervisor(n_hosts=8, chips_per_host=4, model_parallel=4,
                         spares=1)
    ev = sup.handle_failures(10, {3})
    assert ev.kind == "swap"
    sup.monitor.hosts[5].alive = False
    ev = sup.handle_failures(20, {5})
    assert ev.kind == "shrink"
    d, m = ev.new_mesh
    assert m == 4 and d * m <= 7 * 4 and d >= 1 and (d & (d - 1)) == 0
    assert sup.handle_failures(21, set()) is None


def test_heartbeat_deadline_and_largest_mesh():
    mon = tft.HeartbeatMonitor(3, deadline_s=10.0)
    for h in range(3):
        mon.beat(h, at=100.0)
    mon.beat(2, at=105.0)
    assert mon.sweep(now=112.0) == {0, 1}
    assert mon.alive_count() == 1 and mon.sweep(now=112.0) == set()
    assert tft.largest_mesh(28, 4) == (4, 4)
    assert tft.largest_mesh(3, 4) == (1, 4)


def test_straggler_detector():
    det = tst.StragglerDetector(6)
    flagged = set()
    for _ in range(25):
        for h in range(6):
            det.report(h, 1.0 + (4.0 if h == 2 else 0.02 * h))
        flagged = det.flagged()
    assert flagged == {2}
    plans = tst.plan_backups(flagged, fastest=[0, 1], shard_of_host={2: 2})
    assert plans[0].backup_host == 0 and plans[0].shard == 2


def test_run_with_failures_harness():
    sup = tft.Supervisor(n_hosts=4, chips_per_host=4, model_parallel=4,
                         spares=1)
    computed = []
    saved = {"step": 0}

    def train_step(step):
        computed.append(step)
        return 1.0 / (step + 1)

    def save_fn(step):
        saved["step"] = step

    def restore_fn(new_mesh):
        assert new_mesh[1] == 4
        return saved["step"]

    losses = tft.run_with_failures(train_step, save_fn, restore_fn, sup,
                                   n_steps=20, checkpoint_every=5,
                                   failures={7: [1], 13: [2]})
    assert len(losses) >= 20
    assert sup.events[0].kind == "swap"
    assert sup.events[1].kind == "shrink"
    assert computed.count(5) >= 2


def test_exactly_once_through_a_real_run(tmp_path):
    cfg = dataclasses.replace(tconfigs.get("qwen2_7b").SMOKE, n_layers=2)
    tc = ttrain.TrainConfig(seq=16, global_batch=2, steps=12)
    step_fn, init_fn = ttrain.build_train_step(cfg, tc, "cpu")
    dc = tpipe.DataConfig(vocab=cfg.vocab, seq=16, global_batch=2)

    ref = init_fn(torch.Generator().manual_seed(0))
    want = [float(step_fn(ref, tpipe.batch_at(dc, i))[1]) for i in range(12)]

    ck = Checkpointer(str(tmp_path))
    live = {"state": init_fn(torch.Generator().manual_seed(0))}
    ran = []

    def train_step(step):
        live["state"], loss = step_fn(live["state"], tpipe.batch_at(dc, step))
        ran.append((step, float(loss)))
        return float(loss)

    def save_fn(step):                  # the state after ``step``
        ck.save(step + 1, live["state"])

    def restore_fn(new_mesh):
        assert new_mesh[1] == 4         # model-parallel degree kept
        live["state"], manifest = ck.restore(
            ttrain.state_template(cfg, tc, topt.AdamWConfig(
                total_steps=tc.steps)), device="cpu")
        return manifest["step"]

    sup = tft.Supervisor(n_hosts=4, chips_per_host=4, model_parallel=4,
                         spares=1)
    losses = tft.run_with_failures(train_step, save_fn, restore_fn, sup,
                                   n_steps=12, checkpoint_every=4,
                                   failures={7: [1], 11: [2]})
    assert [e.kind for e in sup.events] == ["swap", "shrink"]
    assert [s for s, _ in ran].count(5) == 2     # re-run after the restore
    assert len(losses) == 12 + 4
    for step, loss in ran:
        assert loss == want[step], step
    got, exp = dict(_items(live["state"])), dict(_items(ref))
    for k, t in exp.items():
        assert torch.equal(t, got[k]), k
