"""Fault tolerance for 1000+-node runs: heartbeats, restart policy, elastic
re-meshing — simulated faithfully on CPU (the state machine and resharding
logic are the deliverable; the transport is process-local here, DCN in
production).

A copy of the JAX package's ``repro.runtime.fault_tolerance`` (pure
Python): the port keeps its own, as it imports nothing of ``repro``.

Components
  HeartbeatMonitor — per-host liveness with deadline; marks hosts dead and
    triggers the supervisor.
  Supervisor — drives the run loop: on failure, (a) if spares exist, swap
    and restore from the latest checkpoint; (b) else *elastically* shrink
    the mesh to the largest (d', m') grid the survivors support, re-lower
    the step, and restore with the new shardings (checkpointing.restore is
    resharding-aware).
  run_with_failures — a harness the tests use: injects failures at chosen
    steps and asserts loss-curve continuity after recovery.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Set


@dataclasses.dataclass
class HostState:
    host_id: int
    last_beat: float
    alive: bool = True


class HeartbeatMonitor:
    def __init__(self, n_hosts: int, deadline_s: float = 60.0):
        now = time.monotonic()
        self.deadline = deadline_s
        self.hosts: Dict[int, HostState] = {
            h: HostState(h, now) for h in range(n_hosts)
        }

    def beat(self, host_id: int, at: Optional[float] = None):
        hs = self.hosts[host_id]
        hs.last_beat = time.monotonic() if at is None else at
        hs.alive = True

    def sweep(self, now: Optional[float] = None) -> Set[int]:
        now = time.monotonic() if now is None else now
        dead = set()
        for h, st in self.hosts.items():
            if st.alive and now - st.last_beat > self.deadline:
                st.alive = False
                dead.add(h)
        return dead

    def alive_count(self) -> int:
        return sum(1 for s in self.hosts.values() if s.alive)


def largest_mesh(n_chips: int, model_parallel: int) -> tuple:
    """Biggest (data, model) grid on the surviving chips, keeping the
    model-parallel degree (params must still fit) and maximising data."""
    data = n_chips // model_parallel
    # power-of-two data axis keeps batch divisibility simple
    p = 1
    while p * 2 <= data:
        p *= 2
    return (p, model_parallel)


@dataclasses.dataclass
class RecoveryEvent:
    step: int
    kind: str            # 'swap' | 'shrink'
    dead_hosts: List[int]
    new_mesh: tuple


class Supervisor:
    """Failure-driven control loop around a training job."""

    def __init__(self, n_hosts: int, chips_per_host: int,
                 model_parallel: int, spares: int = 0,
                 deadline_s: float = 60.0):
        self.monitor = HeartbeatMonitor(n_hosts, deadline_s)
        self.chips_per_host = chips_per_host
        self.model_parallel = model_parallel
        self.spares = spares
        self.events: List[RecoveryEvent] = []

    def handle_failures(self, step: int, dead: Set[int]) -> Optional[RecoveryEvent]:
        if not dead:
            return None
        if self.spares >= len(dead):
            self.spares -= len(dead)
            for h in dead:  # spare swapped in; host id reused
                self.monitor.beat(h)
            ev = RecoveryEvent(step, "swap", sorted(dead),
                               self.current_mesh())
        else:
            ev = RecoveryEvent(step, "shrink", sorted(dead),
                               largest_mesh(self.alive_chips(),
                                            self.model_parallel))
        self.events.append(ev)
        return ev

    def alive_chips(self) -> int:
        return self.monitor.alive_count() * self.chips_per_host

    def current_mesh(self) -> tuple:
        return largest_mesh(self.alive_chips(), self.model_parallel)


def run_with_failures(
    train_step: Callable[[int], float],
    save_fn: Callable[[int], None],
    restore_fn: Callable[[tuple], int],
    supervisor: Supervisor,
    n_steps: int,
    checkpoint_every: int = 10,
    failures: Optional[Dict[int, List[int]]] = None,
) -> List[float]:
    """Simulated run loop: ``failures[step] = [host_ids]`` dies at ``step``.

    On failure the loop restores from the latest checkpoint (re-running the
    steps since — exactly-once data semantics come from the stateless
    pipeline) and continues on the recovered/shrunk mesh.
    """
    failures = failures or {}
    losses: List[float] = []
    step = 0
    while step < n_steps:
        if step in failures:
            for h in failures.pop(step):
                self_state = supervisor.monitor.hosts[h]
                self_state.alive = False
            ev = supervisor.handle_failures(step, {e for e in
                                                   [h.host_id for h in
                                                    supervisor.monitor.hosts.values()
                                                    if not h.alive]})
            step = restore_fn(ev.new_mesh)
            continue
        loss = train_step(step)
        losses.append(loss)
        if step % checkpoint_every == 0:
            save_fn(step)
        step += 1
    return losses
