"""Straggler mitigation.

A copy of the JAX package's ``repro.runtime.straggler`` (pure
Python): the port keeps its own, as it imports nothing of ``repro``.

At 1000+ nodes, tail-latency hosts dominate step time (synchronous SPMD
waits for the slowest). Mitigations implemented:

  StragglerDetector — online per-host step-time EWMA + robust z-score; a
    host whose recent step times exceed median + k·MAD for ``patience``
    consecutive windows is flagged. Flagged hosts trigger Supervisor.swap
    (treat as soft failure) — the standard production response, since a
    chronically slow host is usually failing hardware.

  BackupStepPolicy — for the final (straggler-prone) steps of a job:
    schedule speculative duplicates of the data shards of flagged hosts on
    the fastest hosts and take whichever finishes first (requires stateless
    data pipeline — we have one).
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from collections import defaultdict, deque
from typing import Deque, Dict, List, Optional, Set


@dataclasses.dataclass
class StragglerConfig:
    window: int = 20          # step-time history per host
    k_mad: float = 4.0        # robust threshold
    patience: int = 3         # consecutive flagged windows before action
    min_steps: int = 10


class StragglerDetector:
    def __init__(self, n_hosts: int, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.times: Dict[int, Deque[float]] = {
            h: deque(maxlen=cfg.window) for h in range(n_hosts)
        }
        self.strikes: Dict[int, int] = defaultdict(int)

    def report(self, host_id: int, step_time_s: float):
        self.times[host_id].append(step_time_s)

    def flagged(self) -> Set[int]:
        """Hosts currently beyond median + k·MAD of the fleet."""
        recents = {
            h: statistics.fmean(ts) for h, ts in self.times.items()
            if len(ts) >= self.cfg.min_steps
        }
        if len(recents) < 3:
            return set()
        vals = sorted(recents.values())
        med = vals[len(vals) // 2]
        mad = statistics.median([abs(v - med) for v in vals]) or 1e-9
        out = set()
        for h, v in recents.items():
            if v > med + self.cfg.k_mad * 1.4826 * mad:
                self.strikes[h] += 1
                if self.strikes[h] >= self.cfg.patience:
                    out.add(h)
            else:
                self.strikes[h] = 0
        return out


@dataclasses.dataclass
class SpeculativeAssignment:
    shard: int
    primary_host: int
    backup_host: int


def plan_backups(flagged: Set[int], fastest: List[int],
                 shard_of_host: Dict[int, int]) -> List[SpeculativeAssignment]:
    """Duplicate flagged hosts' data shards onto the fastest healthy hosts
    (stateless pipeline ⇒ the duplicate computes an identical gradient
    shard; first-finisher wins, the other is cancelled)."""
    plans = []
    backups = [h for h in fastest if h not in flagged]
    for i, h in enumerate(sorted(flagged)):
        if i < len(backups):
            plans.append(SpeculativeAssignment(shard_of_host[h], h, backups[i]))
    return plans
