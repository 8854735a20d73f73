"""Scripted scenario events: spot churn and control-plane chaos.

Three event kinds, each firing exactly once at its scheduled sim time:

- ``PreemptionStorm``: preempt a fraction of one pool's READY spot
  replicas through the manager's REAL terminate path (SHUTTING_DOWN ->
  PREEMPTED rows, preemption counter) — victims sampled from the run's
  seeded RNG so the storm is reproducible.
- ``LeaseholderKill``: the singleton-lease holder dies mid-run; its
  heartbeat row goes stale and the simulator's own (real)
  ``leases.try_acquire_singleton`` performs the genuine dead-holder
  CAS takeover once the TTL has elapsed in sim time.  Scaling is
  frozen in between — the cost of controller failover, measured.
- ``LBSever``: one load balancer drops out of rotation for a window
  (its admission view freezes); traffic anycasts to the survivors.

Scenarios load from YAML/dicts (``Scenario.from_config``) so CI jobs
and the bench share one description format; ``canonical()`` returns
the published FLEET scenario documented next to slo_sim's FLEET_*
constants.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from skypilot_tpu_torch.serve import slo_sim


@dataclasses.dataclass
class PreemptionStorm:
    at_s: float
    fraction: float
    pool: str = 'decode'
    fired: bool = False
    kind: str = dataclasses.field(default='preemption_storm',
                                  init=False)


@dataclasses.dataclass
class LeaseholderKill:
    at_s: float
    fired: bool = False
    kind: str = dataclasses.field(default='leaseholder_kill',
                                  init=False)


@dataclasses.dataclass
class LBSever:
    at_s: float
    duration_s: float
    lb_index: int = 0
    fired: bool = False
    kind: str = dataclasses.field(default='lb_sever', init=False)


Event = Any  # one of the three dataclasses above


class Scenario:
    """An ordered script of events plus traffic burst windows."""

    def __init__(self, events: Optional[List[Event]] = None,
                 bursts: Tuple[Tuple[float, float, float], ...] = ()
                 ) -> None:
        self.events: List[Event] = list(events or [])
        self.bursts = tuple(bursts)

    def due(self, t0: float, t1: float) -> List[Event]:
        """Events scheduled in [t0, t1) that have not fired yet; each
        is returned exactly once (the caller fires it)."""
        out = []
        for ev in self.events:
            if not ev.fired and t0 <= ev.at_s < t1:
                ev.fired = True
                out.append(ev)
        return out

    # ----- construction -------------------------------------------------------
    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> 'Scenario':
        events: List[Event] = []
        for raw in config.get('events', []):
            kind = raw.get('kind')
            if kind == 'preemption_storm':
                events.append(PreemptionStorm(
                    at_s=float(raw['at_s']),
                    fraction=float(raw['fraction']),
                    pool=str(raw.get('pool', 'decode'))))
            elif kind == 'leaseholder_kill':
                events.append(LeaseholderKill(at_s=float(raw['at_s'])))
            elif kind == 'lb_sever':
                events.append(LBSever(
                    at_s=float(raw['at_s']),
                    duration_s=float(raw['duration_s']),
                    lb_index=int(raw.get('lb', 0))))
            else:
                raise ValueError(f'unknown scenario event kind: '
                                 f'{kind!r}')
        bursts = tuple(
            (float(b['at_s']), float(b['duration_s']),
             float(b['multiplier']))
            for b in config.get('bursts', []))
        return cls(events, bursts)

    @classmethod
    def load(cls, path: str) -> 'Scenario':
        import yaml
        with open(path, encoding='utf-8') as f:
            return cls.from_config(yaml.safe_load(f) or {})

    @classmethod
    def canonical(cls) -> 'Scenario':
        """The published FLEET scenario: a burst riding the diurnal
        peak, a preemption storm mid-burst, the lease holder killed
        one second into the storm, and an LB severed on the decline."""
        return cls.from_config({
            'events': [
                {'kind': 'preemption_storm',
                 'at_s': slo_sim.FLEET_STORM_AT_S,
                 'fraction': slo_sim.FLEET_STORM_FRACTION,
                 'pool': 'decode'},
                {'kind': 'leaseholder_kill',
                 'at_s': slo_sim.FLEET_KILL_AT_S},
                {'kind': 'lb_sever',
                 'at_s': slo_sim.FLEET_SEVER_AT_S,
                 'duration_s': slo_sim.FLEET_SEVER_DURATION_S,
                 'lb': 0},
            ],
            'bursts': [
                {'at_s': slo_sim.FLEET_BURST_AT_S,
                 'duration_s': slo_sim.FLEET_BURST_DURATION_S,
                 'multiplier': slo_sim.FLEET_BURST_MULTIPLIER},
            ],
        })
