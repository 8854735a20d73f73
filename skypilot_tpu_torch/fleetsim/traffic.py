"""Workload generation: what millions of chat users look like.

Arrivals are a non-homogeneous Poisson process (thinning against the
rate envelope's maximum): a sinusoidal diurnal envelope times scripted
burst multipliers.  Each accepted arrival starts a multi-turn SESSION
— geometric turn count, exponential think time between turns — drawn
over a large user population.  Every turn carries a cacheable prefix
(the shared system prompt plus the session's accumulated history), so
prefix-affinity and radix-cache hit rates EMERGE from how the router
spreads sessions over replicas rather than being dialed in.

All randomness flows through ONE ``random.Random`` minted by
slo_sim.make_rng(seed) — the generator is byte-reproducible from the
CLI/bench ``--seed``.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import List, Optional, Tuple

from skypilot_tpu_torch.serve import slo_sim

# Cap on turns per session: the geometric tail is unbounded and a
# 10-sigma session must not outlive the sim horizon.
_MAX_TURNS = 32


@dataclasses.dataclass(frozen=True)
class Request:
    """One turn of one session, arriving at sim time ``t``."""
    t: float
    session_id: int
    user_id: int
    turn: int
    prompt_tokens: float    # NEW prompt tokens this turn
    prefix_tokens: float    # cacheable: shared prefix + session history
    new_tokens: float       # tokens to decode


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """The workload envelope (canonical values: slo_sim.FLEET_*)."""
    base_qps: float = slo_sim.FLEET_BASE_QPS
    diurnal_amplitude: float = slo_sim.FLEET_DIURNAL_AMPLITUDE
    diurnal_period_s: float = slo_sim.FLEET_DIURNAL_PERIOD_S
    mean_turns: float = slo_sim.FLEET_MEAN_TURNS
    mean_think_s: float = slo_sim.FLEET_MEAN_THINK_S
    users: int = slo_sim.FLEET_USERS
    prompt_tokens: float = slo_sim.FLEET_PROMPT_TOKENS
    new_tokens: float = slo_sim.FLEET_NEW_TOKENS
    shared_prefix_tokens: float = slo_sim.FLEET_SHARED_PREFIX_TOKENS
    turn_history_tokens: float = slo_sim.FLEET_TURN_HISTORY_TOKENS
    # (start_s, duration_s, multiplier) scripted burst windows.
    bursts: Tuple[Tuple[float, float, float], ...] = ()


class TrafficGenerator:

    def __init__(self, spec: TrafficSpec,
                 rng: Optional[random.Random] = None) -> None:
        self.spec = spec
        self.rng = rng if rng is not None else slo_sim.make_rng()

    # ----- the rate envelope --------------------------------------------------
    def rate(self, t: float) -> float:
        """Offered request rate (req/s) at sim time t."""
        s = self.spec
        diurnal = 1.0 + s.diurnal_amplitude * math.sin(
            2.0 * math.pi * t / s.diurnal_period_s)
        return max(0.0, s.base_qps * diurnal * self.burst_multiplier(t))

    def burst_multiplier(self, t: float) -> float:
        for start, duration, mult in self.spec.bursts:
            if start <= t < start + duration:
                return mult
        return 1.0

    def _rate_max(self) -> float:
        peak_burst = max([m for _, _, m in self.spec.bursts] + [1.0])
        return self.spec.base_qps * \
            (1.0 + abs(self.spec.diurnal_amplitude)) * peak_burst

    # ----- sampling -----------------------------------------------------------
    def _session_turns(self) -> int:
        """Geometric turn count with mean ``mean_turns``."""
        p_stop = 1.0 / max(self.spec.mean_turns, 1.0)
        turns = 1
        while turns < _MAX_TURNS and self.rng.random() > p_stop:
            turns += 1
        return turns

    def _turn_request(self, t: float, session_id: int, user_id: int,
                      turn: int) -> Request:
        s = self.spec
        prompt = max(16.0, self.rng.expovariate(1.0 / s.prompt_tokens))
        new = max(8.0, self.rng.expovariate(1.0 / s.new_tokens))
        prefix = s.shared_prefix_tokens + \
            (turn - 1) * s.turn_history_tokens
        return Request(t=t, session_id=session_id, user_id=user_id,
                       turn=turn, prompt_tokens=prompt,
                       prefix_tokens=prefix, new_tokens=new)

    def generate(self, horizon_s: float) -> List[Request]:
        """All requests arriving in [0, horizon), sorted by time.

        Sessions arrive as a thinned Poisson process at
        rate(t)/mean_turns — each contributing ~mean_turns requests
        spread over its think times, so the REQUEST rate tracks the
        envelope.
        """
        s = self.spec
        lam = self._rate_max() / max(s.mean_turns, 1.0)
        out: List[Request] = []
        session_id = 0
        t = 0.0
        while True:
            t += self.rng.expovariate(lam)
            if t >= horizon_s:
                break
            if self.rng.random() * self._rate_max() > self.rate(t):
                continue            # thinned: below the envelope here
            session_id += 1
            user_id = self.rng.randrange(s.users)
            turn_t = t
            for turn in range(1, self._session_turns() + 1):
                if turn > 1:
                    turn_t += self.rng.expovariate(1.0 / s.mean_think_s)
                    if turn_t >= horizon_s:
                        break
                out.append(self._turn_request(turn_t, session_id,
                                              user_id, turn))
        out.sort(key=lambda r: r.t)
        return out
