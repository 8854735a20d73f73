"""Spot placement for serve replicas (capability parity:
sky/serve/spot_placer.py:170 DynamicFailoverSpotPlacer).

Spreads spot replicas across zones, remembering which zones preempted
recently: a zone moves active -> preempted on preemption and back to
active only when every zone has been exhausted (all-preempted resets the
pool, matching the reference's dynamic failover).  Pure policy — the
replica manager feeds it zone candidates from the catalog and reports
preemptions.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional


class SpotPlacer:

    def __init__(self, zones: List[str]) -> None:
        self._lock = threading.Lock()
        self._active: List[str] = list(dict.fromkeys(zones))
        self._preempted: List[str] = []
        # Zones currently used by live spot replicas (for spreading).
        self._in_use: Dict[str, int] = collections.defaultdict(int)

    def select(self) -> Optional[str]:
        """Zone for the next spot replica: the least-used active zone.
        Returns None when no zones are known (placement unconstrained)."""
        with self._lock:
            if not self._active and self._preempted:
                # Every zone has preempted us; reset rather than refusing
                # to place (the reference's all-preempted fallback).
                self._active, self._preempted = self._preempted, []
            if not self._active:
                return None
            zone = min(self._active, key=lambda z: self._in_use[z])
            self._in_use[zone] += 1
            return zone

    def handle_preemption(self, zone: Optional[str]) -> None:
        with self._lock:
            if zone is None:
                return
            self._release_locked(zone)
            if zone in self._active:
                self._active.remove(zone)
                if zone not in self._preempted:
                    self._preempted.append(zone)

    def handle_termination(self, zone: Optional[str]) -> None:
        """A replica in `zone` was scaled down / shut down normally."""
        with self._lock:
            if zone is not None:
                self._release_locked(zone)

    def _release_locked(self, zone: str) -> None:
        if self._in_use.get(zone, 0) > 0:
            self._in_use[zone] -= 1

    def active_zones(self) -> List[str]:
        with self._lock:
            return list(self._active)

    def preempted_zones(self) -> List[str]:
        with self._lock:
            return list(self._preempted)
