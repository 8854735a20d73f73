"""Fleet-scale simulation harness (ROADMAP item 4).

Drives the REAL serving control stack — load_balancer admission and
routing, DisaggSLOAutoscaler decisions from exposition text,
replica_managers state transitions, and the sqlite-or-Postgres state
backend with lease claims — against thousands of VIRTUAL replicas.
Only replica latency is modeled (slo_sim's PhaseCosts
processor-sharing model); every control-plane decision runs the
production code path, so the simulator proves fleet behavior at
scales hardware quota won't allow and its per-run profile report says
which control-plane hot path to make event-driven next.

The port's copy of the JAX package's simulator: no module of it
imports torch or JAX, so it runs on any host, the card's machine
included.  Entry points: ``python -m skypilot_tpu_torch.fleetsim``
(CLI) and tests/test_torch_fleetsim.py; the port's twin of
``bench.py`` will be the bench entry point (``bench_fleet``).
"""
from skypilot_tpu_torch.fleetsim.scenario import (LBSever, LeaseholderKill,
                                            PreemptionStorm, Scenario)
from skypilot_tpu_torch.fleetsim.sim import (FleetConfig, FleetResult,
                                       FleetSim, VirtualReplicaManager,
                                       fleet_config, run_fleet)
from skypilot_tpu_torch.fleetsim.traffic import (Request, TrafficGenerator,
                                           TrafficSpec)

__all__ = [
    'FleetConfig', 'FleetResult', 'FleetSim', 'LBSever',
    'LeaseholderKill', 'PreemptionStorm', 'Request', 'Scenario',
    'TrafficGenerator', 'TrafficSpec', 'VirtualReplicaManager',
    'fleet_config', 'run_fleet',
]
