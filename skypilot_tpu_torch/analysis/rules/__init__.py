"""Rule registry: one instance of every invariant rule.

Adding a rule = adding a module here and registering it; the tier-1
gate (tests/test_torch_static_analysis.py) requires every registered
rule to have at least one known-bad fixture proving it fires.
"""
from __future__ import annotations

from typing import List

from skypilot_tpu_torch.analysis.core import Rule
from skypilot_tpu_torch.analysis.rules.blocking_async import (
    BlockingAsyncRule)
from skypilot_tpu_torch.analysis.rules.db_discipline import DbDisciplineRule
from skypilot_tpu_torch.analysis.rules.hot_loop_sync import HotLoopSyncRule
from skypilot_tpu_torch.analysis.rules.metric_naming import (
    MetricNamingRule)
from skypilot_tpu_torch.analysis.rules.recompile_hazard import (
    RecompileHazardRule)
from skypilot_tpu_torch.analysis.rules.speculation import SpeculationRule
from skypilot_tpu_torch.analysis.rules.unbounded_io import UnboundedIoRule


def all_rules() -> List[Rule]:
    return [
        HotLoopSyncRule(),
        RecompileHazardRule(),
        BlockingAsyncRule(),
        DbDisciplineRule(),
        UnboundedIoRule(),
        MetricNamingRule(),
        SpeculationRule(),
    ]
