"""Hot-path invariant analyzer of the port
(`python -m skypilot_tpu_torch.analysis`).

AST-based static analysis enforcing the performance and architecture
invariants the port's measurements rest on: one sync per decode step,
no CUDA-graph capture or kernel build mid-traffic, never-blocked event
loops, one DB access layer, bounded outbound IO, metric-registry
discipline.  See core.py for the framework, rules/ for the rule set,
and tests/test_torch_static_analysis.py for the tier-1 zero-findings
gate.  Pure AST: it imports neither torch nor any analyzed module.
"""
from skypilot_tpu_torch.analysis.core import (Finding, Project, Report,
                                              Rule, load_project,
                                              run_check)
from skypilot_tpu_torch.analysis.reporters import render_json, render_text

__all__ = ['Finding', 'Project', 'Report', 'Rule', 'load_project',
           'run_check', 'render_json', 'render_text']
