"""metric-naming: registry discipline for every exported family AND
every flight-recorder span.

server/metrics.py renders the Prometheus exposition format itself and
the LB federates it across replicas — so naming is a cross-process
contract: consumers (SLO autoscaler, admission control, dashboards)
find series by name.  tests/test_observability.py asserts the
conventions dynamically for call sites the tests happen to execute;
this rule asserts them for EVERY call site statically:

- the family name is a legal Prometheus metric name;
- it has a ``_HELP`` entry in server/metrics.py (central registry);
- counters end ``_total``; gauges must NOT end ``_total``;
  histogram/summary families end ``_seconds``/``_bytes``/``_ratio``;
- device-cost attribution suffixes (``_mfu``/``_per_token``/
  ``_intensity`` — the perf/cost_model.py families) are gauge-only:
  they name instantaneous modeled quantities, and exporting one as a
  counter or histogram misleads every roofline consumer downstream.

The flight recorder's span names (server/tracing.py) are the same kind
of cross-process contract — the LB federates /debug views by span name
and `skytpu trace`'s decomposition keys on them — so every
``record_span``/``record_instant`` call site is held to the same bar:

- the span name is legal (dotted lowercase, ``component.event``);
- it has a ``SPAN_HELP`` entry in server/tracing.py.

SLO alert rules (obs/alerts.py) are consumers on the far END of that
contract: an ``AlertRule`` naming a family nobody registers would
never fire and never error — the worst observability failure mode.  So
every statically-visible ``AlertRule(...)`` construction's ``family=``
/ ``ratio_family=`` keyword must resolve to a ``_HELP``-registered
family.

Names are resolved statically: string literals, module-level string
constants, and ``metrics_lib.<CONST>`` attributes (parsed out of
server/metrics.py — nothing is imported).  Dynamically-built names are
skipped (and are themselves a smell worth avoiding).
"""
from __future__ import annotations

import ast
import importlib.util
import re
from typing import Dict, List, Optional

from skypilot_tpu_torch.analysis import callgraph as cg
from skypilot_tpu_torch.analysis.core import Finding, Module, Project, Rule

_METRICS_MODULE = 'skypilot_tpu_torch.server.metrics'
_TRACING_MODULE = 'skypilot_tpu_torch.server.tracing'
_ALERTS_MODULE = 'skypilot_tpu_torch.obs.alerts'
# AlertRule keywords that must name a registered metric family.
_ALERT_FAMILY_KWARGS = ('family', 'ratio_family')
_NAME_RE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*$')
# Span names: dotted lowercase, component.event.
_SPAN_NAME_RE = re.compile(r'^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$')
# registration fn -> instrument kind
_KINDS = {
    'inc_counter': 'counter',
    'set_gauge': 'gauge',
    'add_gauge': 'gauge',
    'remove_gauge': 'gauge',
    'observe': 'summary',
    'observe_hist': 'histogram',
}
# Flight-recorder registration fns (span name = 2nd positional arg).
_SPAN_FNS = ('record_span', 'record_instant')
# Device-cost attribution suffixes (perf/cost_model.py): instantaneous
# modeled ratios, legal only as gauges — see module docstring.
_GAUGE_ONLY_SUFFIXES = ('_mfu', '_per_token', '_intensity')


def _module_constants(tree: ast.AST) -> Dict[str, str]:
    """Module-level NAME = 'literal' assignments."""
    out: Dict[str, str] = {}
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str):
            out[node.targets[0].id] = node.value.value
    return out


def _dict_keys(tree: ast.AST, var_name: str) -> Optional[set]:
    """String keys of a module-level ``var_name = {...}`` dict literal
    (the _HELP registry in server/metrics.py, SPAN_HELP in
    server/tracing.py)."""
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == var_name and \
                isinstance(node.value, ast.Dict):
            keys = set()
            for k in node.value.keys:
                if isinstance(k, ast.Constant) and \
                        isinstance(k.value, str):
                    keys.add(k.value)
            return keys
    return None


def _load_module_ast(module_name: str) -> Optional[ast.AST]:
    """Parse an installed module's source (never imported)."""
    try:
        spec = importlib.util.find_spec(module_name)
        if spec is None or not spec.origin:
            return None
        with open(spec.origin, 'r', encoding='utf-8') as f:
            return ast.parse(f.read(), filename=spec.origin)
    except (OSError, SyntaxError, ImportError, ValueError):
        return None


class MetricNamingRule(Rule):
    name = 'metric-naming'
    suppress_token = 'metric-naming'
    description = ('registered metric families must satisfy the '
                   'exposition-format conventions and have a _HELP '
                   'entry in server/metrics.py; flight-recorder spans '
                   'must be legal dotted names with a SPAN_HELP entry '
                   'in server/tracing.py')

    def check(self, project: Project) -> List[Finding]:
        # Prefer the metrics/tracing modules from the analyzed set (so
        # a fixture tree can ship its own); fall back to the installed
        # ones for fixture files that register against the real
        # registries.
        metrics_mod = project.module_by_suffix('server/metrics.py')
        metrics_tree = metrics_mod.tree if metrics_mod else \
            _load_module_ast(_METRICS_MODULE)
        help_keys = _dict_keys(metrics_tree, '_HELP') \
            if metrics_tree else None
        metrics_consts = (_module_constants(metrics_tree)
                          if metrics_tree else {})
        tracing_mod = project.module_by_suffix('server/tracing.py')
        tracing_tree = tracing_mod.tree if tracing_mod else \
            _load_module_ast(_TRACING_MODULE)
        span_keys = _dict_keys(tracing_tree, 'SPAN_HELP') \
            if tracing_tree else None
        findings: List[Finding] = []
        for module in project.modules:
            consts = _module_constants(module.tree)
            for node in ast.walk(module.tree):
                if not isinstance(node, ast.Call):
                    continue
                kind = self._registration_kind(node, module)
                if kind is not None:
                    name = self._static_name(node, module, consts,
                                             metrics_consts, arg_idx=0)
                    if name is None:
                        continue  # dynamic name: out of static reach
                    findings.extend(self._check_name(
                        project, module, node, kind, name, help_keys))
                    continue
                if self._is_span_registration(node, module):
                    name = self._static_name(node, module, consts,
                                             metrics_consts, arg_idx=1)
                    if name is None:
                        continue
                    findings.extend(self._check_span_name(
                        project, module, node, name, span_keys))
                    continue
                if self._is_alert_rule(node, module):
                    findings.extend(self._check_alert_rule(
                        project, module, node, consts, metrics_consts,
                        help_keys))
        return findings

    def _registration_kind(self, call: ast.Call,
                           module: Module) -> Optional[str]:
        dotted = cg._dotted(call.func)
        if dotted is None:
            return None
        resolved = cg.resolve_alias(dotted, module)
        last = resolved.split('.')[-1]
        if last not in _KINDS:
            return None
        # Only calls that resolve into the metrics module (via module
        # alias or from-import) — an unrelated local `observe` is not
        # a metric registration.
        if resolved == f'{_METRICS_MODULE}.{last}':
            return _KINDS[last]
        return None

    def _is_span_registration(self, call: ast.Call,
                              module: Module) -> bool:
        dotted = cg._dotted(call.func)
        if dotted is None:
            return False
        resolved = cg.resolve_alias(dotted, module)
        last = resolved.split('.')[-1]
        return last in _SPAN_FNS and \
            resolved == f'{_TRACING_MODULE}.{last}'

    def _is_alert_rule(self, call: ast.Call, module: Module) -> bool:
        dotted = cg._dotted(call.func)
        if dotted is None:
            return False
        resolved = cg.resolve_alias(dotted, module)
        return resolved == f'{_ALERTS_MODULE}.AlertRule'

    def _check_alert_rule(self, project: Project, module: Module,
                          call: ast.Call, consts: Dict[str, str],
                          metrics_consts: Dict[str, str],
                          help_keys) -> List[Finding]:
        """Every statically-resolvable family reference in an AlertRule
        must be a registered family — a rule watching an unregistered
        name silently never fires (dynamically-built values are out of
        static reach, same posture as registration names)."""
        out: List[Finding] = []
        if help_keys is None:
            return out
        for kw in call.keywords:
            if kw.arg not in _ALERT_FAMILY_KWARGS:
                continue
            name = self._static_value(kw.value, module, consts,
                                      metrics_consts)
            if name is None or not name:
                continue
            if name not in help_keys:
                out.append(project.finding(
                    self, module, call,
                    f'AlertRule {kw.arg}={name!r} references a family '
                    f'with no _HELP entry in server/metrics.py — an '
                    f'alert rule on an unregistered family can never '
                    f'fire'))
        return out

    def _static_name(self, call: ast.Call, module: Module,
                     consts: Dict[str, str],
                     metrics_consts: Dict[str, str],
                     arg_idx: int = 0) -> Optional[str]:
        if len(call.args) <= arg_idx:
            return None
        return self._static_value(call.args[arg_idx], module, consts,
                                  metrics_consts)

    def _static_value(self, arg: ast.expr, module: Module,
                      consts: Dict[str, str],
                      metrics_consts: Dict[str, str]) -> Optional[str]:
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value
        if isinstance(arg, ast.Name):
            return consts.get(arg.id)
        if isinstance(arg, ast.Attribute) and \
                isinstance(arg.value, ast.Name):
            base = cg.resolve_alias(arg.value.id, module)
            if base == _METRICS_MODULE:
                return metrics_consts.get(arg.attr)
        return None

    def _check_span_name(self, project: Project, module: Module,
                         node: ast.Call, name: str,
                         span_keys) -> List[Finding]:
        out = []
        if not _SPAN_NAME_RE.match(name):
            out.append(project.finding(
                self, module, node,
                f'{name!r} is not a legal span name (dotted lowercase '
                f'component.event, e.g. engine.queue_wait)'))
            return out
        if span_keys is not None and name not in span_keys:
            out.append(project.finding(
                self, module, node,
                f'span {name!r} has no SPAN_HELP entry in '
                f'server/tracing.py — every recorded span is '
                f'documented centrally (federation and skytpu trace '
                f'key on these names)'))
        return out

    def _check_name(self, project: Project, module: Module,
                    node: ast.Call, kind: str, name: str,
                    help_keys) -> List[Finding]:
        out = []
        if not _NAME_RE.match(name):
            out.append(project.finding(
                self, module, node,
                f'metric name {name!r} is not a legal Prometheus '
                f'metric name'))
            return out
        if kind == 'counter' and not name.endswith('_total'):
            out.append(project.finding(
                self, module, node,
                f'counter {name!r} must end _total (exposition '
                f'convention; federation consumers rely on it)'))
        if kind == 'gauge' and name.endswith('_total'):
            out.append(project.finding(
                self, module, node,
                f'gauge {name!r} must not end _total (that suffix '
                f'promises a monotonic counter)'))
        if kind in ('histogram', 'summary') and not name.endswith(
                ('_seconds', '_bytes', '_ratio')):
            out.append(project.finding(
                self, module, node,
                f'{kind} {name!r} must carry a unit suffix '
                f'(_seconds/_bytes/_ratio)'))
        if kind != 'gauge' and name.endswith(_GAUGE_ONLY_SUFFIXES):
            out.append(project.finding(
                self, module, node,
                f'{kind} {name!r} carries a device-cost attribution '
                f'suffix ({"/".join(_GAUGE_ONLY_SUFFIXES)}) — these '
                f'are instantaneous modeled quantities, legal only '
                f'as gauges'))
        if help_keys is not None and name not in help_keys:
            out.append(project.finding(
                self, module, node,
                f'{name!r} has no _HELP entry in server/metrics.py — '
                f'every exported family is documented centrally'))
        return out
