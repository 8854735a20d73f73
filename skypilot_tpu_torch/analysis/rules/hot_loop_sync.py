"""hot-loop-sync: no device->host sync on the hot loops.

The decode engine's contract is exactly ONE sync per step (the
``.cpu()`` of the call's output rows); the trainer's dispatch runs
ahead of the device and reads it back only at a log boundary.  Any
other read of the device from the host in a function reachable from
those loops serializes host and device: the host waits for the queue
to drain, and the card idles while the host catches up.  In PyTorch
many such reads are implicit, so the rule flags:

- ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to('cpu')``
  and ``.to(device='cpu')``;
- ``torch.cuda.synchronize()`` and ``.synchronize()`` on an Event or a
  Stream;
- ``np.asarray(...)`` / ``np.array(...)`` of an expression that
  mentions ``torch``;
- ``float``/``int``/``bool`` of an expression that mentions a
  torch-aliased name;
- ``torch.tensor(...)`` / ``torch.as_tensor(...)`` with a ``device=``
  other than ``'cpu'``: a blocking host->device copy, which waits for
  the stream to drain (pinned memory and ``non_blocking=True`` do not);
- the ops whose output shape depends on the data, which wait for the
  device to learn it: ``.nonzero()``, ``torch.nonzero``,
  ``torch.unique``, ``torch.masked_select``, and ``.any()``/``.all()``
  used as an ``if``/``while`` test.

The rule reads names, not types: a host-side tensor (a gloo control-
plane int, a numpy-backed CPU tensor) or a numpy array looks the same
as a device tensor.  Such a site, and every intentional sync, carries
``# skytpu: allow-sync(<reason>)`` at the call site.

Entry points: functions marked ``# skytpu: hot-entry`` plus the known
engine/trainer/RL loops as hardcoded backstops.  Code that runs only
while a CUDA graph is captured is skipped (see callgraph.py: a sync
there raises at capture, it cannot stall a step).
"""
from __future__ import annotations

import ast
from typing import List, Optional

from skypilot_tpu_torch.analysis import callgraph as cg
from skypilot_tpu_torch.analysis.core import (Finding, Project, Rule,
                                              iter_non_def_descendants)

# Backstop entry points (qualname suffixes) — the marker comment in the
# source is the primary mechanism; these keep the gate honest even if a
# marker is dropped.
DEFAULT_ENTRY_POINTS = (
    'skypilot_tpu_torch.inference.engine.DecodeEngine.step',
    'skypilot_tpu_torch.inference.engine.DecodeEngine.step_pipelined',
    'skypilot_tpu_torch.inference.engine.DecodeEngine._loop',
    'skypilot_tpu_torch.inference.engine.DecodeEngine.drain',
    'skypilot_tpu_torch.inference.engine.DecodeEngine.follow',
    'skypilot_tpu_torch.train.trainer.Trainer.run',
    'skypilot_tpu_torch.train.rl.rollout',
)

# Tensor methods that copy to the host (no arguments).
_SYNC_METHODS = ('item', 'tolist', 'cpu', 'numpy', 'nonzero')
# numpy entry points that materialize a tensor on the host.
_NUMPY_SYNCS = ('asarray', 'array')
# torch functions whose output shape depends on the data.
_DATA_SHAPE_FNS = ('torch.nonzero', 'torch.unique', 'torch.masked_select')
_REDUCE_TESTS = ('any', 'all')
# torch constructors that copy host data, blocking, to a device= target.
_UPLOADS = ('torch.tensor', 'torch.as_tensor')


def _torchish(node: ast.AST, module) -> bool:
    """Does the expression mention a torch-aliased name?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            resolved = cg.resolve_alias(sub.id, module)
            if resolved == 'torch' or resolved.startswith('torch.'):
                return True
    return False


def _is_sync_call(node: ast.AST) -> bool:
    """`x.cpu()` / `x.to('cpu')`: a call that already copied to the host."""
    return isinstance(node, ast.Call) and \
        isinstance(node.func, ast.Attribute) and (
            node.func.attr == 'cpu' or
            (node.func.attr == 'to' and any(_is_cpu(a) for a in node.args)))


def _is_cpu(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value == 'cpu'


class HotLoopSyncRule(Rule):
    name = 'hot-loop-sync'
    suppress_token = 'sync'
    description = ('device->host syncs (.item()/.cpu()/.tolist()/'
                   '.numpy()/synchronize/float-on-tensor/data-dependent '
                   'shapes) reachable from the decode loop / train step '
                   '/ RL rollout')

    def __init__(self) -> None:
        self.entry_points_used: List[str] = []

    def check(self, project: Project) -> List[Finding]:
        graph = project.callgraph
        entries = graph.entry_points(defaults=DEFAULT_ENTRY_POINTS)
        self.entry_points_used = entries
        reachable = graph.reachable_from(entries)
        findings: List[Finding] = []
        where = (f'reachable from hot entry '
                 f'point{"s" if len(entries) > 1 else ""}')
        for qual in sorted(reachable):
            info = graph.functions[qual]
            if info.captured:
                continue
            module = info.module
            for call in info.calls:
                if id(call) in info.captured_calls:
                    continue
                msg = self._sync_message(call, module)
                if msg is not None:
                    findings.append(project.finding(
                        self, module, call,
                        f'{msg} in {qual} ({where}) — the host waits '
                        f'for the device on a hot loop'))
            for node in iter_non_def_descendants(info.node):
                if isinstance(node, (ast.If, ast.While)):
                    test = 'an if' if isinstance(node, ast.If) else 'a while'
                    for call in self._reduce_tests(node.test):
                        if id(call) in info.captured_calls:
                            continue
                        findings.append(project.finding(
                            self, module, call,
                            f'.{call.func.attr}() as {test} test in '
                            f'{qual} ({where}) — the host waits for '
                            f'the device to learn the branch'))
        return findings

    @staticmethod
    def _reduce_tests(test: ast.AST) -> List[ast.Call]:
        return [n for n in ast.walk(test)
                if isinstance(n, ast.Call) and
                isinstance(n.func, ast.Attribute) and
                n.func.attr in _REDUCE_TESTS and not n.args]

    def _sync_message(self, call: ast.Call,
                      module) -> Optional[str]:
        func = call.func
        dotted = cg._dotted(func)
        if dotted is not None:
            resolved = cg.resolve_alias(dotted, module)
            if resolved in _DATA_SHAPE_FNS:
                return f'{resolved}(...)'
            if resolved == 'torch.cuda.synchronize':
                return 'torch.cuda.synchronize()'
            if resolved in _UPLOADS and any(
                    kw.arg == 'device' and not _is_cpu(kw.value)
                    for kw in call.keywords):
                return f'{resolved}(..., device=) (blocking upload)'
            head, _, tail = resolved.partition('.')
            if head == 'numpy' and tail in _NUMPY_SYNCS and \
                    call.args and _torchish(call.args[0], module):
                return f'np.{tail}(<tensor>)'
        if isinstance(func, ast.Attribute):
            if func.attr in _SYNC_METHODS and not call.args:
                if func.attr in ('numpy', 'tolist') and \
                        _is_sync_call(func.value):
                    return None     # the .cpu() under it is the sync
                return f'.{func.attr}()'
            if func.attr == 'synchronize':
                return '.synchronize()'
            if func.attr == 'to' and (
                    any(_is_cpu(a) for a in call.args) or
                    any(kw.arg == 'device' and _is_cpu(kw.value)
                        for kw in call.keywords)):
                return ".to('cpu')"
        if isinstance(func, ast.Name) and \
                func.id in ('float', 'int', 'bool') and \
                len(call.args) == 1 and _torchish(call.args[0], module):
            return f'{func.id}(<tensor>)'
        return None
