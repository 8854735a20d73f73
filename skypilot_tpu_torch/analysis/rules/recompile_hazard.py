"""recompile-hazard: no graph capture, compile or kernel build mid-traffic.

The port's counterpart of an XLA recompile is a CUDA-graph capture (a
stall of many milliseconds, and fresh graph-pool memory each time), a
``torch.compile`` (seconds) or a kernel build (nvcc: seconds to
minutes).  Each belongs at build or prewarm time, once per shape.  Two
hazards:

1. A capture (``torch.cuda.CUDAGraph()``, ``torch.cuda.graph(...)``,
   ``torch.cuda.make_graphed_callables(...)``), a ``torch.compile(...)``
   or a kernel build (``torch.utils.cpp_extension.load*``, or the
   port's own build in ``ops/cuda/flash_attention.py``) lexically
   inside a ``for``/``while`` loop or a comprehension — a fresh graph
   or compiled callable per iteration.  Anywhere in the package.

2. Any of those in a HOT module (the decode engine, trainer, RL step,
   weights lifecycle) in a function reachable from a hot entry point
   (the sync rule's entry points): a capture on a per-step path.  The
   engine's intended one-shot capture (one graph per engine call, which
   ``prewarm()`` makes before traffic) and the prewarm's kernel build
   carry ``# skytpu: allow-recompile(<reason>)``.
"""
from __future__ import annotations

import ast
from typing import List

from skypilot_tpu_torch.analysis import callgraph as cg
from skypilot_tpu_torch.analysis.core import (Finding, Project, Rule,
                                              iter_non_def_descendants)
from skypilot_tpu_torch.analysis.rules.hot_loop_sync import (
    DEFAULT_ENTRY_POINTS)

_HOT_MODULES = ('inference/engine.py', 'train/trainer.py',
                'train/rl.py', 'inference/weights.py')
_LOOPS = (ast.For, ast.While, ast.AsyncFor, ast.ListComp, ast.SetComp,
          ast.DictComp, ast.GeneratorExp)
_WHAT = {'capture': 'CUDA-graph capture', 'compile': 'torch.compile',
         'build': 'kernel build'}


class RecompileHazardRule(Rule):
    name = 'recompile-hazard'
    suppress_token = 'recompile'
    description = ('CUDA-graph capture, torch.compile or kernel build '
                   'inside loops, or reachable from a hot entry point '
                   'in the hot modules')

    def check(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        # Dedupe across nested loops and the two hazards: a capture
        # inside `for: while:` of a hot function is ONE finding.
        seen = set()

        def add(module, node, message):
            key = (module.rel, node.lineno, node.col_offset)
            if key not in seen:
                seen.add(key)
                findings.append(project.finding(self, module, node,
                                                message))

        for module in project.modules:
            for loop in ast.walk(module.tree):
                if not isinstance(loop, _LOOPS):
                    continue
                for node in iter_non_def_descendants(loop):
                    kind = (cg.graph_kind(node, module)
                            if isinstance(node, ast.Call) else None)
                    if kind is not None:
                        add(module, node,
                            f'{_WHAT[kind]} inside a loop — a fresh '
                            f'graph / compiled callable / library per '
                            f'iteration (a stall on a per-request '
                            f'path)')
        graph = project.callgraph
        entries = graph.entry_points(defaults=DEFAULT_ENTRY_POINTS)
        for qual in sorted(graph.reachable_from(entries)):
            info = graph.functions[qual]
            module = info.module
            if not any(module.path.endswith(m) or module.rel.endswith(m)
                       for m in _HOT_MODULES):
                continue
            for call in info.calls:
                kind = cg.graph_kind(call, module)
                if kind is not None:
                    add(module, call,
                        f'{_WHAT[kind]} in {qual}, reachable from a hot '
                        f'entry point — a stall of milliseconds to '
                        f'minutes (and new graph-pool memory) if it '
                        f'runs mid-traffic')
        findings.sort(key=lambda f: (f.path, f.line, f.col))
        return findings
