"""speculation: the verify dispatch stays one graph, built once.

Speculative decoding lives or dies on its dispatch discipline: the
propose/verify loop runs every engine step, so the verify call must be
captured ONCE (per bucket/draft-length shape) and replayed over its
fixed buffers.  Two hazards, both of which silently turn the
speculation win into a per-step capture stall:

1. A CUDA-graph capture (``torch.cuda.CUDAGraph()``,
   ``torch.cuda.graph(...)``, ``torch.cuda.make_graphed_callables``) or
   a ``torch.compile(...)`` INSIDE a propose/verify/draft function —
   these functions are called from the engine loop even when they are
   not lexically inside a loop, so the loop-based recompile rule cannot
   see it.

2. A verify graph (``_VerifyCall``) constructed anywhere other than the
   engine's build/prewarm path (a function named ``_new_*``,
   ``build*`` or ``prewarm*``): each construction captures a new graph
   and allocates new static buffers, where the engine keeps one and
   refills its draft buffer in place.

The engine's real wiring (``_new_verify_call``, reached from
``prewarm()`` and, once, from the first dispatch) is clean under both
checks.  Suppress with ``# skytpu: allow-spec(<why>)``.
"""
from __future__ import annotations

import ast
import re
from typing import List

from skypilot_tpu_torch.analysis import callgraph as cg
from skypilot_tpu_torch.analysis.core import (Finding, Project, Rule,
                                              iter_non_def_descendants)

# Function names that constitute the speculation hot loop.
_SPEC_FN_RE = re.compile(r'(propose|verify|draft)', re.IGNORECASE)
# The engine's build/prewarm path: where a verify graph may be built.
_BUILD_FN_RE = re.compile(r'^_*(new|build|prewarm)', re.IGNORECASE)
# The verify graph's class.
VERIFY_GRAPH_CLASS = '_VerifyCall'


class SpeculationRule(Rule):
    name = 'speculation'
    suppress_token = 'spec'
    description = ('the speculative verify dispatch must stay one '
                   'captured graph: no CUDA-graph capture or '
                   'torch.compile inside propose/verify/draft functions, '
                   'and a verify graph is built only on the build/'
                   'prewarm path')

    def check(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        for module in project.modules:
            for node in ast.walk(module.tree):
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                spec_fn = _SPEC_FN_RE.search(node.name)
                build_fn = _BUILD_FN_RE.search(node.name)
                for call in iter_non_def_descendants(node):
                    if not isinstance(call, ast.Call):
                        continue
                    kind = cg.graph_kind(call, module)
                    if spec_fn and kind in ('capture', 'compile'):
                        what = ('CUDA-graph capture' if kind == 'capture'
                                else 'torch.compile')
                        findings.append(project.finding(
                            self, module, call,
                            f'{what} inside {node.name!r}: the propose/'
                            f'verify loop runs every engine step — build '
                            f'the verify graph once and replay it'))
                    elif not build_fn and self._builds_verify(call):
                        findings.append(project.finding(
                            self, module, call,
                            f'verify graph built in {node.name!r}, off '
                            f'the build/prewarm path — each one captures '
                            f'a new graph and allocates new static '
                            f'buffers; build it once and refill its '
                            f'draft buffer'))
        return findings

    @staticmethod
    def _builds_verify(call: ast.Call) -> bool:
        dotted = cg._dotted(call.func)
        return dotted is not None and \
            dotted.split('.')[-1] == VERIFY_GRAPH_CLASS
