"""blocking-in-async: the event loops must never block.

The API server, the serve load balancer, the node agent and the
inference server are single-event-loop aiohttp apps: one synchronous
``time.sleep`` / ``requests.*`` / ``subprocess.*`` / sqlite call inside
an ``async def`` stalls EVERY in-flight request on that loop — on the
LB that is a head-of-line block for all replicas at once.  Blocking
work belongs on a thread (``loop.run_in_executor``) or in the executor
worker processes.  ``asyncio.sleep`` and aiohttp calls are of course
fine (awaited).  Annotate deliberate exceptions with
``# skytpu: allow-blocking(<reason>)``.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from skypilot_tpu_torch.analysis import callgraph as cg
from skypilot_tpu_torch.analysis.core import (Finding, Project, Rule,
                                        iter_non_def_descendants)

_SCOPE = ('server/', 'serve/load_balancer.py', 'agent/',
          'inference/server.py')
_SUBPROCESS_FNS = ('run', 'check_output', 'check_call', 'call',
                   'Popen', 'getoutput', 'getstatusoutput')
_REQUESTS_FNS = ('get', 'post', 'put', 'delete', 'head', 'patch',
                 'request', 'Session')


class BlockingAsyncRule(Rule):
    name = 'blocking-in-async'
    suppress_token = 'blocking'
    description = ('time.sleep / requests.* / subprocess.* / sqlite '
                   'inside async def in the server, LB and agent '
                   'event loops')

    def check(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        for module in project.modules:
            if not Project.in_scope(module, _SCOPE):
                continue
            for node in ast.walk(module.tree):
                if isinstance(node, ast.AsyncFunctionDef):
                    findings.extend(
                        self._check_async(project, module, node))
        return findings

    def _check_async(self, project: Project, module,
                     fn: ast.AsyncFunctionDef) -> List[Finding]:
        out = []
        for node in iter_non_def_descendants(fn):
            if not isinstance(node, ast.Call):
                continue
            what = self._blocking_call(node, module)
            if what is not None:
                out.append(project.finding(
                    self, module, node,
                    f'{what} inside async def {fn.name} — blocks the '
                    f'event loop (every in-flight request on it); '
                    f'use asyncio.sleep / run_in_executor'))
        return out

    def _blocking_call(self, call: ast.Call,
                       module) -> Optional[str]:
        dotted = cg._dotted(call.func)
        if dotted is None:
            return None
        resolved = cg.resolve_alias(dotted, module)
        head, _, tail = resolved.partition('.')
        if resolved == 'time.sleep':
            return 'time.sleep(...)'
        if head == 'requests' and tail in _REQUESTS_FNS:
            return f'requests.{tail}(...)'
        if head == 'subprocess' and tail in _SUBPROCESS_FNS:
            return f'subprocess.{tail}(...)'
        if head == 'sqlite3' or resolved.startswith(
                'skypilot_tpu_torch.utils.db_utils.'):
            return f'{resolved}(...) (synchronous sqlite)'
        return None
