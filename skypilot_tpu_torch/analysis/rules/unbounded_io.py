"""unbounded-io: every outbound call in control-plane code is bounded.

Provisioning, controllers and recovery paths talk to cloud APIs and
remote hosts; a hung TCP connection with no timeout wedges a
controller tick (and with it every service/job that controller owns)
forever.  Three checks over the control-plane scope:

1. ``requests.<verb>(...)`` (and ``*session*.<verb>(...)``) without a
   ``timeout=`` kwarg;
2. ``subprocess.run/check_output/check_call/call(...)`` without
   ``timeout=`` (``Popen`` is exempt: it does not block by itself and
   its ``wait``/pumps carry their own deadlines);
3. ``while True:`` retry loops that make a network call with neither a
   sleep/backoff nor a deadline (``time.time``/``time.monotonic``)
   anywhere in the body — the hot-spin/no-bound retry shape.

Bulk data transfers (rsync / gsutil / aws s3) are bounded by data
size, not wall time — those sites carry
``# skytpu: allow-unbounded-io(<reason>)``.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from skypilot_tpu_torch.analysis import callgraph as cg
from skypilot_tpu_torch.analysis.core import (Finding, Project, Rule,
                                        iter_non_def_descendants)

_SCOPE = ('provision/', 'jobs/', 'clouds/', 'backends/', 'data/',
          'serve/', 'agent/', 'catalog/', 'authentication.py',
          'controller_vm.py', 'utils/command_runner.py',
          # Disaggregated serving: the KV-handoff push client and the
          # inference server's prefill->decode relay are data-plane
          # HTTP — a handoff with no deadline wedges the REQUEST (and
          # its decode slot reservation) forever, exactly the failure
          # this rule exists for.
          'inference/',
          # The fleet simulator drives the real control plane in a
          # tight tick loop — an unpaced retry or a deadline-less call
          # there turns a 240 s simulated day into a hung process.
          'fleetsim/')
_REQUESTS_VERBS = ('get', 'post', 'put', 'delete', 'head', 'patch',
                   'request')
_SUBPROCESS_BLOCKING = ('run', 'check_output', 'check_call', 'call')
_SLEEPY = ('sleep', 'wait', 'backoff')


class UnboundedIoRule(Rule):
    name = 'unbounded-io'
    suppress_token = 'unbounded-io'
    description = ('requests/subprocess without timeout, and '
                   'while-True retry loops with no backoff/deadline, '
                   'in provisioning/controller paths')

    def check(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        for module in project.modules:
            if not Project.in_scope(module, _SCOPE):
                continue
            for node in ast.walk(module.tree):
                if isinstance(node, ast.Call):
                    msg = self._unbounded_call(node, module)
                    if msg is not None:
                        findings.append(project.finding(
                            self, module, node, msg))
                elif isinstance(node, ast.While) and \
                        self._is_while_true(node):
                    msg = self._unbounded_retry(node, module)
                    if msg is not None:
                        findings.append(project.finding(
                            self, module, node, msg))
        return findings

    # ----- calls -------------------------------------------------------------
    def _unbounded_call(self, call: ast.Call,
                        module) -> Optional[str]:
        if any(kw.arg == 'timeout' for kw in call.keywords):
            return None
        dotted = cg._dotted(call.func)
        if dotted is None:
            return None
        resolved = cg.resolve_alias(dotted, module)
        head, _, tail = resolved.partition('.')
        if head == 'requests' and tail in _REQUESTS_VERBS:
            return (f'requests.{tail}(...) without timeout= — a hung '
                    f'connection wedges this control-plane path '
                    f'forever')
        if head == 'subprocess' and tail in _SUBPROCESS_BLOCKING:
            return (f'subprocess.{tail}(...) without timeout= — a '
                    f'hung child blocks the controller tick forever')
        # session.get/post/... on anything *session*-named.
        if isinstance(call.func, ast.Attribute) and \
                call.func.attr in _REQUESTS_VERBS:
            base = cg._dotted(call.func.value) or ''
            if 'session' in base.split('.')[-1].lower():
                return (f'{base}.{call.func.attr}(...) without '
                        f'timeout= — HTTP session call can hang '
                        f'forever')
        return None

    # ----- retry loops -------------------------------------------------------
    @staticmethod
    def _is_while_true(node: ast.While) -> bool:
        test = node.test
        return isinstance(test, ast.Constant) and test.value is True

    def _unbounded_retry(self, loop: ast.While,
                         module) -> Optional[str]:
        has_net = False
        has_pacing = False
        for node in iter_non_def_descendants(loop):
            if isinstance(node, ast.Call):
                dotted = cg._dotted(node.func) or ''
                resolved = cg.resolve_alias(dotted, module)
                head = resolved.partition('.')[0]
                last = resolved.split('.')[-1]
                if head in ('requests', 'subprocess') or \
                        last in ('request', '_request') or \
                        'session' in (dotted.split('.')[-2:-1] or
                                      [''])[0].lower():
                    has_net = True
                if any(s in last.lower() for s in _SLEEPY):
                    has_pacing = True
                if resolved in ('time.time', 'time.monotonic',
                                'time.perf_counter'):
                    has_pacing = True
        if has_net and not has_pacing:
            return ('while True retry loop with a network call but no '
                    'backoff/sleep and no deadline '
                    '(time.time/monotonic) — unbounded hot retry')
        return None
