"""Static-analysis framework for hot-path invariants.

The performance properties this codebase's benchmarks rest on — exactly
ONE device->host sync per decode step, zero mid-traffic recompiles, a
never-blocked dispatch loop, one DB access layer — are *invariants*, not
features: a single stray `np.asarray` on an untested branch silently
costs the pipelining behind the published TPOT.  Runtime tests only
guard the paths they exercise; this package makes the invariants hold
everywhere by construction:

- every ``.py`` file is parsed (never imported — analysis is pure AST,
  so deliberately-broken fixture files and heavy jax modules cost
  nothing);
- rules get per-file visitors plus an intra-package CALL GRAPH
  (callgraph.py) so "reachable from the decode loop" is a real
  reachability query, not a filename heuristic;
- intentional exceptions are annotated AT THE CALL SITE with
  ``# skytpu: allow-<token>(<reason>)`` — the reason is mandatory, so
  the exceptions are self-documenting and greppable;
- reporters (reporters.py) render text for humans and stable JSON for
  CI artifacts; the tier-1 gate (tests/test_torch_static_analysis.py)
  asserts ZERO unsuppressed findings over skypilot_tpu_torch/.

The framework is the JAX package's (skypilot_tpu/analysis/core.py),
with the package it anchors at renamed; the rules that differ are the
ones that know PyTorch (rules/hot_loop_sync.py, recompile_hazard.py,
speculation.py) and the call graph (callgraph.py).

Entry: ``run_check(paths)`` or ``python -m skypilot_tpu_torch.analysis
[path]`` (__main__.py).
"""
from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Node types whose bodies do NOT execute as part of the enclosing
# frame (a def inside a loop/async handler defines code, it does not
# run it there) — rules walking "what executes here" stop at these.
DEF_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def iter_non_def_descendants(node: ast.AST):
    """Yield every descendant of `node` without descending into nested
    function definitions.  `node` itself is not yielded."""
    stack = [c for c in ast.iter_child_nodes(node)
             if not isinstance(c, DEF_NODES)]
    while stack:
        n = stack.pop()
        yield n
        stack.extend(c for c in ast.iter_child_nodes(n)
                     if not isinstance(c, DEF_NODES))


# ``# skytpu: allow-sync(reason)`` — also carries framework markers like
# ``# skytpu: hot-entry`` (see callgraph.py).
_SUPPRESS_RE = re.compile(
    r'#\s*skytpu:\s*allow-([a-z0-9-]+)\s*\(([^)]*)\)')
_MARKER_RE = re.compile(r'#\s*skytpu:\s*([a-z0-9-]+)\b(?!\s*\()')


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""
    rule: str
    path: str              # path as given/relative — stable across runs
    line: int
    col: int
    message: str
    suppressed: bool = False
    reason: Optional[str] = None   # the allow-annotation's reason

    def format(self) -> str:
        tag = ' (suppressed)' if self.suppressed else ''
        return (f'{self.path}:{self.line}:{self.col}: '
                f'[{self.rule}] {self.message}{tag}')


class Module:
    """One parsed source file: AST + import aliases + annotations."""

    def __init__(self, path: str, rel: str, modname: str,
                 source: str) -> None:
        self.path = path
        self.rel = rel                      # displayed / reported path
        self.modname = modname              # dotted name for callgraph
        self.source = source
        self.tree = ast.parse(source, filename=path)
        # line -> [(token, reason)] from ``# skytpu: allow-...`` comments.
        self.suppressions: Dict[int, List[Tuple[str, str]]] = {}
        # line -> [marker] from bare ``# skytpu: <marker>`` comments.
        self.markers: Dict[int, List[str]] = {}
        self._scan_comments(source)
        # alias -> dotted target ('np' -> 'numpy', 'metrics_lib' ->
        # 'skypilot_tpu_torch.server.metrics', 'foo' -> 'pkg.mod.foo').
        self.import_aliases: Dict[str, str] = {}
        self._scan_imports()

    def _scan_comments(self, source: str) -> None:
        try:
            tokens = tokenize.generate_tokens(
                io.StringIO(source).readline)
            comments = [(t.start[0], t.string) for t in tokens
                        if t.type == tokenize.COMMENT]
        except tokenize.TokenError:
            comments = []
        for line, text in comments:
            for m in _SUPPRESS_RE.finditer(text):
                self.suppressions.setdefault(line, []).append(
                    (m.group(1), m.group(2).strip()))
            for m in _MARKER_RE.finditer(text):
                if m.group(1).startswith('allow-'):
                    continue
                self.markers.setdefault(line, []).append(m.group(1))

    def _scan_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.import_aliases[a.asname or
                                        a.name.split('.')[0]] = (
                        a.name if a.asname else a.name.split('.')[0])
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ''
                if node.level:
                    # Relative import: resolve against this module's
                    # package (one level strips the module name itself).
                    parts = self.modname.split('.')
                    parts = parts[:len(parts) - node.level]
                    base = '.'.join(parts + ([node.module]
                                             if node.module else []))
                for a in node.names:
                    if a.name == '*':
                        continue
                    self.import_aliases[a.asname or a.name] = (
                        f'{base}.{a.name}' if base else a.name)

    def suppression_for(self, node: ast.AST,
                        token: str) -> Optional[Tuple[str, str]]:
        """An ``allow-<token>`` annotation covering `node`: on any line
        the node spans, or on the line directly above it."""
        start = getattr(node, 'lineno', 0)
        end = getattr(node, 'end_lineno', start) or start
        for line in range(max(1, start - 1), end + 1):
            for tok, reason in self.suppressions.get(line, []):
                if tok == token:
                    return tok, reason
        return None

    def marker_near(self, node: ast.AST, marker: str) -> bool:
        """A bare ``# skytpu: <marker>`` on the def line (or the line
        above, for decorated defs)."""
        start = getattr(node, 'lineno', 0)
        for line in (start - 1, start):
            if marker in self.markers.get(line, []):
                return True
        return False


class Project:
    """The analyzed file set plus shared infrastructure for rules."""

    def __init__(self, modules: List[Module]) -> None:
        self.modules = modules
        self._callgraph = None

    @property
    def callgraph(self):
        if self._callgraph is None:
            from skypilot_tpu_torch.analysis import callgraph
            self._callgraph = callgraph.CallGraph(self.modules)
        return self._callgraph

    def module_by_suffix(self, suffix: str) -> Optional[Module]:
        for m in self.modules:
            if m.path.endswith(suffix) or m.rel.endswith(suffix):
                return m
        return None

    @staticmethod
    def in_scope(module: Module, fragments: Sequence[str]) -> bool:
        """Path-fragment scoping that works for both the real package
        (root = skypilot_tpu_torch/) and mirrored fixture trees: a
        fragment 'server/' matches any path containing a /server/ component; a
        fragment ending '.py' matches by suffix."""
        path = '/' + module.path.replace(os.sep, '/').lstrip('/')
        for frag in fragments:
            if frag.endswith('.py'):
                if path.endswith('/' + frag.lstrip('/')):
                    return True
            elif f'/{frag.strip("/")}/' in path:
                return True
        return False

    def finding(self, rule, module: Module, node: ast.AST,
                message: str) -> Finding:
        """Build a Finding, applying any allow-annotation at the site.
        An annotation with an EMPTY reason does not suppress — the
        reason is the point (greppable, reviewable exceptions)."""
        sup = module.suppression_for(node, rule.suppress_token)
        if sup is not None and not sup[1]:
            message += (f' [allow-{rule.suppress_token} found but a '
                        f'reason is required: '
                        f'# skytpu: allow-{rule.suppress_token}(<why>)]')
            sup = None
        return Finding(
            rule=rule.name, path=module.rel,
            line=getattr(node, 'lineno', 0),
            col=getattr(node, 'col_offset', 0),
            message=message,
            suppressed=sup is not None,
            reason=sup[1] if sup else None)


class Rule:
    """Base class: subclasses set name/suppress_token/description and
    implement check(project) -> [Finding]."""
    name = ''
    suppress_token = ''
    description = ''

    def check(self, project: Project) -> List[Finding]:
        raise NotImplementedError


@dataclasses.dataclass
class Report:
    findings: List[Finding]
    files_scanned: int
    rules: List[str]
    entry_points: List[str]        # hot entry points the sync rule used
    parse_errors: List[str]

    @property
    def unsuppressed(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> List[Finding]:
        return [f for f in self.findings if f.suppressed]


def _package_root() -> str:
    import skypilot_tpu_torch
    return os.path.dirname(os.path.abspath(skypilot_tpu_torch.__file__))


def collect_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames
                           if d != '__pycache__' and
                           not d.startswith('.')]
            for fn in sorted(filenames):
                if fn.endswith('.py'):
                    out.append(os.path.join(dirpath, fn))
    return sorted(set(out))


def _modname_for(path: str, root: str) -> str:
    """Dotted module name: anchored at the skypilot_tpu_torch package when
    the file lives inside it (so callgraph qualnames match the real import
    paths), else derived from the path relative to the analysis root."""
    norm = path.replace(os.sep, '/')
    marker = '/skypilot_tpu_torch/'
    if marker in norm:
        rel = 'skypilot_tpu_torch/' + norm.split(marker, 1)[1]
    else:
        rel = os.path.relpath(path, root).replace(os.sep, '/')
    rel = rel[:-3] if rel.endswith('.py') else rel
    if rel.endswith('/__init__'):
        rel = rel[:-len('/__init__')]
    return rel.replace('/', '.').lstrip('.')


def load_project(paths: Optional[Sequence[str]] = None
                 ) -> Tuple[Project, List[str], str]:
    """Parse the file set into a Project.  Returns (project,
    parse_errors, root)."""
    root = None
    if not paths:
        root = _package_root()
        paths = [root]
    else:
        first = os.path.abspath(paths[0])
        root = first if os.path.isdir(first) else os.path.dirname(first)
    files = collect_files(paths)
    modules: List[Module] = []
    errors: List[str] = []
    for path in files:
        rel = os.path.relpath(path, root)
        if rel.startswith('..'):
            rel = path
        try:
            with open(path, 'r', encoding='utf-8') as f:
                source = f.read()
            modules.append(
                Module(path, rel.replace(os.sep, '/'),
                       _modname_for(path, root), source))
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            errors.append(f'{rel}: {type(e).__name__}: {e}')
    return Project(modules), errors, root


def run_check(paths: Optional[Sequence[str]] = None,
              rules: Optional[Iterable[str]] = None) -> Report:
    """Run the (optionally filtered) rule set over `paths` (default:
    the installed skypilot_tpu_torch package)."""
    from skypilot_tpu_torch.analysis.rules import all_rules
    active = all_rules()
    if rules:
        wanted = set(rules)
        unknown = wanted - {r.name for r in active}
        if unknown:
            raise ValueError(
                f'unknown rule(s): {sorted(unknown)}; known: '
                f'{sorted(r.name for r in active)}')
        active = [r for r in active if r.name in wanted]
    project, errors, _ = load_project(paths)
    findings: List[Finding] = []
    entry_points: List[str] = []
    for rule in active:
        findings.extend(rule.check(project))
        entry_points.extend(getattr(rule, 'entry_points_used', []))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return Report(findings=findings, files_scanned=len(project.modules),
                  rules=[r.name for r in active],
                  entry_points=sorted(set(entry_points)),
                  parse_errors=errors)
