"""Intra-package call graph: which functions are reachable from which.

Rules like hot-loop-sync need "is this `.cpu()` reachable from the
decode loop?", not "is it in engine.py?" — a sync two helper calls away
from the loop costs the same pipelining as one inside it.  The graph is
a deliberately conservative approximation built from names alone (no
type inference, nothing imported):

- module-level functions and class methods are indexed by qualified
  name (``pkg.mod.Class.method``); nested defs get the CPython-style
  ``outer.<locals>.inner`` qualname;
- ``f(...)`` resolves to a same-module def or an imported intra-package
  function; ``mod.f(...)`` through import aliases; ``self.m(...)`` to
  the method Python finds on the enclosing class or its same-module
  bases, plus its overrides on same-module subclasses (falling back to
  same-named methods on sibling classes in the module);
  ``super().m(...)`` to the bases' ``m``; ``obj.m(...)`` to same-module
  methods named ``m`` (same-file over-approximation, never cross-module
  guessing);
- calling a class adds an edge to its ``__init__`` (inherited ones
  too).

In PyTorch a function body runs on every call: nothing is a trace-time
constant the way a jitted JAX body is, so no function is skipped for
being compiled.  The one exception is code that runs only while a CUDA
graph is captured: a method named ``_capture``, and the body of a
``with torch.cuda.graph(...)`` block.  Such code runs once per graph,
never per step, and a host sync inside a capture raises rather than
stalls — so it is marked ``captured`` (the method) or listed in
``captured_calls`` (the block's calls), and the sync rule skips it.
Its callees stay in the graph and are judged on their own: the decode
call's ``_body`` is captured, but ``_GraphCall.__call__`` runs the same
body every step when the call has no graph (the CPU, or the eager
comparison), so the body stays visible to the sync rule.  Creating and
capturing a graph is held by recompile-hazard instead.

Hot entry points are declared by a ``# skytpu: hot-entry`` marker on
the def line (self-documenting at the definition), with the known
engine/trainer/RL loops as hardcoded backstops in the sync rule.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set

from skypilot_tpu_torch.analysis.core import Module

# The methods whose body runs only while a CUDA graph is captured.
CAPTURE_METHODS = ('_capture',)
# torch.cuda names that create or capture a CUDA graph.
_GRAPH_NAMES = ('torch.cuda.CUDAGraph', 'torch.cuda.graph',
                'torch.cuda.make_graphed_callables')
# The port's kernel build (ops/cuda/flash_attention.py): its public
# entry, and the library methods that compile and load.
BUILD_MODULE = 'skypilot_tpu_torch.ops.cuda.flash_attention'
_BUILD_METHODS = ('_build_and_load', '_compile_and_link')


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return '.'.join(reversed(parts))
    return None


def _is_super_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and \
        isinstance(node.func, ast.Name) and node.func.id == 'super'


def resolve_alias(dotted: str, module: Module) -> str:
    """Expand the leading segment through the module's import aliases:
    'np.asarray' -> 'numpy.asarray', 'metrics_lib.inc_counter' ->
    'skypilot_tpu_torch.server.metrics.inc_counter'."""
    head, _, rest = dotted.partition('.')
    base = module.import_aliases.get(head)
    if base is None:
        return dotted
    return f'{base}.{rest}' if rest else base


def graph_kind(node: ast.Call, module: Module) -> Optional[str]:
    """What a call costs once, not per step, or None:

    - 'capture': ``torch.cuda.CUDAGraph()``, ``torch.cuda.graph(...)``,
      ``torch.cuda.make_graphed_callables(...)``;
    - 'compile': ``torch.compile(...)``;
    - 'build': a kernel build, ``torch.utils.cpp_extension.load*`` or
      the port's own (``ops.cuda.flash_attention.build`` and the
      library methods that compile and load).

    Resolved through import aliases."""
    target = _dotted(node.func)
    if target is None:
        return None
    resolved = resolve_alias(target, module)
    if resolved in _GRAPH_NAMES:
        return 'capture'
    if resolved == 'torch.compile':
        return 'compile'
    head, _, last = resolved.rpartition('.')
    if head == 'torch.utils.cpp_extension' and last.startswith('load'):
        return 'build'
    if resolved == f'{BUILD_MODULE}.build' or (
            module.modname == BUILD_MODULE and
            (resolved == 'build' or last in _BUILD_METHODS)):
        return 'build'
    return None


def is_capture_block(node: ast.AST, module: Module) -> bool:
    """A ``with torch.cuda.graph(...):`` statement."""
    return isinstance(node, ast.With) and any(
        isinstance(item.context_expr, ast.Call) and
        graph_kind(item.context_expr, module) == 'capture'
        for item in node.items)


class FunctionInfo:
    __slots__ = ('qualname', 'module', 'node', 'class_name', 'captured',
                 'calls', 'captured_calls')

    def __init__(self, qualname: str, module: Module, node,
                 class_name: Optional[str]) -> None:
        self.qualname = qualname
        self.module = module
        self.node = node
        self.class_name = class_name
        self.captured = (class_name is not None and
                         node.name in CAPTURE_METHODS)
        self.calls: List[ast.Call] = []
        # ids of the calls inside a `with torch.cuda.graph(...)` block.
        self.captured_calls: Set[int] = set()


class _Indexer(ast.NodeVisitor):
    def __init__(self, module: Module, graph: 'CallGraph') -> None:
        self.module = module
        self.graph = graph
        self.class_stack: List[str] = []
        self.fn_stack: List[FunctionInfo] = []
        # Depth of `with torch.cuda.graph(...)` blocks per open function.
        self.capture_depth: List[int] = []

    def _qual_prefix(self) -> str:
        if self.fn_stack:
            return f'{self.fn_stack[-1].qualname}.<locals>'
        if self.class_stack:
            return (f'{self.module.modname}.'
                    f'{".".join(self.class_stack)}')
        return self.module.modname

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        if not self.fn_stack and not self.class_stack:
            self.graph.add_class(self.module, node)
        self.class_stack.append(node.name)
        self.generic_visit(node)
        self.class_stack.pop()

    def _visit_fn(self, node) -> None:
        qual = f'{self._qual_prefix()}.{node.name}'
        info = FunctionInfo(
            qual, self.module, node,
            self.class_stack[-1] if (self.class_stack and
                                     not self.fn_stack) else None)
        self.graph.add_function(info)
        self.fn_stack.append(info)
        self.capture_depth.append(0)
        self.generic_visit(node)
        self.capture_depth.pop()
        self.fn_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_With(self, node: ast.With) -> None:
        if not (self.fn_stack and is_capture_block(node, self.module)):
            self.generic_visit(node)
            return
        # The context expression runs outside the capture; the body in.
        for item in node.items:
            self.visit(item)
        self.capture_depth[-1] += 1
        for stmt in node.body:
            self.visit(stmt)
        self.capture_depth[-1] -= 1

    def visit_Call(self, node: ast.Call) -> None:
        if self.fn_stack:
            self.fn_stack[-1].calls.append(node)
            if self.capture_depth[-1]:
                self.fn_stack[-1].captured_calls.add(id(node))
        self.generic_visit(node)


class CallGraph:
    def __init__(self, modules: List[Module]) -> None:
        self.functions: Dict[str, FunctionInfo] = {}
        # module -> {bare fn name -> [qualnames]} for local resolution.
        self._by_module: Dict[str, Dict[str, List[str]]] = {}
        # module -> {top-level class -> base class names}.
        self._bases: Dict[str, Dict[str, List[str]]] = {}
        for m in modules:
            _Indexer(m, self).visit(m.tree)
        self._edges: Dict[str, Set[str]] = {}
        for info in self.functions.values():
            self._edges[info.qualname] = self._resolve_calls(info)

    # ----- construction ------------------------------------------------------
    def add_function(self, info: FunctionInfo) -> None:
        self.functions[info.qualname] = info
        names = self._by_module.setdefault(info.module.modname, {})
        names.setdefault(info.node.name, []).append(info.qualname)

    def add_class(self, module: Module, node: ast.ClassDef) -> None:
        bases = [(_dotted(b) or '').split('.')[-1] for b in node.bases]
        self._bases.setdefault(module.modname, {})[node.name] = bases

    def _method(self, modname: str, cls: str, name: str,
                seen: Optional[Set[str]] = None) -> Optional[str]:
        """`cls.name` as Python finds it: on `cls`, else on its
        same-module bases, depth first."""
        qual = f'{modname}.{cls}.{name}'
        if qual in self.functions:
            return qual
        seen = seen if seen is not None else {cls}
        for base in self._bases.get(modname, {}).get(cls, []):
            if base not in seen:
                seen.add(base)
                found = self._method(modname, base, name, seen)
                if found:
                    return found
        return None

    def _overrides(self, modname: str, cls: str, name: str) -> Set[str]:
        """`name` on every same-module subclass of `cls`: what
        `self.name(...)` in `cls` dispatches to on a subclass."""
        classes = self._bases.get(modname, {})
        subs, grew = {cls}, True
        while grew:
            grew = False
            for c, bases in classes.items():
                if c not in subs and subs.intersection(bases):
                    subs.add(c)
                    grew = True
        return {f'{modname}.{c}.{name}' for c in subs - {cls}
                if f'{modname}.{c}.{name}' in self.functions}

    def _resolve_calls(self, info: FunctionInfo) -> Set[str]:
        module = info.module
        targets: Set[str] = set()
        local = self._by_module.get(module.modname, {})
        for call in info.calls:
            func = call.func
            if isinstance(func, ast.Name):
                name = func.id
                # Same-module def (module-level or any class's method
                # brought into scope is NOT a thing for bare names —
                # prefer module-level defs).
                for qual in local.get(name, []):
                    fn = self.functions[qual]
                    if fn.class_name is None:
                        targets.add(qual)
                        targets.update(self._init_of(qual))
                if name in self._bases.get(module.modname, {}):
                    init = self._method(module.modname, name, '__init__')
                    if init:
                        targets.add(init)
                resolved = resolve_alias(name, module)
                if resolved != name and resolved in self.functions:
                    targets.add(resolved)
                    targets.update(self._init_of(resolved))
                elif resolved != name:
                    targets.update(self._init_of(resolved))
            elif isinstance(func, ast.Attribute):
                attr = func.attr
                base = _dotted(func.value)
                resolved_base = (resolve_alias(base, module)
                                 if base else None)
                if base in ('self', 'cls') and info.class_name:
                    qual = self._method(module.modname, info.class_name,
                                        attr)
                    if qual:
                        targets.add(qual)
                        targets.update(self._overrides(
                            module.modname, info.class_name, attr))
                        continue
                if _is_super_call(func.value) and info.class_name:
                    for b in self._bases.get(module.modname, {}).get(
                            info.class_name, []):
                        qual = self._method(module.modname, b, attr)
                        if qual:
                            targets.add(qual)
                    continue
                if resolved_base is not None:
                    # Module-alias call: pkg.mod.attr / alias.attr.
                    cand = f'{resolved_base}.{attr}'
                    if cand in self.functions:
                        targets.add(cand)
                        continue
                    init = self._init_of(cand)
                    if init:
                        targets.update(init)
                        continue
                # Fallback: any same-module method with this name
                # (same-file over-approximation only).
                for qual in local.get(attr, []):
                    if self.functions[qual].class_name is not None:
                        targets.add(qual)
        return targets

    def _init_of(self, qualname: str) -> Set[str]:
        """qualname names a class -> its __init__ (constructor call)."""
        init = f'{qualname}.__init__'
        return {init} if init in self.functions else set()

    # ----- queries -----------------------------------------------------------
    def reachable_from(self, entries: Iterable[str]) -> Set[str]:
        """Transitive closure over resolved call edges."""
        seen: Set[str] = set()
        stack = [e for e in entries if e in self.functions]
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(self._edges.get(cur, ()))
        return seen

    def entry_points(self, marker: str = 'hot-entry',
                     defaults: Iterable[str] = ()) -> List[str]:
        """Functions carrying the ``# skytpu: hot-entry`` def-line
        marker, plus any of `defaults` (qualname suffixes) present."""
        out: Set[str] = set()
        for qual, info in self.functions.items():
            if info.module.marker_near(info.node, marker):
                out.add(qual)
            else:
                for d in defaults:
                    if qual == d or qual.endswith('.' + d):
                        out.add(qual)
        return sorted(out)
