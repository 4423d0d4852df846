"""Shared linting infrastructure: modules, violations, waivers, and the
identity-key dataflow analysis used by the memo-scoping and determinism
rules.

Waivers: a flagged line is suppressed by a ``# lint: <rule-id>`` comment
on the same line or the line directly above; everything after the rule
id(s) is free-text justification.  Waivers are tracked — ``--strict``
mode fails on waivers that no longer suppress anything, so stale
justifications cannot rot in place.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

WAIVER_RE = re.compile(r"#\s*lint:\s*([a-z0-9-]+(?:\s*,\s*[a-z0-9-]+)*)")


@dataclass(frozen=True)
class Violation:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class LintModule:
    """One parsed source file plus its waiver table."""

    def __init__(self, path: str, source: str, relpath: str | None = None):
        self.path = path
        self.relpath = relpath if relpath is not None else path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.waivers: dict[int, set[str]] = {}
        for i, text in enumerate(source.splitlines(), start=1):
            m = WAIVER_RE.search(text)
            if m:
                self.waivers[i] = {w.strip() for w in m.group(1).split(",")}
        self.used_waivers: set[tuple[int, str]] = set()
        self._id_analysis: IdKeyAnalysis | None = None

    def waived(self, line: int, rule: str) -> bool:
        """A waiver covers its own line, or — when written as a comment
        block above the flagged statement — any line of that contiguous
        comment block."""
        ids = self.waivers.get(line)
        if ids and rule in ids:
            self.used_waivers.add((line, rule))
            return True
        lines = self.source.splitlines()
        ln = line - 1
        while 1 <= ln <= len(lines) and \
                lines[ln - 1].lstrip().startswith("#"):
            ids = self.waivers.get(ln)
            if ids and rule in ids:
                self.used_waivers.add((ln, rule))
                return True
            ln -= 1
        return False

    def unused_waivers(self) -> list[tuple[int, str]]:
        out = []
        for ln, ids in sorted(self.waivers.items()):
            for rid in sorted(ids):
                if (ln, rid) not in self.used_waivers:
                    out.append((ln, rid))
        return out

    def id_analysis(self) -> "IdKeyAnalysis":
        if self._id_analysis is None:
            self._id_analysis = IdKeyAnalysis(self.tree)
        return self._id_analysis


class Rule:
    """One invariant class.  ``check`` returns raw violations; the lint
    CLI (``run_lint``) applies waivers."""

    rule_id = "base"
    description = ""

    def check(self, module: LintModule) -> list[Violation]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# identity-key dataflow analysis
# ---------------------------------------------------------------------------
#
# Key classification:
#   "direct" — the bare result of ``id(obj)`` (or a name assigned from
#              one).  Safe only while ``obj`` is alive: a recycled
#              address aliases a different object into the entry.
#   "sig"    — a tuple embedding ``id()`` results (walk/gang signatures,
#              memo keys, wake tokens), directly or via a function whose
#              return value is one.
#
# Escape hatches (what makes a store acceptable):
#   * self-pinned  — the stored VALUE keeps the id() argument alive in
#                    the same entry (``shrunk[id(v)] = (v, ...)``,
#                    ``self.members[jid] = js``);
#   * class pin    — the owning class maintains a sibling pin mapping of
#                    the same key kind (``members`` for direct keys,
#                    ``parked_pins``/``_gang_pins`` for signatures);
#   * weakref scope — a method of the owning class binds the container's
#                    lifetime to an owner object via ``weakref.ref`` and
#                    clears/re-assigns it on owner change
#                    (``_scope_memos``-style);
#   * comprehension — a container built in one displaced expression and
#                    never mutated afterwards is a point-in-time snapshot
#                    of live objects, not a cross-statement memo.


@dataclass(frozen=True)
class Container:
    """Where an id-derived key was stored."""
    kind: str            # "attr" | "local" | "expr"
    owner: str | None    # class name ("attr"/"expr") or function qualname
    name: str | None     # attribute / local variable name (None for expr)


@dataclass(frozen=True)
class IdStore:
    container: Container
    line: int
    key_kind: str        # "direct" | "sig"
    self_pinned: bool    # value expression keeps the id() argument alive
    comprehension: bool
    func: str            # enclosing function qualname ("" at module level)
    cls: str | None      # enclosing class name


_MUTATORS = {"add", "setdefault"}


def _local_walk(fn: ast.AST):
    """``ast.walk`` stopping at nested function boundaries: nested defs
    are analyzed in their own pass, so descending into them here would
    double-count every store."""
    stack = [fn]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue        # nested def: analyzed in its own pass
            stack.append(child)


class IdKeyAnalysis:
    """Flow-insensitive, module-local tracking of id-derived values.

    Runs classification to a fixpoint so functions *returning* id-derived
    values (``_walk_sig``, ``sig_for``) propagate taint through their
    call sites within the module.
    """

    def __init__(self, tree: ast.Module):
        self.tree = tree
        self.sig_funcs: set[str] = set()
        self.stores: list[IdStore] = []
        self.weakref_scoped: set[tuple[str | None, str]] = set()
        self.class_direct_pins: set[str] = set()
        self.class_sig_pins: set[str] = set()
        # containers known to be keyed by direct id() ints, by name
        # (attr name or (func, local name)) — feeds the determinism
        # rule's iteration-order check
        self.direct_attr_containers: set[str] = set()
        self.direct_local_containers: set[tuple[str, str]] = set()
        self._attr_owner: dict[str, str] = {}
        self._funcs: list[tuple[str, str | None, ast.AST]] = []
        self._collect_structure()
        prev = -1
        while len(self.sig_funcs) != prev:
            prev = len(self.sig_funcs)
            self.stores = []
            for qual, cls, fn in self._funcs:
                self._analyze_function(qual, cls, fn)
        self._collect_weakref_scopes()
        for st in self.stores:
            if st.key_kind == "direct" and not st.comprehension:
                c = st.container
                if c.kind in ("attr", "expr") and c.name:
                    self.direct_attr_containers.add(c.name)
                elif c.kind == "local" and c.name:
                    self.direct_local_containers.add((st.func, c.name))
            if (st.key_kind == "direct" and st.self_pinned and st.cls
                    and st.container.kind != "local"):
                self.class_direct_pins.add(st.cls)
            if (st.key_kind == "sig" and st.self_pinned and st.cls
                    and st.container.kind in ("attr", "expr")
                    and not st.comprehension):
                self.class_sig_pins.add(st.cls)

    # -- structure ------------------------------------------------------
    def _collect_structure(self) -> None:
        def walk(node, cls: str | None, prefix: str):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    walk(child, child.name, f"{prefix}{child.name}.")
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    qual = f"{prefix}{child.name}"
                    self._funcs.append((qual, cls, child))
                    if cls is not None:
                        for sub in ast.walk(child):
                            if isinstance(sub, ast.Attribute) and \
                                    isinstance(sub.value, ast.Name) and \
                                    sub.value.id == "self":
                                self._attr_owner.setdefault(sub.attr, cls)
                                # the ``*_pins`` convention: a sibling
                                # mapping named for pinning marks the
                                # class as keeping signature referents
                                # alive (keys flow in as parameters, out
                                # of reach of module-local taint)
                                if sub.attr.endswith("_pins"):
                                    self.class_sig_pins.add(cls)
                    walk(child, cls, f"{qual}.")
        walk(self.tree, None, "")

    def attr_owner(self, attr: str) -> str | None:
        return self._attr_owner.get(attr)

    # -- expression classification --------------------------------------
    def _classify(self, node: ast.AST, env: dict) -> tuple[str, str | None]:
        """Return (kind, id_arg_name): kind in {"", "direct", "sig"}."""
        if isinstance(node, ast.Name):
            return env.get(node.id, ("", None))
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id == "id" and node.args:
                arg = node.args[0]
                return ("direct",
                        arg.id if isinstance(arg, ast.Name) else None)
            name = None
            if isinstance(fn, ast.Name):
                name = fn.id
            elif isinstance(fn, ast.Attribute):
                name = fn.attr
            if name in self.sig_funcs:
                return ("sig", None)
            return ("", None)
        if isinstance(node, ast.Tuple):
            for el in node.elts:
                if self._classify(el, env)[0]:
                    return ("sig", None)
            return ("", None)
        return ("", None)

    def _value_pins(self, value: ast.AST | None, arg: str | None) -> bool:
        if value is None or arg is None:
            return False
        return any(isinstance(n, ast.Name) and n.id == arg
                   for n in ast.walk(value))

    def _value_nonconstant(self, value: ast.AST | None) -> bool:
        if value is None:
            return False
        return any(isinstance(n, (ast.Name, ast.Attribute))
                   for n in ast.walk(value))

    def _container_of(self, expr: ast.AST, qual: str,
                      cls: str | None) -> Container:
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) and expr.value.id == "self":
                return Container("attr", cls, expr.attr)
            owner = self._attr_owner.get(expr.attr)
            return Container("attr", owner, expr.attr)
        if isinstance(expr, ast.Name):
            return Container("local", qual, expr.id)
        return Container("expr", cls, None)

    # -- per-function pass ----------------------------------------------
    def _analyze_function(self, qual: str, cls: str | None,
                          fn: ast.AST) -> None:
        env: dict[str, tuple[str, str | None]] = {}
        returns_tainted = False

        def record(container_expr, key, value, line, comprehension=False):
            kind, arg = self._classify(key, env)
            if not kind:
                return
            cont = self._container_of(container_expr, qual, cls)
            pinned = (self._value_pins(value, arg) if kind == "direct"
                      else self._value_nonconstant(value))
            self.stores.append(IdStore(
                container=cont, line=line, key_kind=kind,
                self_pinned=pinned, comprehension=comprehension,
                func=qual, cls=cls))

        body_nodes = list(_local_walk(fn))
        # taint environment first (flow-insensitive union)
        for node in body_nodes:
            if isinstance(node, ast.Assign):
                kind, arg = self._classify(node.value, env)
                if kind:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            env[tgt.id] = (kind, arg)
            elif isinstance(node, ast.Return) and node.value is not None:
                if self._classify(node.value, env)[0]:
                    returns_tainted = True
        for node in body_nodes:
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Subscript):
                        record(tgt.value, tgt.slice, node.value, node.lineno)
            elif isinstance(node, ast.AugAssign) and \
                    isinstance(node.target, ast.Subscript):
                record(node.target.value, node.target.slice, node.value,
                       node.lineno)
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _MUTATORS and node.args:
                value = node.args[1] if len(node.args) > 1 else None
                record(node.func.value, node.args[0], value, node.lineno)
            elif isinstance(node, ast.DictComp):
                record(ast.Name(id="<comp>", ctx=ast.Load()), node.key,
                       node.value, node.lineno, comprehension=True)
            elif isinstance(node, ast.SetComp):
                record(ast.Name(id="<comp>", ctx=ast.Load()), node.elt,
                       None, node.lineno, comprehension=True)
        if returns_tainted:
            self.sig_funcs.add(qual.rsplit(".", 1)[-1])

    # -- weakref scoping -------------------------------------------------
    def _collect_weakref_scopes(self) -> None:
        for qual, cls, fn in self._funcs:
            has_weakref = any(
                isinstance(n, ast.Attribute) and n.attr == "ref"
                and isinstance(n.value, ast.Name)
                and n.value.id == "weakref"
                for n in ast.walk(fn))
            if not has_weakref:
                continue
            for n in ast.walk(fn):
                attr = None
                if isinstance(n, ast.Call) and \
                        isinstance(n.func, ast.Attribute) and \
                        n.func.attr == "clear" and \
                        isinstance(n.func.value, ast.Attribute) and \
                        isinstance(n.func.value.value, ast.Name) and \
                        n.func.value.value.id == "self":
                    attr = n.func.value.attr
                elif isinstance(n, ast.Assign):
                    for tgt in n.targets:
                        if isinstance(tgt, ast.Attribute) and \
                                isinstance(tgt.value, ast.Name) and \
                                tgt.value.id == "self":
                            attr = tgt.attr
                            self.weakref_scoped.add((cls, attr))
                if attr is not None:
                    self.weakref_scoped.add((cls, attr))


@dataclass
class FunctionIndex:
    """Flat per-module function lookup used by several rules."""
    by_qualname: dict[str, ast.AST] = field(default_factory=dict)
    cls_of: dict[str, str | None] = field(default_factory=dict)

    @classmethod
    def build(cls, tree: ast.Module) -> "FunctionIndex":
        idx = cls()

        def walk(node, owner: str | None, prefix: str):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    walk(child, child.name, f"{prefix}{child.name}.")
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    qual = f"{prefix}{child.name}"
                    idx.by_qualname[qual] = child
                    idx.cls_of[qual] = owner
                    walk(child, owner, f"{qual}.")
        walk(tree, None, "")
        return idx
