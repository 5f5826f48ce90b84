"""fedlint: project-wide dataflow for the port -- the symbol table of
traced and graphed callables, and the FL110 use-after-replay rule.

The reference's FL110 (``fedml_tpu/analysis/dataflow.py``) tracks a
buffer donated to a jit and read after the call deleted it. Torch has
no donation; its hazard of the same shape is the **graphed** callable:
one that replays a CUDA graph and returns the graph's static output
buffers, which the next call overwrites in place. Safety is again a
*caller* property, so this module builds the same two-pass view over
the linted fileset:

1. **Symbol table** (:class:`ProjectIndex`): every traced callable --
   a ``torch.compile``/``torch.jit.script``/``torch.jit.trace``
   decorator or wrap, ``torch.cuda.make_graphed_callables``, a
   ``torch.cuda.CUDAGraph`` -- marked *graphed* when its outputs are
   static buffers
   (``make_graphed_callables``; ``torch.compile`` with
   ``mode="reduce-overhead"`` or ``"max-autotune"``, whose cudagraph
   trees overwrite the previous run's outputs; a ``CUDAGraph``, whose
   static outputs are the names bound inside its ``with
   torch.cuda.graph(g):`` capture and which ``g.replay()`` refreshes).
   Three binding shapes are resolved so call sites elsewhere can be
   checked:

   - module/function locals: ``step = torch.compile(fn, mode=...)``
   - instance attributes:  ``self._step = make_graphed_callables(m, x)``
     bound in one method, called as ``self._step(...)`` in another
   - **builders**: a function whose return value is a traced local;
     ``self.step = make_step(...)`` in *another module* then carries
     the graphed contract across the import edge.

2. **Dataflow** (:func:`check_use_after_replay`): inside each function
   body, statements are walked in order; a name bound to a graphed
   call's output (or an alias of it: a view, a subscript, a plain
   rebinding, a container it was appended to) goes stale at the next
   call of the same callable, and any later read before a rebind is
   FL110. ``out = g(x)`` rebinds immediately (the safe idiom), so does
   ``out = g(x).clone()``'s fresh tensor; and a graphed output kept
   inside a loop in a container the loop never rebinds is flagged too
   -- the next iteration's call overwrites the kept buffer.

The reference's donation inference and its FL104 fix engine
(``infer_donate_argnums*``, ``plan_donation_fixes``, ``FixPlan``,
``render_fix_diff``) have no torch counterpart: torch has no buffer
donation to infer.
"""

from __future__ import annotations

import ast
import os

from fedml_tpu_torch.analysis.linter import (_GRAPH_CTOR,
                                             graph_context_target,
                                             is_graphed, tracer_call_info)

#: methods whose result shares the receiver's storage: a view of a
#: graphed output is overwritten with it
ALIAS_METHODS = frozenset((
    "detach", "view", "view_as", "reshape", "flatten", "unflatten",
    "squeeze", "unsqueeze", "transpose", "permute", "t", "narrow",
    "expand", "expand_as", "contiguous", "select"))
#: methods that keep their argument in the receiver (a container)
STORE_METHODS = frozenset(("append", "extend", "insert", "appendleft",
                           "add"))


# -- symbol table ---------------------------------------------------------

class TracedSymbol:
    """One traced callable: its name, what traced it, and whether its
    outputs are static buffers a later call overwrites."""

    __slots__ = ("name", "kind", "graphed")

    def __init__(self, name, kind, graphed):
        self.name = name
        self.kind = kind
        self.graphed = graphed

    def renamed(self, name):
        return TracedSymbol(name, self.kind, self.graphed)

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"TracedSymbol({self.name}, kind={self.kind}, "
                f"graphed={self.graphed})")


def _expr_name(node):
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _expr_name(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return "<callable>"


class _ModuleSymbols:
    """Per-module symbol collection (pass 1)."""

    def __init__(self, tree, aliases):
        self.aliases = aliases
        #: scope-flat name -> TracedSymbol (module + function locals; call
        #: resolution is name-based; shadowing is handled temporally --
        #: the most recent definition before a binding wins)
        self.jits = {}
        #: builder function name -> TracedSymbol of the callable it returns
        self.builders = {}
        #: class name -> {attr: TracedSymbol} for ``self.attr = <traced>``
        self.class_attrs = {}
        #: class name -> {attr: callee name} for ``self.attr = fn(...)``
        #: where ``fn`` could not be resolved locally (possibly an
        #: imported builder -- resolved lazily by ProjectIndex)
        self.class_attr_calls = {}
        #: static-output key (name or ("self", attr)) -> its CUDAGraph's
        #: symbol: what a capture block binds, and each replay refreshes
        self.graph_outputs = {}
        #: local import name -> (module, original name)
        self.imports = {}
        self._collect_imports(tree)
        self._walk(tree, class_name=None, fn_stack=[])
        self._collect_graph_outputs(tree)

    # .. imports ..........................................................
    def _collect_imports(self, tree):
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    self.imports[a.asname or a.name] = (node.module, a.name)

    # .. traced binding shapes ............................................
    def _tracer_call_symbol(self, call, scope_defs):
        """``torch.compile(target, ...)``-style call (or a
        ``torch.cuda.CUDAGraph()``) -> TracedSymbol or None. ``target``
        may be a def name, a lambda, or any callable expression (a
        module instance handed to ``make_graphed_callables``)."""
        if self.aliases.canon(call.func) == _GRAPH_CTOR:
            return TracedSymbol(None, "graph", True)
        info = tracer_call_info(call, self.aliases)
        if info is None or not call.args:
            return None
        kind, kwargs = info
        target = call.args[0]
        func = target if isinstance(target, ast.Lambda) else (
            scope_defs.get(target.id) if isinstance(target, ast.Name)
            else None)
        # a def or lambda names the symbol; any other callable (a module
        # instance) is named after its binding
        name = (getattr(func, "name", "<lambda>")
                if isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)) else None)
        return TracedSymbol(name, kind, is_graphed(kind, kwargs))

    def _decorated_symbol(self, node):
        """FunctionDef with a tracer decorator -> TracedSymbol or None."""
        for dec in node.decorator_list:
            kind = self.aliases.tracer_kind(dec)
            info = (kind, {}) if kind is not None else (
                tracer_call_info(dec, self.aliases)
                if isinstance(dec, ast.Call) else None)
            if info is not None:
                return TracedSymbol(node.name, info[0], is_graphed(*info))
        return None

    # .. scope walk .......................................................
    def _walk(self, node, class_name, fn_stack):
        body = getattr(node, "body", [])
        scope_defs = {}
        for stmt in ast.walk(node):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and stmt is not node:
                scope_defs.setdefault(stmt.name, stmt)
            elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                scope_defs.setdefault(stmt.targets[0].id, stmt.value)

        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                sym = self._decorated_symbol(stmt)
                if sym is not None:
                    self.jits[stmt.name] = sym
                self._walk(stmt, class_name, fn_stack + [stmt])
            elif isinstance(stmt, ast.ClassDef):
                self._walk(stmt, stmt.name, fn_stack)
            else:
                self._scan_assigns(stmt, scope_defs, class_name)
                # compound statements may nest assigns/defs one level in
                for attr in ("body", "orelse", "finalbody"):
                    for sub in getattr(stmt, attr, ()):
                        if isinstance(sub, (ast.FunctionDef,
                                            ast.AsyncFunctionDef)):
                            sym = self._decorated_symbol(sub)
                            if sym is not None:
                                self.jits[sub.name] = sym
                            self._walk(sub, class_name, fn_stack + [sub])
                        else:
                            self._scan_assigns(sub, scope_defs, class_name)

        # builder detection: does this function return a traced local?
        if fn_stack and isinstance(node, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)):
            for stmt in body:
                if isinstance(stmt, ast.Return) \
                        and isinstance(stmt.value, ast.Name):
                    sym = self.jits.get(stmt.value.id)
                    if sym is not None:
                        self.builders[node.name] = sym

    def _scan_assigns(self, stmt, scope_defs, class_name):
        if not isinstance(stmt, ast.Assign):
            return
        value = stmt.value
        sym = None
        if isinstance(value, ast.Call):
            sym = self._tracer_call_symbol(value, scope_defs)
        elif isinstance(value, ast.Name):
            sym = self.jits.get(value.id)
        for tgt in stmt.targets:
            # `a, b = make_graphed_callables((m1, m2), ...)`: one graph
            # each, so a call of one never stales the other's outputs
            elts = (tgt.elts if isinstance(tgt, (ast.Tuple, ast.List))
                    and sym is not None else [tgt])
            for e in elts:
                self._bind(e, value, sym if e is tgt else
                           sym.renamed(_expr_name(e)), class_name)

    def _bind(self, tgt, value, sym, class_name):
        if sym is not None and (sym.kind == "graph" or sym.name is None):
            sym = sym.renamed(_expr_name(tgt))
        if isinstance(tgt, ast.Name):
            if sym is not None:
                self.jits[tgt.id] = sym
        elif isinstance(tgt, ast.Attribute) \
                and isinstance(tgt.value, ast.Name) \
                and tgt.value.id == "self" and class_name:
            if sym is not None:
                self.class_attrs.setdefault(class_name, {})[tgt.attr] = sym
            elif isinstance(value, ast.Call) \
                    and isinstance(value.func, ast.Name):
                local = self.builders.get(value.func.id)
                if local is not None:
                    self.class_attrs.setdefault(
                        class_name, {})[tgt.attr] = local
                else:
                    self.class_attr_calls.setdefault(
                        class_name, {})[tgt.attr] = value.func.id

    def _collect_graph_outputs(self, tree):
        """The static outputs of each ``with torch.cuda.graph(g):``
        capture: every name or ``self.`` attribute its body binds."""
        def visit(node, class_name):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    visit(child, child.name)
                    continue
                if isinstance(child, (ast.With, ast.AsyncWith)):
                    for item in child.items:
                        g = graph_context_target(item, self.aliases)
                        sym = self._graph_symbol(g, class_name)
                        if sym is None:
                            continue
                        for n in ast.walk(child):
                            if isinstance(n, ast.Assign):
                                for t in n.targets:
                                    keys = set()
                                    _assigned_keys(t, keys)
                                    for k in keys:
                                        self.graph_outputs[k] = sym
                visit(child, class_name)

        visit(tree, None)

    def _graph_symbol(self, node, class_name):
        if isinstance(node, ast.Name):
            sym = self.jits.get(node.id)
        elif _var_key(node) is not None and class_name:
            sym = self.class_attrs.get(class_name, {}).get(node.attr)
        else:
            sym = None
        return sym if sym is not None and sym.kind == "graph" else None


class ProjectIndex:
    """Cross-module traced-callable resolution over the linted fileset."""

    def __init__(self):
        self.modules = {}  # dotted module name -> _ModuleSymbols

    @staticmethod
    def module_name(path):
        rel = path.replace(os.sep, "/")
        if rel.endswith(".py"):
            rel = rel[:-3]
        return rel.strip("/").replace("/", ".")

    def add_module(self, path, tree, aliases):
        mod = self.module_name(path)
        self.modules[mod] = _ModuleSymbols(tree, aliases)
        return self.modules[mod]

    def _lookup(self, module, name, seen=None):
        """-> (TracedSymbol, kind) with kind in ('jit', 'builder'), or
        (None, None). Follows import edges; a bare import module name is
        matched against full dotted names by suffix so relative layouts
        (tmp dirs, package roots) resolve."""
        seen = set() if seen is None else seen
        if (module, name) in seen:
            return None, None
        seen.add((module, name))
        info = self.modules.get(module)
        if info is None:
            return None, None
        if name in info.jits:
            return info.jits[name], "jit"
        if name in info.builders:
            return info.builders[name], "builder"
        if name in info.imports:
            src_mod, src_name = info.imports[name]
            cands = [src_mod] + [m for m in self.modules
                                 if m == src_mod
                                 or m.endswith("." + src_mod)]
            for cand in cands:
                sym, kind = self._lookup(cand, src_name, seen)
                if sym is not None:
                    return sym, kind
        return None, None

    def resolve_call(self, module, call, class_name=None, local_syms=None):
        """TracedSymbol for a call node, or None. Handles bare names
        (locals bound from builder calls via ``local_syms``, module
        symbols), ``self.attr`` calls (including attrs bound from
        imported builders), and ``g.replay()`` of a CUDAGraph."""
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr == "replay":
            sym = self._resolve_callee(module, f.value, class_name,
                                       local_syms)
            return sym if sym is not None and sym.kind == "graph" else None
        return self._resolve_callee(module, f, class_name, local_syms)

    def _resolve_callee(self, module, f, class_name, local_syms):
        if isinstance(f, ast.Name):
            if local_syms and f.id in local_syms:
                return local_syms[f.id]
            sym, kind = self._lookup(module, f.id)
            return sym if kind == "jit" else None
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == "self" and class_name:
            info = self.modules.get(module)
            if info is None:
                return None
            sym = info.class_attrs.get(class_name, {}).get(f.attr)
            if sym is not None:
                return sym
            callee = info.class_attr_calls.get(class_name, {}).get(f.attr)
            if callee is not None:
                sym, kind = self._lookup(module, callee)
                if kind == "builder":
                    return sym
        return None

    def resolve_binding(self, module, value):
        """TracedSymbol produced by an assignment RHS that calls a builder
        (``fn = make_step(...)``), local or imported."""
        if isinstance(value, ast.Call) and isinstance(value.func, ast.Name):
            sym, kind = self._lookup(module, value.func.id)
            if kind == "builder":
                return sym
        return None

    def any_graphed(self):
        """Whether any module binds a graphed callable: with none, no
        call anywhere can resolve to one."""
        return any(sym.graphed
                   for info in self.modules.values()
                   for table in ([info.jits, info.builders]
                                 + list(info.class_attrs.values()))
                   for sym in table.values())

    def graph_output_owner(self, module, key):
        """The CUDAGraph symbol whose capture binds ``key``, or None."""
        info = self.modules.get(module)
        return None if info is None else info.graph_outputs.get(key)


# -- FL110: use after replay ----------------------------------------------

def _var_key(node):
    """Trackable operand identity: bare name or ``self.attr``."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return ("self", node.attr)
    return None


def _key_disp(key):
    return ".".join(key) if isinstance(key, tuple) else key


def _assigned_keys(target, out):
    if isinstance(target, (ast.Tuple, ast.List)):
        for e in target.elts:
            _assigned_keys(e, out)
    elif isinstance(target, ast.Starred):
        _assigned_keys(target.value, out)
    else:
        key = _var_key(target)
        if key is not None:
            out.add(key)


def _header_nodes(stmt):
    """The expressions of a statement that evaluate at its own point in
    the sequence (compound bodies are recursed into separately)."""
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, ast.For):
        return [stmt.iter]
    if isinstance(stmt, (ast.AsyncFor,)):
        return [stmt.iter]
    if isinstance(stmt, ast.With):
        return [item.context_expr for item in stmt.items]
    if isinstance(stmt, ast.Try):
        return []
    return [stmt]


def _kept(stmt_or_call):
    """``(container node, kept value nodes)`` when a node keeps values in
    a container: ``c.append(v)``-style calls and ``c[k] = v``."""
    n = stmt_or_call
    if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
            and n.func.attr in STORE_METHODS:
        return n.func.value, list(n.args)
    if isinstance(n, ast.Assign) and len(n.targets) == 1 \
            and isinstance(n.targets[0], ast.Subscript):
        return n.targets[0].value, [n.value]
    return None


class _ReplayChecker:
    """Linear-order statement walk flagging reads of graphed outputs
    after the next call of their callable overwrote them."""

    def __init__(self, index, module, add_finding):
        self.index = index
        self.module = module
        self.add = add_finding

    def check_stmts(self, stmts, class_name=None):
        local_syms = {}
        for stmt in stmts:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                sym = self.index.resolve_binding(self.module, stmt.value)
                if sym is not None:
                    local_syms[stmt.targets[0].id] = sym
        self._run(stmts, {}, {}, class_name, local_syms)

    def _graphed(self, call, class_name, local_syms):
        sym = self.index.resolve_call(self.module, call, class_name,
                                      local_syms)
        return sym if sym is not None and sym.graphed else None

    def _output_of(self, expr, held, class_name, local_syms):
        """``(sym, node)`` when ``expr`` evaluates to a graphed output
        buffer or a view of one: a graphed call, a name holding one, or
        a CUDAGraph's static output."""
        while True:
            if isinstance(expr, (ast.Subscript, ast.Starred)):
                expr = expr.value
            elif isinstance(expr, ast.Call) \
                    and isinstance(expr.func, ast.Attribute) \
                    and expr.func.attr in ALIAS_METHODS:
                expr = expr.func.value
            else:
                break
        if isinstance(expr, ast.Call):
            sym = self._graphed(expr, class_name, local_syms)
            return None if sym is None else (sym, expr)
        key = _var_key(expr)
        if key is None:
            return None
        if key in held:
            return held[key]
        owner = self.index.graph_output_owner(self.module, key)
        return None if owner is None else (owner, expr)

    def _run(self, stmts, held, stale, class_name, local_syms):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested scopes analyzed separately
            headers = _header_nodes(stmt)
            # 1) reads of outputs a later call already overwrote
            for h in headers:
                for node in ast.walk(h):
                    key = _var_key(node)
                    if key is not None and key in stale \
                            and isinstance(getattr(node, "ctx", None),
                                           ast.Load):
                        sym, made, call = stale.pop(key)  # report once
                        self.add(node, "FL110",
                                 f"`{_key_disp(key)}` holds an output of "
                                 f"graphed `{sym.name}` (line "
                                 f"{made.lineno}) that its next call (line "
                                 f"{call.lineno}) overwrote, and is read "
                                 "again -- clone the output to keep it, or "
                                 "rebind the result")
                        break
            # 2) loops: an output kept across iterations in a container
            # the loop never rebinds is overwritten by the next call
            if isinstance(stmt, (ast.For, ast.While)):
                self._check_loop(stmt, class_name, local_syms)
            # 3) this statement's graphed calls overwrite the outputs of
            # their callables' previous calls, then bindings register
            for h in headers:
                for node in ast.walk(h):
                    if not isinstance(node, ast.Call):
                        continue
                    sym = self._graphed(node, class_name, local_syms)
                    if sym is None:
                        continue
                    for key, (hsym, made) in list(held.items()):
                        if hsym is sym:
                            stale[key] = (sym, made, node)
                            del held[key]
            rebound, fresh = set(), {}
            if isinstance(stmt, ast.Assign):
                out = self._output_of(stmt.value, held, class_name,
                                      local_syms)
                for tgt in stmt.targets:
                    keys = set()
                    _assigned_keys(tgt, keys)
                    rebound |= keys
                    if out is not None:
                        fresh.update(dict.fromkeys(keys, out))
            elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign, ast.For)):
                _assigned_keys(stmt.target, rebound)
            elif isinstance(stmt, ast.Delete):
                for tgt in stmt.targets:
                    _assigned_keys(tgt, rebound)
            kept = _kept(stmt.value if isinstance(stmt, ast.Expr)
                         else stmt)
            if kept is not None:
                box = _var_key(kept[0])
                for v in kept[1]:
                    out = self._output_of(v, held, class_name, local_syms)
                    if box is not None and out is not None:
                        fresh[box] = out
            for key in rebound:
                held.pop(key, None)
                stale.pop(key, None)
            held.update(fresh)
            # 4) recurse into compound bodies: each branch starts from a
            # COPY of the current state (a call in the if-body must not
            # flag reads in the mutually-exclusive orelse), and the
            # branch outcomes union back in afterwards -- code after the
            # statement sees a stale output if ANY path could have
            # overwritten it
            branch_outs = []
            bodies = [getattr(stmt, attr, None)
                      for attr in ("body", "orelse", "finalbody")]
            bodies += [h.body for h in getattr(stmt, "handlers", ())]
            for sub in bodies:
                if isinstance(sub, list) and sub:
                    branch = (dict(held), dict(stale))
                    self._run(sub, *branch, class_name, local_syms)
                    branch_outs.append(branch)
            for b_held, b_stale in branch_outs:
                held.update(b_held)
                stale.update(b_stale)
            for key in stale:
                held.pop(key, None)

    def _check_loop(self, loop, class_name, local_syms):
        rebound = set()
        called = set()
        for stmt in ast.walk(loop):
            if isinstance(stmt, ast.Assign):
                for tgt in stmt.targets:
                    _assigned_keys(tgt, rebound)
            elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign, ast.For)):
                _assigned_keys(stmt.target, rebound)
            elif isinstance(stmt, ast.Call):
                sym = self._graphed(stmt, class_name, local_syms)
                if sym is not None:
                    called.add(id(sym))

        def scan(node, top):
            for sub in ast.iter_child_nodes(node):
                if isinstance(sub, (ast.For, ast.While)) and not top:
                    continue  # nested loops get their own pass
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.Lambda)):
                    continue
                kept = _kept(sub)
                box = None if kept is None else _var_key(kept[0])
                if box is not None and box not in rebound:
                    for v in kept[1]:
                        out = self._output_of(v, {}, class_name, local_syms)
                        if out is not None and id(out[0]) in called:
                            self.add(v, "FL110",
                                     f"an output of graphed `{out[0].name}` "
                                     f"is kept in `{_key_disp(box)}` inside "
                                     "a loop that calls it again -- the "
                                     "next iteration's call overwrites the "
                                     "kept buffer; keep a `.clone()`")
                scan(sub, False)

        scan(loop, True)


def check_use_after_replay(index, module, tree, add_finding):
    """Run FL110 over every function body (and the module body) of one
    module, resolving graphed callables through ``index``."""
    if not index.any_graphed():
        return
    checker = _ReplayChecker(index, module, add_finding)

    def visit(node, class_name):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                checker.check_stmts(child.body, class_name)
                visit(child, class_name)
            else:
                visit(child, class_name)

    visit(tree, None)
    module_stmts = [s for s in tree.body
                    if not isinstance(s, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef))]
    checker.check_stmts(module_stmts, None)


__all__ = ["ALIAS_METHODS", "STORE_METHODS", "TracedSymbol",
           "ProjectIndex", "check_use_after_replay"]
