"""fedcheck cross-class pass: interprocedural lock-order & blocking (FL126);
the port's copy of ``fedml_tpu/analysis/crossclass.py``, framework-neutral.

The class-local concurrency pass (``analysis.concurrency``, FL123-FL125)
stops at the class boundary by construction: it sees ``self.finish()``
but not that ``finish()`` -- two classes away, through an attribute-typed
field -- runs the transport's STOP wave of blocking per-peer socket
writes. That exact chain (``ResilientFedAvgServer._on_round_complete``
holding ``_advance_lock`` -> ``finish()`` -> ``DistributedManager.finish``
-> ``TcpCommManager.stop_receive_message`` -> ``_send_frame``) once
shipped and was caught only by the *runtime* race sanitizer. This pass
decides it statically:

1. **Field typing** (:class:`CrossClassIndex`). ``self.f = Foo(...)``
   types a field directly. ``self.f = <ctor param>`` is typed by flowing
   constructor-call *arguments* project-wide: every ``Foo(x, ...)``
   instantiation site binds resolvable argument values (a local
   ``x = Bar(...)`` binding, a ``self.method`` bound-method reference, a
   nested constructor call, ``self`` itself) to ``Foo.__init__``'s
   parameters, and ``super().__init__(...)`` forwards those bindings up
   the base chain -- so ``DistributedManager.com_manager`` is typed
   ``{TcpCommManager, ...}`` by the managers' instantiation sites, and
   ``RoundController._on_complete`` resolves to the server's bound
   turnover callback. Unresolvable values type nothing (any-candidate
   semantics: a chain is followed through *every* candidate).

2. **Held-set propagation.** Walking from every method of every
   lock-creating class, the set of held lock *creation sites* (the same
   ``basename.py:line`` identity the runtime auditor and the flight
   recorder's ``held_while_blocking`` events use --
   :func:`fedml_tpu_torch.core.locks.creation_site`) propagates through
   ``self.m()`` / ``super().m()`` / ``self.field.m()`` calls into other
   classes. Acquisitions under a propagated hold contribute edges to ONE
   global order graph; cycles are found with the same
   :func:`~fedml_tpu_torch.analysis.concurrency.find_lock_cycles`
   detector the
   runtime sanitizer uses, so a static FL126 cycle and a runtime
   ``race/lock_order_cycles`` entry name the same sites.

Rule (two shapes, one code):

- **FL126 (blocking)** -- a call made while holding a *state* lock whose
  transitive callee chain reaches a blocking operation in another class.
  Anchored at the call statement in the method that holds the lock (the
  actionable line: move the call out of the ``with``). Calls that are
  themselves blocking-listed are FL125's class-local business and skipped.
- **FL126 (cycle)** -- a cycle in the global acquisition-order graph that
  a single class's AST cannot exhibit (sites span classes, or an edge was
  discovered under a hold carried across a class boundary). Purely
  class-local cycles stay FL124.

3. **Container-element typing.** A field assigned a list/set/dict
   literal is a *container*; its elements are typed by what flows in --
   directly (``self._peers[rank] = Conn(...)``) or through
   method-argument flow: when ``self.field.m(x)`` / ``self.m(x)`` binds
   a resolvable ``x`` (``self``, a ``self.method`` reference, a
   constructor call) to a parameter that the target method appends/
   stores into a container, the element type lands on that container.
   Locals bound by iterating or indexing a container (``for obs in
   self._observers:``, ``handler = self.handlers.get(t)``) carry the
   element types, so ``obs.receive_message(...)`` and the handler-dict
   dispatch ``handler(msg)`` are real call edges: the verifier now walks
   transport -> ``DistributedManager.receive_message`` -> registered FSM
   handler chains statically -- dispatching observers under a held state
   lock is an FL126 finding, not a runtime-sanitizer catch.

4. **Module-function scope.** Module-level function bodies are walked
   too: each module's top-level ``def`` bodies live in a synthetic
   ``<module>`` scope, bare-name calls (``aggregate_reports(...)``, the
   retry layer) resolve through same-module definitions and one import
   hop, and ctor-typed locals (``comm = TcpCommManager(...)``) type
   non-``self`` receivers -- so ``comm.add_observer(server)`` in a
   module-level run function lands the server class on the transport's
   observer container, the last untyped observer hop.

Soundness limits (documented, deliberate): locals returned by module
functions (``get_tracer()``, ``get_flight_recorder()``) are not typed --
chains through them are invisible here and remain the runtime
sanitizer's to catch; module-level *script* statements (code outside any
``def``) seed constructor-argument flows but are not walked as a call
scope; re-exported collections are untyped; ``.acquire()`` calls
outside a ``with`` do not open a held region (the repo's only uses are
bounded-timeout acquires, which cannot deadlock-by-order).
"""

from __future__ import annotations

import ast
import os

from fedml_tpu_torch.analysis.astwalk import walk
from fedml_tpu_torch.analysis.concurrency import (BLOCKING_ATTRS,
                                                  BLOCKING_NAMES,
                                            IO_CTORS, STATE_CTORS,
                                            find_lock_cycles)

#: Explore depth cap: real chains here are 3-4 frames; the cap only
#: bounds pathological recursion through mistyped any-candidates.
_MAX_DEPTH = 25

#: Bare-name calls never worth a ("func", ...) op: resolving each
#: builtin through the import maps is pure waste on every expression.
_BUILTIN_NAMES = frozenset({
    "len", "sorted", "float", "int", "str", "list", "dict", "set",
    "tuple", "frozenset", "isinstance", "issubclass", "getattr",
    "setattr", "hasattr", "print", "min", "max", "sum", "range",
    "enumerate", "zip", "abs", "round", "id", "repr", "type", "bool",
    "bytes", "bytearray", "iter", "next", "open", "super", "vars",
    "format", "map", "filter", "any", "all", "divmod", "hash", "ord",
    "chr", "callable", "memoryview", "slice", "reversed",
})


def _self_attr(node):
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _ctor_kind(func):
    name = func.attr if isinstance(func, ast.Attribute) else (
        func.id if isinstance(func, ast.Name) else None)
    if name in STATE_CTORS:
        return "state"
    if name in IO_CTORS:
        return "io"
    return None


class _Op:
    """One analyzed operation inside a method body."""

    __slots__ = ("kind", "data", "held", "node")

    def __init__(self, kind, data, held, node):
        self.kind = kind    # "acquire" | "block" | "call"
        self.data = data    # family attr | label | call-target descriptor
        self.held = held    # frozenset of local family attrs held here
        self.node = node


class _ClassInfo:
    """Extraction of one class: lock families (with creation-site
    identity), field value sources, and per-method op streams."""

    def __init__(self, module, path, node):
        self.module = module
        self.path = path
        self.node = node
        self.name = node.name
        self.key = (module, node.name)
        self.bases = [_base_name(b) for b in node.bases]
        self.methods = {m.name: m for m in node.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))}
        #: family attr -> (kind, creation site "basename.py:line")
        self.families = {}
        #: field attr -> list of value refs:
        #:   ("class", name)    -- self.f = Name(...)
        #:   ("param", pname)   -- self.f = <ctor param> (flow-typed)
        #:   ("method", mname)  -- self.f = self.m (bound method)
        self.field_refs = {}
        #: container fields (list/set/dict literal assigns) + their
        #: element typing inputs (the container-element pass):
        #:   elem_refs[attr]  -- direct refs, field_refs grammar plus
        #:                       ("selfcls", None) for `self`
        #:   elem_sinks[attr] -- [(method, pname)]: the method stores its
        #:                       parameter into the container; call-arg
        #:                       flow resolves the element types
        self.containers = set()
        self.elem_refs = {}
        self.elem_sinks = {}
        #: method-argument flow seeds: (call descriptor, [per-positional-
        #: arg ref lists], {kwarg: ref list}) for self./field calls whose
        #: arguments are resolvable (self / self.m / Ctor())
        self.call_args = []
        #: method name -> [_Op]
        self.ops = {}
        self._locals = {}
        self._elem_aliases = {}
        self._ctor_local_map = {}
        self._collect_families()
        self._collect_containers()
        for name, fn in self.methods.items():
            self._locals = self._lock_aliases(fn)
            self._elem_aliases = self._container_aliases(fn)
            self._ctor_local_map = self._ctor_locals(fn)
            out = []
            self._visit(fn.body, out, frozenset())
            self.ops[name] = out
            self._collect_fields(name, fn)
            self._collect_elems(name, fn)

    # -- families / fields -------------------------------------------------
    def _collect_families(self):
        base = os.path.basename(self.path)
        for fn in self.methods.values():
            for node in walk(fn):
                if not isinstance(node, ast.Assign) \
                        or not isinstance(node.value, ast.Call):
                    continue
                kind = _ctor_kind(node.value.func)
                if kind is None:
                    continue
                for tgt in node.targets:
                    attr = _self_attr(tgt)
                    if attr is None and isinstance(tgt, ast.Subscript):
                        attr = _self_attr(tgt.value)  # dict-of-locks
                    if attr is not None and attr not in self.families:
                        # creation-site identity == what the runtime
                        # factories' creation_site() reports: the line of
                        # the lock-constructor CALL
                        self.families[attr] = (
                            kind, f"{base}:{node.value.lineno}")

    def _collect_fields(self, method, fn):
        params = set(_param_names(fn))
        for node in walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                attr = _self_attr(tgt)
                if attr is None or attr in self.families:
                    continue
                for ref in _value_refs(node.value, params, self):
                    self.field_refs.setdefault(attr, []).append(ref)

    def _collect_containers(self):
        """Fields assigned a list/set/dict literal (or bare collection
        constructor) anywhere in the class are containers: their element
        types come from the sinks below, not from field_refs."""
        ctors = {"list", "set", "dict", "deque", "OrderedDict",
                 "defaultdict", "SimpleQueue", "Queue"}
        for fn in self.methods.values():
            for node in walk(fn):
                if not isinstance(node, ast.Assign):
                    continue
                v = node.value
                lit = isinstance(v, (ast.List, ast.Set, ast.Dict))
                lit = lit or (isinstance(v, ast.Call)
                              and isinstance(v.func, ast.Name)
                              and v.func.id in ctors)
                if not lit:
                    continue
                for tgt in node.targets:
                    attr = _self_attr(tgt)
                    if attr is not None and attr not in self.families:
                        self.containers.add(attr)

    def _collect_elems(self, method, fn):
        """Element sinks of this method: ``self.a.append(x)`` /
        ``.add(x)`` / ``self.a[k] = x`` with ``a`` a container. A
        resolvable ``x`` types the elements directly; a parameter
        ``x`` registers (method, param) for call-argument flow."""
        params = set(_param_names(fn))

        def sink(attr, value):
            if isinstance(value, ast.Name) and value.id == "self":
                self.elem_refs.setdefault(attr, []).append(
                    ("selfcls", None))
                return
            if isinstance(value, ast.Name) and value.id in params:
                self.elem_sinks.setdefault(attr, []).append(
                    (method, value.id))
                return
            for ref in _value_refs(value, set(), self):
                self.elem_refs.setdefault(attr, []).append(ref)
            # local `x = Ctor()` bindings count too (the event loop's
            # `conn = _Conn(sock); self._peers[rank] = conn` shape)
            if isinstance(value, ast.Name) \
                    and value.id in self._ctor_locals(fn):
                for name in self._ctor_locals(fn)[value.id]:
                    self.elem_refs.setdefault(attr, []).append(
                        ("class", name))

        for node in walk(fn):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("append", "add", "appendleft"):
                attr = _self_attr(node.func.value)
                if attr in self.containers and node.args:
                    sink(attr, node.args[0])
            elif isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Subscript):
                        attr = _self_attr(tgt.value)
                        if attr in self.containers:
                            sink(attr, node.value)

    def _ctor_locals(self, fn):
        out = {}
        for node in walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call) \
                    and isinstance(node.value.func, ast.Name):
                out.setdefault(node.targets[0].id,
                               set()).add(node.value.func.id)
        return out

    def _container_aliases(self, fn):
        """Local names carrying a container field's ELEMENTS: loop
        variables over the container (raw / list() / sorted() /
        .values()) and ``.get``/subscript reads."""
        out = {}

        def container_of(expr):
            attr = _self_attr(expr)
            if attr in self.containers:
                return attr
            if isinstance(expr, ast.Call):
                if isinstance(expr.func, ast.Name) \
                        and expr.func.id in ("list", "sorted", "tuple") \
                        and expr.args:
                    return container_of(expr.args[0])
                if isinstance(expr.func, ast.Attribute) \
                        and expr.func.attr in ("values", "get"):
                    return container_of(expr.func.value)
            if isinstance(expr, ast.Subscript):
                return container_of(expr.value)
            return None

        for node in walk(fn):
            if isinstance(node, ast.For) \
                    and isinstance(node.target, ast.Name):
                attr = container_of(node.iter)
                if attr is not None:
                    out[node.target.id] = attr
            elif isinstance(node, ast.Assign) \
                    and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, (ast.Call, ast.Subscript)):
                attr = container_of(node.value)
                if attr is not None:
                    out[node.targets[0].id] = attr
        return out

    def state_sites(self):
        return {s for (k, s) in self.families.values() if k == "state"}

    # -- op stream ---------------------------------------------------------
    def _lock_aliases(self, fn):
        out = {}
        for node in walk(fn):
            if isinstance(node, ast.Assign):
                fam = self._expr_family(node.value, out)
                if fam is None:
                    continue
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        out[tgt.id] = fam
        return out

    def _expr_family(self, expr, aliases=None):
        aliases = self._locals if aliases is None else aliases
        for node in walk(expr):
            attr = _self_attr(node)
            if attr is not None and attr in self.families:
                return attr
            if isinstance(node, ast.Name) and node.id in aliases:
                return aliases[node.id]
        return None

    def _visit(self, stmts, out, held):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested scopes run on unknowable threads
            if isinstance(stmt, ast.With):
                new = held
                for item in stmt.items:
                    self._scan_expr(item.context_expr, out, held)
                    fam = self._expr_family(item.context_expr)
                    if fam is not None:
                        out.append(_Op("acquire", fam, new, stmt))
                        new = new | {fam}
                self._visit(stmt.body, out, new)
                continue
            for h in _header_exprs(stmt):
                self._scan_expr(h, out, held)
            for attr_name in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, attr_name, None)
                if isinstance(sub, list):
                    self._visit(sub, out, held)
            for handler in getattr(stmt, "handlers", ()):
                self._visit(handler.body, out, held)

    def _scan_expr(self, expr, out, held):
        if expr is None:
            return

        def visit(node):
            if isinstance(node, (ast.Lambda, ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                return
            if isinstance(node, ast.Call):
                self._classify_call(node, out, held)
            for child in ast.iter_child_nodes(node):
                visit(child)

        visit(expr)

    def _classify_call(self, node, out, held):
        f = node.func
        if isinstance(f, ast.Name):
            if f.id in BLOCKING_NAMES:
                out.append(_Op("block", f.id, held, node))
            elif f.id in self._elem_aliases:
                # direct call of a container ELEMENT (`handler(msg)`
                # where handler came off the handler dict): resolves
                # through the container's element types
                out.append(_Op("call",
                               ("elem", self._elem_aliases[f.id], None),
                               held, node))
            elif f.id not in _BUILTIN_NAMES:
                # bare-name call: a module-level function (own module or
                # one import hop) -- resolved later; unresolvable names
                # (classes, dead imports) simply yield no targets
                out.append(_Op("call", ("func", f.id, None), held, node))
            return
        if not isinstance(f, ast.Attribute):
            return
        if f.attr in BLOCKING_ATTRS and not _str_receiver(f.value):
            out.append(_Op("block", f.attr, held, node))
        sattr = _self_attr(f)
        if sattr is not None:
            # self.m(...): own/inherited method (resolved later via MRO)
            # or a callable field (MethodRef-typed) invoked directly
            out.append(_Op("call", ("self", sattr, None), held, node))
            self._record_call_args(("self", sattr, None), node)
            return
        if isinstance(f.value, ast.Call) \
                and isinstance(f.value.func, ast.Name) \
                and f.value.func.id == "super":
            out.append(_Op("call", ("super", f.attr, None), held, node))
            return
        if isinstance(f.value, ast.Name) \
                and f.value.id in self._elem_aliases:
            # method on a container element (`obs.receive_message(...)`
            # with obs iterating the _observers list)
            out.append(_Op("call",
                           ("elem", self._elem_aliases[f.value.id],
                            f.attr), held, node))
            return
        if isinstance(f.value, ast.Name) \
                and f.value.id in self._ctor_local_map:
            # method on a ctor-typed LOCAL (`comm = TcpCommManager(...);
            # comm.add_observer(server)`): the non-self receiver hop
            for cname in sorted(self._ctor_local_map[f.value.id]):
                data = ("localcls", cname, f.attr)
                out.append(_Op("call", data, held, node))
                self._record_call_args(data, node)
            return
        fattr = _self_attr(f.value)
        if fattr is not None and fattr not in self.families:
            # self.field.m(...): resolved through the field's types
            out.append(_Op("call", ("field", fattr, f.attr), held, node))
            self._record_call_args(("field", fattr, f.attr), node)

    def _arg_ref(self, value):
        """Resolvable method-call argument: the element-flow seeds."""
        if isinstance(value, ast.Name) and value.id == "self":
            return [("selfcls", None)]
        if isinstance(value, ast.Name) \
                and value.id in self._ctor_local_map:
            return [("class", c)
                    for c in sorted(self._ctor_local_map[value.id])]
        attr = _self_attr(value)
        if attr is not None and attr in self.methods:
            return [("method", attr)]
        if isinstance(value, ast.Call) \
                and isinstance(value.func, ast.Name):
            return [("class", value.func.id)]
        return []

    def _record_call_args(self, data, node):
        argrefs = [self._arg_ref(a) for a in node.args]
        kwrefs = {kw.arg: self._arg_ref(kw.value)
                  for kw in node.keywords if kw.arg}
        if any(argrefs) or any(kwrefs.values()):
            self.call_args.append((data, argrefs, kwrefs))


def _str_receiver(node):
    """A string-literal receiver (``",".join(...)``, f-string methods):
    never a thread/process join, whatever the attribute name says."""
    return isinstance(node, ast.JoinedStr) or (
        isinstance(node, ast.Constant) and isinstance(node.value, str))


def _base_name(node):
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _param_names(func):
    a = func.args
    return ([p.arg for p in a.posonlyargs] + [p.arg for p in a.args]
            + [p.arg for p in a.kwonlyargs])


def _value_refs(value, params, cls):
    """Resolvable sources of an assigned value: class constructions,
    ctor params (flow-typed later), bound methods. BoolOp defaults
    (``x = x or Default()``) union their operands."""
    if isinstance(value, ast.BoolOp):
        out = []
        for v in value.values:
            out.extend(_value_refs(v, params, cls))
        return out
    if isinstance(value, ast.Call) and isinstance(value.func, ast.Name):
        return [("class", value.func.id)]
    if isinstance(value, ast.Name) and value.id in params:
        return [("param", value.id)]
    attr = _self_attr(value)
    if attr is not None and attr in cls.methods:
        return [("method", attr)]
    return []


def _header_exprs(stmt):
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter]
    if isinstance(stmt, ast.Return):
        return [stmt.value] if stmt.value is not None else []
    if isinstance(stmt, ast.Expr):
        return [stmt.value]
    if isinstance(stmt, ast.Assign):
        return [stmt.value] + list(stmt.targets)
    if isinstance(stmt, ast.AnnAssign):
        return [e for e in (stmt.value, stmt.target) if e is not None]
    if isinstance(stmt, ast.AugAssign):
        return [stmt.value, stmt.target]
    if isinstance(stmt, ast.Assert):
        return [stmt.test]
    if isinstance(stmt, ast.Raise):
        return [e for e in (stmt.exc, stmt.cause) if e is not None]
    return []


class CrossClassIndex:
    """Project-wide class/field/flow resolution (FL126 pass 1)."""

    def __init__(self):
        self.modules = {}       # dotted module -> {"imports", "classes"}
        self._flows = {}        # (module, class, param) -> set of targets
        self._elem_flows = {}   # (class key, container attr) -> targets
        self._finalized = False
        self._method_cache = {}  # (class key, name) -> (owner, fn)
        self._field_cache = {}   # (class key, attr) -> target set
        self._elem_cache = {}    # (class key, attr) -> element target set

    @staticmethod
    def module_name(path):
        # delegated, not copied: the linter keys its findings pipeline
        # by ProtocolIndex.module_name, and a finding whose module
        # string diverges from that keying is silently DROPPED -- the
        # two derivations must be the same function, not lookalikes
        from fedml_tpu_torch.analysis.protocol import ProtocolIndex
        return ProtocolIndex.module_name(path)

    def add_module(self, path, tree):
        mod = self.module_name(path)
        imports = {}
        for node in walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    imports[a.asname or a.name] = (node.module, a.name)
        classes = {}
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                classes[node.name] = _ClassInfo(mod, path, node)
        # module-level function bodies: a synthetic "<module>" scope so
        # aggregate_reports-style free functions are walked like methods
        # ("<" keeps the name unreachable from any real ast.Name)
        mod_fns = [n for n in tree.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        if mod_fns:
            fake = ast.ClassDef(name="<module>", bases=[], keywords=[],
                                body=mod_fns, decorator_list=[])
            classes["<module>"] = _ClassInfo(mod, path, fake)
        self.modules[mod] = {"imports": imports, "classes": classes,
                             "tree": tree}
        self._finalized = False
        self._method_cache.clear()
        self._field_cache.clear()
        self._elem_cache.clear()

    # -- name resolution ---------------------------------------------------
    def _candidates(self, src_mod):
        return [src_mod] + [m for m in self.modules
                            if m == src_mod or m.endswith("." + src_mod)]

    def resolve_class(self, module, name, seen=None):
        seen = set() if seen is None else seen
        if (module, name) in seen:
            return None
        seen.add((module, name))
        info = self.modules.get(module)
        if info is None:
            return None
        if name in info["classes"]:
            return info["classes"][name]
        if name in info["imports"]:
            src_mod, src_name = info["imports"][name]
            for cand in self._candidates(src_mod):
                cls = self.resolve_class(cand, src_name, seen)
                if cls is not None:
                    return cls
        return None

    def resolve_function(self, module, name, seen=None):
        """Module-level function resolution for ("func", name) calls:
        the owning "<module>" scope in ``module`` itself, else one or
        more ImportFrom hops. Returns the owning _ClassInfo or None."""
        seen = set() if seen is None else seen
        if (module, name) in seen:
            return None
        seen.add((module, name))
        info = self.modules.get(module)
        if info is None:
            return None
        modcls = info["classes"].get("<module>")
        if modcls is not None and name in modcls.methods:
            return modcls
        if name in info["imports"]:
            src_mod, src_name = info["imports"][name]
            for cand in self._candidates(src_mod):
                owner = self.resolve_function(cand, src_name, seen)
                if owner is not None:
                    return owner
        return None

    def find_method(self, cls, name, seen=None):
        """(owning _ClassInfo, FunctionDef) along the base chain, or
        (None, None)."""
        if seen is None:
            if cls is None:
                return None, None
            ck = (cls.key, name)
            if ck in self._method_cache:
                return self._method_cache[ck]
            out = self.find_method(cls, name, set())
            self._method_cache[ck] = out
            return out
        if cls is None or cls.key in seen:
            return None, None
        seen.add(cls.key)
        if name in cls.methods:
            return cls, cls.methods[name]
        for base in cls.bases:
            if base is None:
                continue
            bcls = self.resolve_class(cls.module, base)
            owner, fn = self.find_method(bcls, name, seen)
            if owner is not None:
                return owner, fn
        return None, None

    def find_base_method(self, cls, name):
        """``super().name`` resolution: first base (transitively) that
        defines ``name``, excluding ``cls`` itself."""
        for base in cls.bases:
            if base is None:
                continue
            bcls = self.resolve_class(cls.module, base)
            owner, fn = self.find_method(bcls, name)
            if owner is not None:
                return owner, fn
        return None, None

    def init_params(self, cls):
        owner, fn = self.find_method(cls, "__init__")
        if fn is None:
            return None, []
        return owner, [p for p in _param_names(fn) if p != "self"]

    # -- constructor-argument flow (pass 1.5) ------------------------------
    def finalize(self):
        """Flow constructor-call arguments into ``__init__`` parameters:
        direct instantiation sites seed the flows, ``super().__init__``
        calls forward them up the base chain to a fixpoint."""
        if self._finalized:
            return
        self._finalized = True
        self._flows = {}
        super_edges = []   # ((sub_owner, sub_param) -> (base_owner, bparam))
        for mod, info in self.modules.items():
            self._scan_instantiations(mod, info["tree"], super_edges)
        for _ in range(len(self._flows) + len(super_edges) + 1):
            changed = False
            for (src, dst) in super_edges:
                vals = self._flows.get(src, set())
                cur = self._flows.setdefault(dst, set())
                if not vals <= cur:
                    cur |= vals
                    changed = True
            if not changed:
                break
        self._compute_elem_flows()

    # -- container-element flow (pass 1.75) --------------------------------
    def _resolve_ref(self, cls, ref):
        kind, val = ref[0], ref[1]
        if kind == "selfcls":
            return ("cls", cls.key)
        if kind == "method":
            return ("mref", cls.key, val)
        if kind == "class":
            tcls = self.resolve_class(cls.module, val)
            return ("cls", tcls.key) if tcls is not None else None
        return None

    def _call_arg_targets(self, cls, data):
        """(search class, method name) candidates for one recorded
        call-args descriptor."""
        kind, a, b = data
        if kind == "self":
            owner, fn = self.find_method(cls, a)
            return [(cls, a)] if owner is not None else []
        if kind == "field":
            out = []
            for ref in self.field_types(cls, a):
                if ref[0] == "cls":
                    tcls = self.class_by_key(ref[1])
                    if tcls is not None:
                        out.append((tcls, b))
            return out
        if kind == "localcls":
            tcls = self.resolve_class(cls.module, a)
            return [(tcls, b)] if tcls is not None else []
        return []

    def _compute_elem_flows(self):
        """Flow resolvable method-call arguments into the container
        sinks of the called methods: ``self.com_manager.add_observer(
        self)`` lands the manager class on the transport's
        ``_observers``; ``self.register_message_receive_handler(T,
        self._on_x)`` lands the handler mref on the handler dict.
        ``__init__``-parameter sinks reuse the constructor-argument
        flows. Fixpoint because a flow can unlock a field resolution."""
        self._elem_flows = {}
        for cls in self.all_classes():
            for attr, sinks in cls.elem_sinks.items():
                for (m, p) in sinks:
                    if m != "__init__":
                        continue
                    for t in self._flows.get((cls.key, p), ()):
                        self._elem_flows.setdefault(
                            (cls.key, attr), set()).add(t)
        for _ in range(4):  # observer/handler chains are depth 1-2
            changed = False
            for cls in self.all_classes():
                for (data, argrefs, kwrefs) in cls.call_args:
                    for (search, mname) in self._call_arg_targets(cls,
                                                                  data):
                        owner, fn = self.find_method(search, mname)
                        if owner is None or not owner.elem_sinks:
                            continue
                        sinkmap = {}
                        for attr, sinks in owner.elem_sinks.items():
                            for (m, p) in sinks:
                                if m == mname:
                                    sinkmap.setdefault(p, set()).add(attr)
                        if not sinkmap:
                            continue
                        params = [p for p in _param_names(fn)
                                  if p != "self"]
                        bound = list(zip(params, argrefs))
                        bound += [(k, v) for k, v in kwrefs.items()
                                  if k in params]
                        for pname, refs in bound:
                            attrs = sinkmap.get(pname)
                            if not attrs or not refs:
                                continue
                            for ref in refs:
                                t = self._resolve_ref(cls, ref)
                                if t is None:
                                    continue
                                for attr in attrs:
                                    cur = self._elem_flows.setdefault(
                                        (owner.key, attr), set())
                                    if t not in cur:
                                        cur.add(t)
                                        changed = True
            if not changed:
                break
        self._elem_cache = {}

    def container_elem_types(self, cls, attr):
        """Element types of container field ``self.attr`` along the MRO:
        direct refs + flowed method-argument refs, same target grammar
        as :meth:`field_types`."""
        self.finalize()
        key = (cls.key, attr)
        if key in self._elem_cache:
            return self._elem_cache[key]
        out = set()
        cur, seen = cls, set()
        while cur is not None and cur.key not in seen:
            seen.add(cur.key)
            for ref in cur.elem_refs.get(attr, ()):
                t = self._resolve_ref(cur, ref)
                if t is not None:
                    out.add(t)
            out |= self._elem_flows.get((cur.key, attr), set())
            nxt = None
            for base in cur.bases:
                if base is None:
                    continue
                nxt = self.resolve_class(cur.module, base)
                if nxt is not None:
                    break
            cur = nxt
        self._elem_cache[key] = out
        return out

    def _scan_instantiations(self, mod, tree, super_edges):
        # enclosing-context walk: track current class + function so `self`
        # and `self.m` arguments and function-local ctor bindings resolve
        def visit(node, cur_cls, cur_fn_locals):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    cls = self.modules[mod]["classes"].get(child.name)
                    visit(child, cls or cur_cls, cur_fn_locals)
                    continue
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    locals_ = {}
                    for sub in walk(child):
                        if isinstance(sub, ast.Assign) \
                                and len(sub.targets) == 1 \
                                and isinstance(sub.targets[0], ast.Name) \
                                and isinstance(sub.value, ast.Call) \
                                and isinstance(sub.value.func, ast.Name):
                            tcls = self.resolve_class(mod,
                                                      sub.value.func.id)
                            if tcls is not None:
                                locals_.setdefault(sub.targets[0].id,
                                                   set()).add(tcls.key)
                    params = _param_names(child)
                    if child.name == "__init__" and cur_cls is not None:
                        self._scan_super_init(mod, cur_cls, child, params,
                                              super_edges)
                    visit(child, cur_cls, locals_)
                    continue
                if isinstance(child, ast.Call) \
                        and isinstance(child.func, ast.Name):
                    tcls = self.resolve_class(mod, child.func.id)
                    if tcls is not None:
                        self._bind_ctor_args(mod, tcls, child, cur_cls,
                                             cur_fn_locals)
                visit(child, cur_cls, cur_fn_locals)

        visit(tree, None, {})

    def _arg_targets(self, mod, value, cur_cls, fn_locals):
        """Resolve one constructor-argument expression to flow targets:
        ("cls", class_key) or ("mref", class_key, method)."""
        out = set()
        if isinstance(value, ast.Call) \
                and isinstance(value.func, ast.Name):
            tcls = self.resolve_class(mod, value.func.id)
            if tcls is not None:
                out.add(("cls", tcls.key))
        elif isinstance(value, ast.Name):
            if value.id == "self" and cur_cls is not None:
                out.add(("cls", cur_cls.key))
            for key in fn_locals.get(value.id, ()):
                out.add(("cls", key))
        else:
            attr = _self_attr(value)
            if attr is not None and cur_cls is not None \
                    and attr in cur_cls.methods:
                out.add(("mref", cur_cls.key, attr))
        return out

    def _bind_ctor_args(self, mod, tcls, call, cur_cls, fn_locals):
        owner, params = self.init_params(tcls)
        if owner is None:
            return
        bound = list(zip(params, call.args))
        bound += [(kw.arg, kw.value) for kw in call.keywords
                  if kw.arg in params]
        for pname, value in bound:
            targets = self._arg_targets(mod, value, cur_cls,
                                        fn_locals)
            if targets:
                self._flows.setdefault(
                    (owner.key, pname), set()).update(targets)

    def _scan_super_init(self, mod, cls, init_fn, params, super_edges):
        for node in walk(init_fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "__init__"
                    and isinstance(node.func.value, ast.Call)
                    and isinstance(node.func.value.func, ast.Name)
                    and node.func.value.func.id == "super"):
                continue
            base_owner, base_fn = self.find_base_method(cls, "__init__")
            if base_owner is None:
                continue
            bparams = [p for p in _param_names(base_fn) if p != "self"]
            bound = list(zip(bparams, node.args))
            bound += [(kw.arg, kw.value) for kw in node.keywords
                      if kw.arg in bparams]
            own_owner, _fn = self.find_method(cls, "__init__")
            for bp, value in bound:
                if isinstance(value, ast.Name) and value.id in params:
                    super_edges.append(((own_owner.key, value.id),
                                        (base_owner.key, bp)))
                else:
                    targets = self._arg_targets(mod, value, cls, {})
                    if targets:
                        self._flows.setdefault(
                            (base_owner.key, bp), set()).update(targets)

    # -- field typing ------------------------------------------------------
    def field_types(self, cls, attr):
        """Resolved targets of ``self.attr`` along the MRO: a set of
        ("cls", class_key) / ("mref", class_key, method) entries."""
        self.finalize()
        fk = (cls.key, attr)
        if fk in self._field_cache:
            return self._field_cache[fk]
        out = set()
        cur, seen = cls, set()
        while cur is not None and cur.key not in seen:
            seen.add(cur.key)
            for ref in cur.field_refs.get(attr, ()):
                kind, val = ref[0], ref[1]
                if kind == "class":
                    tcls = self.resolve_class(cur.module, val)
                    if tcls is not None:
                        out.add(("cls", tcls.key))
                elif kind == "method":
                    out.add(("mref", cur.key, val))
                elif kind == "param":
                    out |= self._flows.get((cur.key, val), set())
            nxt = None
            for base in cur.bases:
                if base is None:
                    continue
                nxt = self.resolve_class(cur.module, base)
                if nxt is not None:
                    break
            cur = nxt
        self._field_cache[fk] = out
        return out

    def class_by_key(self, key):
        info = self.modules.get(key[0])
        return info["classes"].get(key[1]) if info else None

    def all_classes(self):
        for info in self.modules.values():
            yield from info["classes"].values()


class _Checker:
    """FL126 pass 2: edges, cycles, and blocking anchors."""

    def __init__(self, index):
        self.index = index
        index.finalize()
        self.site_kind = {}     # site -> "state" | "io"
        self.site_class = {}    # site -> class key
        for cls in index.all_classes():
            for attr, (kind, site) in cls.families.items():
                self.site_kind[site] = kind
                self.site_class[site] = cls.key
        self.edges = {}         # (a, b) -> (module, node, cross_flag)
        #: (class key, method) -> {(ckey, label, module, line)}; built
        #: by ONE global fixpoint on first use (_compute_reach)
        self._reach_memo = None
        self._visit_memo = set()

    # -- call-target resolution -------------------------------------------
    def _targets(self, cls, data):
        kind, a, b = data
        if kind == "self":
            owner, fn = self.index.find_method(cls, a)
            if owner is not None:
                return [(owner, a)]
            # not a method anywhere on the MRO: maybe a callable field
            return self._field_targets(cls, a, None)
        if kind == "super":
            owner, fn = self.index.find_base_method(cls, a)
            return [(owner, a)] if owner is not None else []
        if kind == "field":
            return self._field_targets(cls, a, b)
        if kind == "elem":
            # call on (or of) a container ELEMENT: the observer fan-outs
            # and the handler-dict dispatch
            return self._refs_targets(
                self.index.container_elem_types(cls, a), b)
        if kind == "func":
            # bare-name call: module-level function in this module or
            # through one import hop (the "<module>" scope)
            owner = self.index.resolve_function(cls.module, a)
            return [(owner, a)] if owner is not None else []
        if kind == "localcls":
            # method on a ctor-typed local (`comm.add_observer(...)`)
            tcls = self.index.resolve_class(cls.module, a)
            if tcls is not None:
                owner, fn = self.index.find_method(tcls, b)
                if owner is not None:
                    return [(owner, b)]
            return []
        return []

    def _field_targets(self, cls, attr, method):
        return self._refs_targets(self.index.field_types(cls, attr),
                                  method)

    def _refs_targets(self, refs, method):
        out = []
        for ref in refs:
            if ref[0] == "cls":
                tcls = self.index.class_by_key(ref[1])
                if tcls is None:
                    continue
                name = method if method is not None else "__call__"
                owner, fn = self.index.find_method(tcls, name)
                if owner is not None:
                    out.append((owner, name))
            elif ref[0] == "mref" and method is None:
                # direct call of a bound-method-typed value
                tcls = self.index.class_by_key(ref[1])
                if tcls is not None:
                    owner, fn = self.index.find_method(tcls, ref[2])
                    if owner is not None:
                        out.append((owner, ref[2]))
        return out

    def _sites(self, cls, fams, state_only=False):
        out = set()
        for f in fams:
            kind, site = cls.families.get(f, (None, None))
            if site is not None and (not state_only or kind == "state"):
                out.add(site)
        return out

    # -- edge collection (held-set propagation) ----------------------------
    def collect_edges(self):
        for cls in self.index.all_classes():
            if not cls.families:
                continue
            for method in cls.ops:
                self._visit(cls, method, frozenset(), False, 0)

    def _visit(self, cls, method, entry, crossed, depth):
        key = (cls.key, method, entry, crossed)
        if depth > _MAX_DEPTH or key in self._visit_memo:
            return
        self._visit_memo.add(key)
        for op in cls.ops.get(method, ()):
            local = self._sites(cls, op.held)
            eff = entry | local
            if op.kind == "acquire":
                _kind, site = cls.families[op.data]
                for h in eff:
                    if h == site:
                        continue
                    cross = h in entry and crossed
                    prev = self.edges.get((h, site))
                    if prev is None or (cross and not prev[2]):
                        self.edges[(h, site)] = (cls.module, op.node, cross)
            elif op.kind == "call":
                for (tcls, tm) in self._targets(cls, op.data):
                    self._visit(tcls, tm, eff,
                                crossed or tcls.key != cls.key, depth + 1)

    # -- blocking reachability --------------------------------------------
    def _reaches_block(self, cls, method):
        if self._reach_memo is None:
            self._compute_reach()
        return self._reach_memo.get((cls.key, method), set())

    def _compute_reach(self):
        """Global fixpoint over the whole callgraph: per (class, method),
        the set of blocking ops transitively reachable. A fixpoint (not
        a memoized DFS) because recursion cycles -- A.m -> B.n -> A.m --
        must not freeze a partial (empty) result for the cycle partner:
        the PR-5 chain reached back through exactly such an edge."""
        direct, calls = {}, {}
        for cls in self.index.all_classes():
            for method, ops in cls.ops.items():
                key = (cls.key, method)
                d = direct.setdefault(key, set())
                c = calls.setdefault(key, set())
                for op in ops:
                    if op.kind == "block":
                        d.add((cls.key, op.data, cls.module,
                               getattr(op.node, "lineno", 0)))
                    elif op.kind == "call":
                        for (tcls, tm) in self._targets(cls, op.data):
                            c.add((tcls.key, tm))
        reach = {k: set(v) for k, v in direct.items()}
        changed = True
        while changed:
            changed = False
            for key, callees in calls.items():
                cur = reach[key]
                for callee in callees:
                    extra = reach.get(callee, set()) - cur
                    if extra:
                        cur |= extra
                        changed = True
        self._reach_memo = reach

    # -- findings ----------------------------------------------------------
    def run(self, emit):
        self.collect_edges()
        # cycle shape: the global graph, minus what FL124 already owns
        nodes_for = dict(self.edges)
        for cycle in find_lock_cycles(self.edges):
            closing = (cycle[-1], cycle[0])
            ring = list(zip(cycle, cycle[1:] + [cycle[0]]))
            classes = {self.site_class.get(s) for s in cycle}
            crossish = any(self.edges[e][2] for e in ring
                           if e in self.edges)
            if len(classes - {None}) <= 1 and not crossish:
                continue  # single-class cycle: FL124's finding, not ours
            module, node, _ = nodes_for[closing]
            order = " -> ".join(cycle + [cycle[0]])
            emit(module, node, "FL126",
                 f"cross-class lock-order cycle: {order} -- these locks "
                 "are acquired in opposite orders on call chains that "
                 "cross class boundaries, which no single class's AST "
                 "shows (FL124 cannot see it); the right thread "
                 "interleaving deadlocks both. The sites are lock "
                 "creation sites -- race_audit()'s "
                 "race/lock_order_cycles reports the same identifiers")
        # blocking shape: a call under a locally-held state lock whose
        # callee chain blocks in another class
        for cls in self.index.all_classes():
            state = {s for s in
                     (site for (_k, site) in cls.families.values())
                     if self.site_kind.get(s) == "state"}
            if not state:
                continue
            for method, ops in cls.ops.items():
                reported = set()
                blocked_labels = {id(op.node) for op in ops
                                  if op.kind == "block"}
                for op in ops:
                    if op.kind != "call" or id(op.node) in reported:
                        continue
                    held_state = self._sites(cls, op.held, state_only=True)
                    if not held_state:
                        continue
                    if id(op.node) in blocked_labels:
                        continue  # itself blocking-listed: FL125's job
                    hits = set()
                    for (tcls, tm) in self._targets(cls, op.data):
                        hits |= {h for h in self._reaches_block(tcls, tm)
                                 if h[0] != cls.key}
                    if not hits:
                        continue
                    reported.add(id(op.node))
                    hit = sorted(hits, key=lambda h: (h[2], h[3]))[0]
                    locks = ", ".join(sorted(held_state))
                    tgt = _describe_target(op.data)
                    emit(cls.module, op.node, "FL126",
                         f"`{cls.name}.{method}` calls {tgt} while "
                         f"holding state lock {locks}; the chain reaches "
                         f"blocking `{hit[1]}` in `{hit[0][1]}` "
                         f"({hit[2]}:{hit[3]}) -- a cross-class "
                         "held-while-blocking the class-local FL125 "
                         "cannot see: one wedged peer pins every thread "
                         "needing the lock. Make the call after "
                         "releasing it. race_audit()'s "
                         "held_while_blocking events cite the same lock "
                         "creation site")


def _describe_target(data):
    kind, a, b = data
    if kind == "self":
        return f"`self.{a}()`"
    if kind == "super":
        return f"`super().{a}()`"
    if kind == "elem":
        return (f"`.{b}()` on an element of `self.{a}`" if b is not None
                else f"an element of `self.{a}` (called directly)")
    if kind == "func":
        return f"`{a}()`"
    if kind == "localcls":
        return f"`.{b}()` on a local `{a}` instance"
    return f"`self.{a}.{b}()`"


def check_crossclass(index, emit):
    """Run FL126 over every module in ``index``; ``emit(module, node,
    code, message)`` receives each finding."""
    _Checker(index).run(emit)


__all__ = ["CrossClassIndex", "check_crossclass"]
