"""fedcheck protocol pass: static verification of the message-passing FSMs
(the port's copy of ``fedml_tpu/analysis/protocol.py``; framework-neutral,
its roots the port's ``core/managers.py``).

The distributed control plane is a set of ``ClientManager``/``ServerManager``
subclasses exchanging typed :class:`~fedml_tpu_torch.core.message.Message`
frames.
Its failure modes are protocol-level, not line-level: a type sent with no
registered handler on the other side is silently dropped by the receiving
manager (a ``logging.warning`` and a hung round -- the exact blocked-forever
behavior Bonawitz et al., MLSys 2019 §3 identify as cross-device FL's
dominant failure class), and a missing ``MSG_TYPE_PEER_LOST`` handler turns
every mid-round peer death into a hard ``RuntimeError`` out of
``DistributedManager.run``. All of it is decidable from the AST:

1. **Extraction** (pass 1, :class:`ProtocolIndex`): for every FSM subclass,
   the set of *handled* message types (``register_message_receive_handler``
   calls, resolving name-bound constants through module-level assignments
   and import edges) and the set of *sent* types (``Message(TYPE, ...)``
   constructions flowing into ``send_message``/``send_with_retry``).
2. **Pairing** (pass 2, :func:`check_protocol`): server FSMs are paired
   with client FSMs by role (which base class they descend from); a type
   sent by one role must be handled by some FSM of the counterpart role.

Rules:

- **FL120** -- a type is sent but no counterpart FSM registers a handler
  for it: the receiving manager logs-and-drops, the sender waits forever.
- **FL121** -- a concrete FSM registers handlers but none for
  ``MSG_TYPE_PEER_LOST``: ``core/managers.py`` fail-fasts at runtime when
  a peer dies (the receive loop stops and ``run()`` raises).
- **FL122** -- a handler is registered for a type nothing sends: dead
  protocol state (usually a renamed constant or a deleted send path).

Unresolvable types (computed strings, caller-supplied parameters) judge
nothing, and transport-reserved types (``__``-prefixed: peer-lost,
goodbye, stop) are synthesized by the transports, not sent by FSMs, so
they are exempt from FL120/FL122.

The v2 generation adds the *temporal* and *payload* halves of the same
model (the reference's ``docs/ANALYSIS.md``, "Cross-class callgraph"):

- **FL127** -- FSM sequencing: a registered handler with an execution
  path that neither replies (``send_message``/``send_with_retry``),
  advances the round controller (a call on a ``*Controller``-constructed
  field), terminates (``finish()``/``raise``), transitively does one of
  those through a same-class helper, nor *logs the decision to stand
  pat* -- today that path is a silently hung round, the temporal shape
  of FL120. An explicitly logged ignore (the client shrugging off a
  sibling's death) is a decision, not a silence, and passes.
- **FL128** -- payload schema: every literal ``msg.get("key")`` /
  ``msg["key"]`` read in a handler is checked against the keys the
  counterpart role's ``Message(TYPE, ...)`` build sites actually
  ``add()``. A read key no counterpart sets is a silent ``None``
  (read-never-set); a set key no counterpart handler reads is dead wire
  bytes (set-never-read) -- which matters at the compressed frame sizes
  the codec buys. Judged only when the evidence is closed: resolvable
  type, literal add keys, and (for set-never-read) handlers whose
  message parameter never escapes to calls the pass cannot see.
  Reserved keys (``msg_type``/``sender``/``receiver``, ``__``-prefixed
  control fields like the tracer's ``__trace__``) are exempt.
"""

from __future__ import annotations

import ast
import os

from fedml_tpu_torch.analysis.astwalk import walk

#: Known FSM root classes (``fedml_tpu_torch/core/managers.py``) and their
#: roles.
#: Matched by *name* so single-module analysis (tests, snippets) works even
#: when the managers module is outside the linted fileset.
FSM_ROOTS = {
    "ServerManager": "server",
    "ClientManager": "client",
    "DistributedManager": "both",
}

PEER_LOST_NAME = "MSG_TYPE_PEER_LOST"
PEER_LOST_VALUE = "__peer_lost__"

#: Transport-internal frame types: synthesized/consumed by the transports
#: themselves, never part of an FSM's send set.
_RESERVED_PREFIX = "__"

_SEND_FUNCS = {"send_message", "send_with_retry"}
_REGISTER = "register_message_receive_handler"

#: Envelope-reserved payload keys: set by the Message constructor or the
#: transports/tracer, never by FSM ``add()`` sites -- exempt from FL128.
_RESERVED_KEYS = {"msg_type", "sender", "receiver"}

#: Methods a handler may call on its message parameter without the
#: parameter "escaping" static view (FL128 set-never-read soundness).
_MSG_SELF_METHODS = {"get", "get_params", "get_sender_id",
                     "get_receiver_id", "get_type", "to_string"}

#: Callees a built Message may flow into without opening its schema:
#: delivery itself, the tracer (adds only the reserved ``__trace__``),
#: and container plumbing.
_BENIGN_MSG_SINKS = {"send_message", "send_with_retry", "inject", "append"}

#: Logging-call shapes: an explicitly logged no-op path is a decision,
#: not a silent hang (FL127).
_LOG_ROOTS = {"logging", "logger", "log", "warnings"}
_LOG_ATTRS = {"warning", "error", "exception", "info", "debug", "warn",
              "critical"}


class _TypeRef:
    """One message-type reference: the syntactic name (if any), the
    resolved string value (if resolvable), and the node to report at."""

    __slots__ = ("name", "value", "node")

    def __init__(self, name, value, node):
        self.name = name
        self.value = value
        self.node = node


class _MsgBuild:
    """One ``Message(TYPE, ...)`` build site and its observed payload:
    the literal keys ``add()``-ed to it, NAME-bound keys (module-level
    string constants like ``WIRE_DELTA_KEY`` -- resolved through the
    same constant/import machinery as message types, so the compressed-
    report schema stays judged instead of going open), and whether the
    schema is *open* (a computed key, or the message escaping into a
    call the pass cannot see may add more)."""

    __slots__ = ("type_ref", "keys", "named_keys", "open")

    def __init__(self, type_ref):
        self.type_ref = type_ref
        self.keys = {}       # key -> add-call node
        self.named_keys = []  # [_TypeRef] constant-named keys
        self.open = False


class _FsmClass:
    """Protocol surface of one class: bases, handled and sent types."""

    def __init__(self, module, node):
        self.module = module
        self.node = node
        self.name = node.name
        self.bases = [_base_name(b) for b in node.bases]
        self.handled = []  # [_TypeRef]
        self.sent = []     # [_TypeRef]
        self.registers_any = False
        self.handler_map = []      # (TypeRef, handler method name)
        self.builds = []           # [_MsgBuild] (send-capable classes)
        self.controller_attrs = set()  # fields built from *Controller(...)


def _base_name(node):
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _type_expr_ref(expr, node):
    """A message-type expression -> (name, literal value) pair; computed
    expressions yield (None, None) and judge nothing."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return _TypeRef(None, expr.value, node)
    if isinstance(expr, ast.Name):
        return _TypeRef(expr.id, None, node)
    if isinstance(expr, ast.Attribute):  # Cls.MSG_X style constants
        return _TypeRef(expr.attr, None, node)
    return _TypeRef(None, None, node)


class _ModuleProtocol:
    """Per-module extraction: string constants, imports, FSM classes."""

    def __init__(self, module, tree):
        self.module = module
        self.tree = tree
        #: module-level ``NAME = "literal"`` bindings (single assignment)
        self.constants = {}
        #: local name -> (source module, original name)
        self.imports = {}
        self.classes = {}  # class name -> _FsmClass
        self._collect_constants(tree)
        self._collect_imports(tree)
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                self.classes[node.name] = self._extract_class(node)

    def _collect_constants(self, tree):
        counts = {}
        for stmt in tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                name = stmt.targets[0].id
                counts[name] = counts.get(name, 0) + 1
                if isinstance(stmt.value, ast.Constant) \
                        and isinstance(stmt.value.value, str):
                    self.constants[name] = stmt.value.value
        for name, n in counts.items():  # rebound names are ambiguous
            if n > 1:
                self.constants.pop(name, None)

    def _collect_imports(self, tree):
        for node in walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    self.imports[a.asname or a.name] = (node.module, a.name)

    def _extract_class(self, node):
        fsm = _FsmClass(self.module, node)
        class_sends = False
        for sub in walk(node):
            if isinstance(sub, ast.Assign) \
                    and isinstance(sub.value, ast.Call):
                cf = sub.value.func
                cname = cf.attr if isinstance(cf, ast.Attribute) else (
                    cf.id if isinstance(cf, ast.Name) else None)
                if cname is not None and cname.endswith("Controller"):
                    for tgt in sub.targets:
                        if isinstance(tgt, ast.Attribute) \
                                and isinstance(tgt.value, ast.Name) \
                                and tgt.value.id == "self":
                            fsm.controller_attrs.add(tgt.attr)
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            fname = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if fname == _REGISTER and sub.args:
                fsm.registers_any = True
                fsm.handled.append(_type_expr_ref(sub.args[0], sub))
                if len(sub.args) > 1 \
                        and isinstance(sub.args[1], ast.Attribute) \
                        and isinstance(sub.args[1].value, ast.Name) \
                        and sub.args[1].value.id == "self":
                    fsm.handler_map.append(
                        (_type_expr_ref(sub.args[0], sub),
                         sub.args[1].attr))
            elif fname in _SEND_FUNCS:
                class_sends = True
        for meth in node.body:
            if isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fsm.sent.extend(_sent_types(meth, class_sends))
                if class_sends:
                    fsm.builds.extend(_extract_builds(meth))
        return fsm


def _sent_types(func, class_sends):
    """``Message(TYPE, ...)`` constructions in ``func`` that the class
    sends. The flow judgment is class-granular, not expression-granular:
    messages routinely escape the building method (``_open_round``
    returns the sync batch, ``_send_syncs`` delivers it), so any
    construction inside a class that invokes ``send_message``/
    ``send_with_retry`` *somewhere* counts as sent -- a missed send
    would be an FL120/FL122 false verdict. A class with no send call at
    all contributes nothing."""
    if not class_sends:
        return []
    sent = []
    for node in walk(func):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        if name == "Message" and node.args:
            sent.append(_type_expr_ref(node.args[0], node))
    return sent


def _const_named_key(expr, bound):
    """True when a payload-key expression names something the constant
    index can meaningfully resolve: a bare Name not bound locally, or a
    ``Mod.CONST``-style Attribute (instance attrs -- ``self.x`` -- and
    locally bound names are runtime values, not module constants)."""
    if isinstance(expr, ast.Name):
        return expr.id not in bound
    if isinstance(expr, ast.Attribute):
        return not (isinstance(expr.value, ast.Name)
                    and (expr.value.id == "self" or expr.value.id in bound))
    return False


def _locally_bound(meth):
    """Names bound anywhere inside ``meth`` (params, assignments, loop/
    with/comprehension targets): a key NAMED by one of these is a local
    value, never the module constant of the same spelling -- resolving
    it through the constant index would be unsound (the FL115 scoping
    lesson), so such keys keep the old open/opaque disposition."""
    bound = {a.arg for a in meth.args.args}
    bound.update(a.arg for a in meth.args.kwonlyargs)
    for node in walk(meth):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            bound.add(node.id)
    return bound


def _extract_builds(meth):
    """``Message(TYPE, ...)`` build sites in one method with their
    ``add()``-ed literal keys (FL128's send-side schema). A non-literal
    key, or the message variable flowing into a call outside the benign
    sinks (delivery, tracer inject, container append), opens the schema:
    the pass then refuses to judge read-never-set for that type."""
    builds = {}       # id(Message call node) -> _MsgBuild
    var_builds = {}   # local var name -> _MsgBuild
    bound = _locally_bound(meth)
    for node in walk(meth):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        if name == "Message" and node.args:
            builds[id(node)] = _MsgBuild(_type_expr_ref(node.args[0], node))
    for node in walk(meth):
        if isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Call) \
                and id(node.value) in builds:
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    var_builds[tgt.id] = builds[id(node.value)]
    if var_builds:
        for node in walk(meth):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) \
                    and isinstance(f.value, ast.Name) \
                    and f.value.id in var_builds \
                    and f.attr in ("add", "add_params"):
                b = var_builds[f.value.id]
                if node.args and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    b.keys.setdefault(node.args[0].value, node)
                elif node.args and _const_named_key(node.args[0], bound):
                    # constant-NAMED key (msg.add(WIRE_DELTA_KEY, ...)):
                    # resolved at check time through the module-constant
                    # + import index; unresolvable names open the schema
                    b.named_keys.append(
                        _type_expr_ref(node.args[0], node))
                else:
                    b.open = True
                continue
            # escape analysis: the built message flowing into an
            # unknown call may gain keys this pass cannot see
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if name in _BENIGN_MSG_SINKS or name == "Message":
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                for sub in walk(arg):
                    if isinstance(sub, ast.Name) and sub.id in var_builds:
                        var_builds[sub.id].open = True
    return list(builds.values())


def _handler_reads(meth, resolve_helper=None, _param_idx=1, _depth=0,
                   _seen=None):
    """Literal payload reads of a handler's message parameter ->
    ``(reads {key: node}, named_reads [_TypeRef], transparent)``.
    ``named_reads`` are constant-NAMED keys (``msg.get(WIRE_DELTA_KEY)``
    / ``msg[SOME_KEY]``), resolved at check time through the module-
    constant + import index -- the compressed-report vocabulary rides
    shared constants, and treating those reads as dynamic would turn
    the whole report schema opaque.

    ``resolve_helper(name) -> methodDef|None`` lets the walk FOLLOW the
    message into same-class helpers (``self._report_payload(msg)`` --
    both servers route compressed reports through one): the helper's
    reads merge into the handler's, positionally mapped onto the
    forwarded parameter. Unresolvable helpers, non-positional forwards
    and recursion keep the old escape disposition.

    ``transparent`` is False when the handler's reads are not fully
    visible to this pass: the parameter escapes (passed to an
    un-followable call, aliased, rebound), a truly dynamic read hides
    the key (``msg.get(f())``, ``msg.get_params()`` -- the whole dict
    walks away), or the message is subscript-written (the handler
    mutates/forwards it). Set-never-read judgments are then suppressed
    for its type."""
    params = [a.arg for a in meth.args.args]
    if meth.args.vararg or meth.args.kwarg or len(params) <= _param_idx:
        return {}, [], False
    msg = params[_param_idx]
    reads, named, allowed = {}, [], set()
    bound = _locally_bound(meth)
    _seen = set() if _seen is None else _seen
    opaque = False
    for node in walk(meth):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == msg:
            if node.func.attr not in _MSG_SELF_METHODS:
                continue  # method outside the read surface: escape below
            allowed.add(id(node.func.value))
            if node.func.attr == "get":
                if node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    reads.setdefault(node.args[0].value, node)
                elif node.args and _const_named_key(node.args[0], bound):
                    named.append(_type_expr_ref(node.args[0], node))
                else:
                    opaque = True  # computed key: a read we cannot see
            elif node.func.attr in ("get_params", "to_string"):
                # the whole payload dict escapes: any key may be read
                opaque = True
        elif isinstance(node, ast.Subscript) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == msg:
            allowed.add(id(node.value))
            if not isinstance(node.ctx, ast.Load):
                opaque = True  # msg["k"] = v: mutation, not a read
            elif isinstance(node.slice, ast.Constant) \
                    and isinstance(node.slice.value, str):
                reads.setdefault(node.slice.value, node)
            elif _const_named_key(node.slice, bound):
                named.append(_type_expr_ref(node.slice, node))
            else:
                opaque = True  # msg[computed]: dynamic read
        elif (isinstance(node, ast.Call) and resolve_helper is not None
              and _depth < 4
              and isinstance(node.func, ast.Attribute)
              and isinstance(node.func.value, ast.Name)
              and node.func.value.id == "self"):
            # self._helper(.., msg, ..): follow the forward when the
            # helper resolves in this class context and msg rides a
            # plain positional slot (anything fancier stays an escape)
            pos = [i for i, a in enumerate(node.args)
                   if isinstance(a, ast.Name) and a.id == msg]
            in_kw = any(isinstance(kw.value, ast.Name)
                        and kw.value.id == msg for kw in node.keywords)
            if not pos and not in_kw:
                continue
            helper = (resolve_helper(node.func.attr)
                      if len(pos) == 1 and not in_kw else None)
            key = (node.func.attr, pos[0] if pos else -1)
            if helper is None or key in _seen:
                opaque = True
                continue
            h_reads, h_named, h_transparent = _handler_reads(
                helper, resolve_helper, _param_idx=pos[0] + 1,
                _depth=_depth + 1, _seen=_seen | {key})
            for k, n in h_reads.items():
                reads.setdefault(k, n)
            named.extend(h_named)
            if not h_transparent:
                opaque = True
            for a in node.args:
                if isinstance(a, ast.Name) and a.id == msg:
                    allowed.add(id(a))
    transparent = not opaque
    for node in walk(meth):
        # params are ast.arg nodes, so every Name here is a USE; any use
        # outside the allowed read surface (call arg, alias, rebind)
        # means the handler may read keys this pass cannot see
        if isinstance(node, ast.Name) and node.id == msg \
                and id(node) not in allowed:
            transparent = False
    return reads, named, transparent


class _ActContext:
    """FL127 act-resolution context: the *registering* class's view --
    its own plus inherited methods (helpers on the base chain act too)
    and the union of controller fields along that chain (a controller
    assigned in a subclass __init__ counts for a base-class handler
    running on that subclass's instances)."""

    __slots__ = ("controller_attrs", "methods")

    def __init__(self, controller_attrs, methods):
        self.controller_attrs = controller_attrs
        self.methods = methods


def _call_acts(node, ctx, memo):
    """Is this call an FL127 'act'? Reply, controller advance,
    termination, logging, or an own/inherited helper that acts on all
    of its own paths."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id in _SEND_FUNCS
    if not isinstance(f, ast.Attribute):
        return False
    if f.attr in _SEND_FUNCS or f.attr == "finish":
        return True
    if f.attr in _LOG_ATTRS:
        return True
    root = f.value
    if isinstance(root, ast.Name) and root.id in _LOG_ROOTS:
        return True
    if isinstance(root, ast.Attribute) and isinstance(root.value, ast.Name) \
            and root.value.id == "self" \
            and root.attr in ctx.controller_attrs:
        return True  # self._controller.<anything>(...): round advance
    if isinstance(root, ast.Name) and root.id == "self" \
            and f.attr in ctx.methods:
        return _method_acts(f.attr, ctx, memo)
    return False


def _expr_acts(expr, ctx, memo):
    if expr is None:
        return False
    for node in walk(expr):
        if isinstance(node, (ast.Lambda,)):
            continue
        if isinstance(node, ast.Call) and _call_acts(node, ctx, memo):
            return True
    return False


def _method_acts(name, ctx, memo):
    if name in memo:
        return memo[name]
    memo[name] = False  # recursion guard: cycles do not prove acting
    acts_all, exits_silent = _analyze_suite(ctx.methods[name].body, ctx,
                                            memo)
    memo[name] = acts_all and not exits_silent
    return memo[name]


def _analyze_suite(stmts, ctx, memo):
    """FL127 path analysis over one suite -> ``(acts_all,
    exits_silent)``: whether every path through the suite performs an act
    before leaving, and whether any path *returns* without one."""
    exits_silent = False
    for stmt in stmts:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        if isinstance(stmt, ast.Raise):
            return True, exits_silent  # termination is a decision
        if isinstance(stmt, ast.Return):
            acted = _expr_acts(stmt.value, ctx, memo)
            return acted, exits_silent or not acted
        if isinstance(stmt, ast.If):
            if _expr_acts(stmt.test, ctx, memo):
                return True, exits_silent
            t_acts, t_exit = _analyze_suite(stmt.body, ctx, memo)
            e_acts, e_exit = (_analyze_suite(stmt.orelse, ctx, memo)
                              if stmt.orelse else (False, False))
            exits_silent = exits_silent or t_exit or e_exit
            if t_acts and e_acts and stmt.orelse:
                return True, exits_silent
            continue
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            if any(_expr_acts(i.context_expr, ctx, memo)
                   for i in stmt.items):
                return True, exits_silent
            b_acts, b_exit = _analyze_suite(stmt.body, ctx, memo)
            exits_silent = exits_silent or b_exit
            if b_acts:
                return True, exits_silent
            continue
        if isinstance(stmt, ast.Try):
            f_acts, f_exit = _analyze_suite(stmt.finalbody, ctx, memo)
            exits_silent = exits_silent or f_exit
            if f_acts:
                return True, exits_silent
            b_acts, b_exit = _analyze_suite(stmt.body, ctx, memo)
            h_results = [_analyze_suite(h.body, ctx, memo)
                         for h in stmt.handlers]
            exits_silent = exits_silent or b_exit \
                or any(x for (_a, x) in h_results)
            if b_acts and all(a for (a, _x) in h_results):
                return True, exits_silent
            continue
        if isinstance(stmt, (ast.For, ast.While, ast.AsyncFor)):
            # the header evaluates even on the zero-iteration path: an
            # act in the iterable/test (a controller drain, a reply in
            # the condition) covers every path through the loop
            header = stmt.iter if isinstance(stmt, (ast.For, ast.AsyncFor)) \
                else stmt.test
            if _expr_acts(header, ctx, memo):
                return True, exits_silent
            # zero-iteration path: the body cannot guarantee an act
            _b_acts, b_exit = _analyze_suite(stmt.body, ctx, memo)
            exits_silent = exits_silent or b_exit
            continue
        # simple statement: any act call anywhere in it acts
        if any(isinstance(n, ast.Call)
               and _call_acts(n, ctx, memo)
               for n in walk(stmt)):
            return True, exits_silent
    return False, exits_silent


class ProtocolIndex:
    """Cross-module constant + FSM-class resolution (protocol pass 1)."""

    def __init__(self):
        self.modules = {}  # dotted module name -> _ModuleProtocol

    @staticmethod
    def module_name(path):
        rel = path.replace(os.sep, "/")
        if rel.endswith(".py"):
            rel = rel[:-3]
        return rel.strip("/").replace("/", ".")

    def add_module(self, path, tree):
        mod = self.module_name(path)
        self.modules[mod] = _ModuleProtocol(mod, tree)
        return self.modules[mod]

    def _candidates(self, src_mod):
        """Import-target module candidates: exact dotted name, or any
        indexed module whose dotted name ends with it (relative layouts,
        tmp dirs)."""
        return [src_mod] + [m for m in self.modules
                            if m == src_mod or m.endswith("." + src_mod)]

    def resolve_const(self, module, name, seen=None):
        """String value of ``name`` in ``module``, following import edges.
        None when out of static reach."""
        seen = set() if seen is None else seen
        if (module, name) in seen:
            return None
        seen.add((module, name))
        info = self.modules.get(module)
        if info is None:
            return None
        if name in info.constants:
            return info.constants[name]
        if name in info.imports:
            src_mod, src_name = info.imports[name]
            for cand in self._candidates(src_mod):
                value = self.resolve_const(cand, src_name, seen)
                if value is not None:
                    return value
        return None

    def resolve_class(self, module, name, seen=None):
        """(-> (_FsmClass, defining module) or (None, None)), following
        import edges."""
        seen = set() if seen is None else seen
        if (module, name) in seen:
            return None, None
        seen.add((module, name))
        info = self.modules.get(module)
        if info is None:
            return None, None
        if name in info.classes:
            return info.classes[name], module
        if name in info.imports:
            src_mod, src_name = info.imports[name]
            for cand in self._candidates(src_mod):
                cls, mod = self.resolve_class(cand, src_name, seen)
                if cls is not None:
                    return cls, mod
        return None, None

    def fsm_role(self, module, class_name, seen=None):
        """'server' / 'client' / 'both' when the class descends from an
        FSM root (transitively, across modules), else None."""
        seen = set() if seen is None else seen
        if (module, class_name) in seen:
            return None
        seen.add((module, class_name))
        if class_name in FSM_ROOTS:
            # the roots themselves are abstract; but a base NAMED like a
            # root makes the subclass an FSM of that role
            return FSM_ROOTS[class_name]
        cls, mod = self.resolve_class(module, class_name)
        if cls is None:
            return None
        roles = set()
        for base in cls.bases:
            if base is None:
                continue
            if base in FSM_ROOTS:
                roles.add(FSM_ROOTS[base])
                continue
            r = self.fsm_role(mod, base, seen)
            if r is not None:
                roles.add(r)
        if not roles:
            return None
        if roles == {"both"}:
            return "both"
        roles.discard("both")
        return roles.pop() if len(roles) == 1 else "both"

    def ancestors(self, module, class_name, seen=None):
        """FSM ancestor classes inside the indexed fileset (for inherited
        handler registrations)."""
        seen = set() if seen is None else seen
        out = []
        cls, mod = self.resolve_class(module, class_name)
        if cls is None or (mod, class_name) in seen:
            return out
        seen.add((mod, class_name))
        for base in cls.bases:
            if base is None or base in FSM_ROOTS:
                continue
            bcls, bmod = self.resolve_class(mod, base)
            if bcls is not None and (bmod, bcls.name) not in seen:
                out.append((bcls, bmod))
                out.extend(self.ancestors(bmod, bcls.name, seen))

        return out


def _resolved(index, module, ref):
    """Concrete string value of a _TypeRef, or None."""
    if ref.value is not None:
        return ref.value
    if ref.name is not None:
        return index.resolve_const(module, ref.name)
    return None


def _is_peer_lost(index, module, ref):
    """PEER_LOST is credited by value OR by name: the constant's defining
    module may be outside the linted fileset (single-file runs)."""
    return (ref.name == PEER_LOST_NAME
            or _resolved(index, module, ref) == PEER_LOST_VALUE)


def check_protocol(index, emit):
    """Protocol pass 2 over every module in ``index``.

    ``emit(module, node, code, message)`` receives each finding, attached
    to the module that owns the offending node.
    """
    # collect concrete FSMs with their roles and effective (own +
    # inherited) handled sets
    fsms = []  # (cls, module, role, handled_refs, registers_any)
    for mod, info in sorted(index.modules.items()):
        for cls in info.classes.values():
            role = None
            for base in cls.bases:
                if base is None:
                    continue
                if base in FSM_ROOTS:
                    role = _merge_role(role, FSM_ROOTS[base])
                else:
                    role = _merge_role(role, index.fsm_role(mod, base))
            if role is None:
                continue
            handled = list(cls.handled)
            registers = cls.registers_any
            for acls, amod in index.ancestors(mod, cls.name):
                handled.extend(acls.handled)
                registers = registers or acls.registers_any
            fsms.append((cls, mod, role, handled, registers))

    # resolve each FSM's type sets ONCE and memo them per role: the
    # counterpart queries below would otherwise re-run the import-edge
    # constant resolution O(F^2) times per lint
    handled_by_role, sent_by_role = {}, {}
    for cls, mod, r, handled, _reg in fsms:
        hs = handled_by_role.setdefault(r, set())
        for ref in handled:
            v = _resolved(index, mod, ref)
            if v is not None:
                hs.add(v)
        ss = sent_by_role.setdefault(r, set())
        for ref in cls.sent:
            v = _resolved(index, mod, ref)
            if v is not None:
                ss.add(v)

    _WANT = {"server": ("client", "both"),
             "client": ("server", "both"),
             "both": ("server", "client", "both")}

    def counterpart_handled(role):
        return set().union(*(handled_by_role.get(r, set())
                             for r in _WANT[role]))

    def counterpart_sent(role):
        return set().union(*(sent_by_role.get(r, set())
                             for r in _WANT[role]))

    for cls, mod, role, handled, registers in fsms:
        # FL121: a concrete FSM (registers at least one handler) without a
        # peer-lost handler fails fast at runtime on any mid-round death
        if registers and not any(_is_peer_lost(index, mod, ref)
                                 for ref in handled):
            emit(mod, cls.node, "FL121",
                 f"FSM `{cls.name}` registers message handlers but none "
                 f"for {PEER_LOST_NAME}: a peer dying mid-round stops the "
                 "receive loop and DistributedManager.run() raises "
                 "(core/managers.py fail-fast). Register a handler to "
                 "re-cohort or shut down deliberately")
        # FL120: sent types the counterpart role never handles
        seen_sent = set()
        peer_handles = counterpart_handled(role)
        for ref in cls.sent:
            v = _resolved(index, mod, ref)
            if v is None or v.startswith(_RESERVED_PREFIX) or v in seen_sent:
                continue
            seen_sent.add(v)
            if v not in peer_handles:
                emit(mod, ref.node, "FL120",
                     f"`{cls.name}` sends message type '{v}' but no "
                     "counterpart FSM registers a handler for it -- the "
                     "receiving manager logs-and-drops the frame and the "
                     "round hangs waiting for a reply")
        # FL122: handled types the counterpart role never sends
        seen_handled = set()
        peer_sends = counterpart_sent(role)
        for ref in handled:
            if ref not in cls.handled:
                continue  # inherited registrations report at the ancestor
            v = _resolved(index, mod, ref)
            if (v is None or v.startswith(_RESERVED_PREFIX)
                    or _is_peer_lost(index, mod, ref) or v in seen_handled):
                continue
            seen_handled.add(v)
            if v not in peer_sends:
                emit(mod, ref.node, "FL122",
                     f"`{cls.name}` registers a handler for '{v}' but no "
                     "counterpart FSM ever sends that type -- dead "
                     "protocol state (renamed constant or deleted send "
                     "path?)")

    _check_sequencing(index, fsms, emit)
    _check_payload_schema(index, fsms, emit)
    _check_payload_types(fsms, emit)


def _resolve_handler(index, cls, mod, name):
    """Handler method def + its defining (class, module): own methods
    first, then FSM ancestors inside the fileset."""
    own = {m.name: m for m in cls.node.body
           if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
    if name in own:
        return cls, mod, own[name]
    for acls, amod in index.ancestors(mod, cls.name):
        for m in acls.node.body:
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and m.name == name:
                return acls, amod, m
    return None, None, None


def _check_sequencing(index, fsms, emit):
    """FL127: every registered handler must act -- reply, advance the
    round controller, terminate, or log the decision -- on EVERY path.
    A path that silently dead-ends is a hung round waiting to happen.

    Act resolution uses the *registering* class's view: its own plus
    inherited methods, and controller fields assigned anywhere on its
    chain. A handler registered by several subclasses is reported only
    when it is silent in EVERY registering context -- a controller
    assigned in one subclass is an act on that subclass's instances."""
    by_def = {}  # (omod, owner name, hname) -> [owner, omod, meth,
    #              tref, [ctx, ...]]
    for cls, mod, _role, _handled, _reg in fsms:
        for (tref, hname) in cls.handler_map:
            owner, omod, meth = _resolve_handler(index, cls, mod, hname)
            if meth is None:
                continue  # outside the fileset: judge nothing
            methods = {}
            ctrl = set()
            for acls, _amod in ([(cls, mod)]
                                + index.ancestors(mod, cls.name)):
                ctrl |= acls.controller_attrs
                for m in acls.node.body:
                    if isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                        methods.setdefault(m.name, m)
            ent = by_def.setdefault((omod, owner.name, hname),
                                    [owner, omod, meth, tref, []])
            ent[4].append(_ActContext(ctrl, methods))
    for (owner, omod, meth, tref, ctxs) in by_def.values():
        results = [_analyze_suite(meth.body, ctx, {}) for ctx in ctxs]
        if any(acts_all and not exits_silent
               for (acts_all, exits_silent) in results):
            continue
        tname = tref.name or tref.value or "?"
        how = ("falls off the end" if not results[0][0]
               else "returns early")
        emit(omod, meth, "FL127",
             f"handler `{owner.name}.{meth.name}` (registered for "
             f"{tname}) has a path that {how} without replying, "
             "advancing the round controller, terminating, or even "
             "logging -- the counterpart FSM waits forever on that "
             "path (a silently hung round, the temporal shape of "
             "FL120). Send, advance, finish(), raise, or log the "
             "decision on every path")


def _check_payload_schema(index, fsms, emit):
    """FL128: pair handler payload reads with the counterpart role's
    ``Message.add()`` schemas for the same type."""
    _WANT = {"server": ("client", "both"),
             "client": ("server", "both"),
             "both": ("server", "client", "both")}
    # send-side schemas and read-side surfaces, resolved once per role
    schemas = {}  # role -> type -> {"keys": {k: (mod, node)}, "open": bool}
    readers = {}  # role -> type -> {"keys": {k: (mod, node)},
    #                                "opaque": bool, "n": int}
    for cls, mod, role, _handled, _reg in fsms:
        for b in cls.builds:
            t = _resolved(index, mod, b.type_ref)
            if t is None or t.startswith(_RESERVED_PREFIX):
                continue
            ent = schemas.setdefault(role, {}).setdefault(
                t, {"keys": {}, "open": False})
            for k, node in b.keys.items():
                ent["keys"].setdefault(k, (mod, node))
            for kref in b.named_keys:
                # constant-named key (WIRE_DELTA_KEY): resolved through
                # the same constant/import index as message types. Out
                # of static reach (single-file runs: the constant's
                # defining module is outside the fileset), the key is
                # credited by NAME -- the PEER_LOST precedent -- and
                # pairs against a same-named read at judgment time
                k = _resolved(index, mod, kref)
                if k is not None:
                    ent["keys"].setdefault(k, (mod, kref.node))
                elif kref.name is not None:
                    ent.setdefault("named", {}).setdefault(
                        kref.name, (mod, kref.node))
                else:
                    ent["open"] = True
            ent["open"] = ent["open"] or b.open
        for (tref, hname) in cls.handler_map:
            t = _resolved(index, mod, tref)
            if t is None or t.startswith(_RESERVED_PREFIX) \
                    or _is_peer_lost(index, mod, tref):
                continue
            ent = readers.setdefault(role, {}).setdefault(
                t, {"keys": {}, "opaque": False, "n": 0})
            ent["n"] += 1
            owner, omod, meth = _resolve_handler(index, cls, mod, hname)
            if meth is None:
                ent["opaque"] = True
                continue
            reads, named_reads, transparent = _handler_reads(
                meth, resolve_helper=lambda n, _c=cls, _m=mod:
                    _resolve_handler(index, _c, _m, n)[2])
            ent["opaque"] = ent["opaque"] or not transparent
            for k, node in reads.items():
                ent["keys"].setdefault(k, (omod, node))
            for kref in named_reads:
                k = _resolved(index, omod, kref)
                if k is not None:
                    ent["keys"].setdefault(k, (omod, kref.node))
                elif kref.name is not None:
                    ent.setdefault("named", {}).setdefault(
                        kref.name, (omod, kref.node))
                else:
                    ent["opaque"] = True

    def merged(table, role):
        out = {}
        for r in _WANT[role]:
            for t, ent in table.get(r, {}).items():
                cur = out.setdefault(t, {"keys": {}, "named": {},
                                         "open": False, "opaque": False,
                                         "n": 0})
                cur["keys"].update(ent["keys"])
                cur["named"].update(ent.get("named", {}))
                cur["open"] = cur["open"] or ent.get("open", False)
                cur["opaque"] = cur["opaque"] or ent.get("opaque", False)
                cur["n"] += ent.get("n", 0)
        return out

    emitted = set()
    for role in sorted(readers):
        peer_schema = merged(schemas, role)
        for t, ent in sorted(readers[role].items()):
            sch = peer_schema.get(t)
            if sch is None:
                continue  # nothing sends the type at all: FL120's finding
            # an UNRESOLVED named add with no same-named read could be
            # setting any key (incl. one a resolved read wants): it
            # opens the schema for this judgment; name-paired adds are
            # accounted for by their paired read
            sch_open = sch["open"] or bool(
                set(sch["named"]) - set(ent.get("named", {})))
            for k, (kmod, knode) in sorted(ent["keys"].items()):
                if k in _RESERVED_KEYS or k.startswith("__") \
                        or k in sch["keys"] or sch_open \
                        or ("r", t, k) in emitted:
                    continue
                emitted.add(("r", t, k))
                emit(kmod, knode, "FL128",
                     f"handler reads payload key '{k}' of message type "
                     f"'{t}' but no counterpart build site ever add()s "
                     "it -- msg.get() returns None and the round "
                     "corrupts silently (renamed or missing key at the "
                     "sender?)")
    for role in sorted(schemas):
        peer_reads = merged(readers, role)
        for t, ent in sorted(schemas[role].items()):
            rd = peer_reads.get(t)
            if rd is None or rd["n"] == 0:
                continue  # unhandled type (FL120) or unseeable reads
            # an UNRESOLVED named read with no same-named add may be
            # reading any key: treat the reader as opaque here
            if rd["opaque"] or bool(set(rd["named"])
                                    - set(ent.get("named", {}))):
                continue
            for k, (kmod, knode) in sorted(ent["keys"].items()):
                if k in _RESERVED_KEYS or k.startswith("__") \
                        or k in rd["keys"] or ("s", t, k) in emitted:
                    continue
                emitted.add(("s", t, k))
                emit(kmod, knode, "FL128",
                     f"payload key '{k}' of message type '{t}' is set "
                     "here but no counterpart handler ever reads it -- "
                     "dead wire bytes in every frame (and a likely "
                     "renamed key: the reader's half may be the FL128 "
                     "read-never-set finding next to this one)")


#: value-expression kinds the wire codec's frame grammar provably cannot
#: carry. The grammar (compression/codec.py `_extract`): ndarray/duck-
#: array leaves go binary, dict/list/tuple recurse, JSON scalars pass
#: through -- a set never JSON-serializes, bytes only travel framed as
#: arrays, and a callable is never data.
_UNFRAMABLE_CALLS = {"set", "frozenset", "bytearray", "memoryview"}


def _unframable_kind(expr):
    """Human-readable kind when ``expr`` is provably outside the codec
    frame grammar, else None. Judgment is literal-only by design: a
    call result or a name may well be a framable dict/array, so only
    displays whose runtime type is certain are flagged."""
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return "a set"
    if isinstance(expr, ast.GeneratorExp):
        return "a generator"
    if isinstance(expr, ast.Lambda):
        return "a lambda"
    if isinstance(expr, ast.Constant) and isinstance(expr.value,
                                                     (bytes, bytearray)):
        return "a bytes literal"
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name) \
            and expr.func.id in _UNFRAMABLE_CALLS:
        return f"a {expr.func.id}()"
    return None


def _check_payload_types(fsms, emit):
    """FL128 (type half): every ``add(key, value)`` value expression is
    checked against the codec frame grammar -- the schema half above
    pairs *keys* across the wire; this half rejects *values* that can
    never cross it at all."""
    seen = set()
    for cls, mod, _role, _handled, _reg in fsms:
        for b in cls.builds:
            nodes = list(b.keys.items())
            nodes += [(kref.name, kref.node) for kref in b.named_keys]
            for key, node in nodes:
                if len(node.args) < 2 or id(node) in seen:
                    continue
                kind = _unframable_kind(node.args[1])
                if kind is None:
                    continue
                seen.add(id(node))
                label = f"'{key}'" if key is not None else "<computed>"
                emit(mod, node, "FL128",
                     f"payload key {label} is assigned {kind} -- outside "
                     "the wire codec's frame grammar (framable: ndarray/"
                     "duck-array leaves, dict/list/tuple containers, "
                     "JSON scalars). encode_tree/to_json raises at send "
                     "time on the first real frame; carry a sorted list "
                     "or a framed array instead")


def _merge_role(a, b):
    if b is None:
        return a
    if a is None or a == b:
        return b
    return "both"


__all__ = ["ProtocolIndex", "check_protocol", "FSM_ROOTS",
           "PEER_LOST_NAME", "PEER_LOST_VALUE"]
