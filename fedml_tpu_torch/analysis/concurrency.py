"""fedcheck concurrency pass: thread-safety rules for the port's control
plane (framework-neutral: the same rules as the reference's
``fedml_tpu/analysis/concurrency.py``, over the port's paths).

The threaded half of the framework (transports, round controller, resilient
FSMs) shares instance state between the *main* thread and *handler* threads
(transport serve loops, deadline timers, registered message handlers). A
missed lock there is a flaky chaos run, not a test failure. Everything this
pass checks is decidable from one class's AST:

**Thread classification.** A method is *handler-reachable* when it is a
root -- its bound method ``self.m`` escapes as a call argument (handler
registration, ``Thread(target=...)``, timer factories, controller
callbacks: an escaped bound method may run on any thread), or it is a
transport entry by protocol convention (``receive_message``,
``handle_receive_message``) -- or when a root reaches it through
``self.x()`` calls. Everything else is main-thread.

**Lock model.** Lock *families* are instance attributes assigned from a
lock constructor (``threading.Lock/RLock``, or the declared factories in
``fedml_tpu_torch.analysis.locks``: ``audited_lock``/``audited_rlock`` =
state locks, ``io_lock`` = dedicated I/O serialization locks). A ``with``
over a family member guards its body; a method whose every internal call
site holds a lock is analyzed as holding it too (the ``*_locked`` helper idiom
-- applied to underscore-named, non-escaped methods only, since public
methods may be entered externally without the lock). Classes that create
no locks are out of scope: they have declared no concurrency contract for
this pass to verify (benign racy flags on lock-free classes stay legal).

Rules:

- **FL123** -- an instance attribute that the class elsewhere guards with a
  state lock is accessed without it on a path involving handler threads
  (or, with no owning lock at all, is read-modified-written ``+=`` on a
  handler-reachable path -- concurrent handlers lose updates).
- **FL124** -- lock-order cycle: two (or more) lock families acquired in
  nested ``with`` blocks in opposite orders somewhere in the class --
  a deadlock waiting for the right interleaving.
- **FL125** -- a blocking call (frame send/recv, ``sendall``, ``join``,
  ``sleep``, ``send_message``, ``send_with_retry``...) while holding a
  *state* lock: one wedged peer pins every thread that needs the lock.
  Dedicated ``io_lock`` families are exempt -- serializing one pipe's
  blocking writes is their purpose.
- **FL129** -- event-loop readiness (:func:`check_eventloop`): a blocking
  call reachable from an *event-loop callback* (a bound method registered
  as selector/asyncio callback data, or any coroutine) -- the
  single-thread analog of FL125: where a held lock pins the threads that
  need it, a blocked loop callback pins EVERY connection the loop
  multiplexes. Selector-ready non-blocking I/O (``recv_into``,
  ``accept``, ``connect_ex``, ``send``) is the loop's correct form and
  deliberately not in this rule's blocking set; bare ``recv``,
  ``sendall``, joins, sleeps, and the transport-level send entry points
  are never legal on a loop thread.
- **FL136** -- FL129's write-path complement, the two loop-callback
  hazards that block *nothing* yet still take the transport down: a
  ``while`` loop that makes no calls and cannot make progress locally
  (no name in its test is assigned in its body) spins the loop thread
  at 100% polling cross-thread state; a buffer append/extend/``+=``
  growth whose attribute no Compare or ``len()`` check anywhere in the
  class bounds lets one slow peer absorb the process heap. The eventloop
  transport's ``tx_bytes``/``high_watermark`` pair with a congestion
  gate is the reference shape (``fedml_tpu_torch/net/eventloop.py``); a
  growth site whose attribute shares a name-prefix with any checked
  attribute (``tx``/``tx_bytes``) counts as bounded.
"""

from __future__ import annotations

import ast

from fedml_tpu_torch.analysis.astwalk import walk

#: Constructor names (last dotted segment) that create a lock, by kind.
_STATE_CTORS = {"Lock", "RLock", "audited_lock", "audited_rlock"}
_IO_CTORS = {"io_lock"}

#: Attribute calls that block the calling thread (socket/file/thread
#: waits and transport sends). Deliberately excludes ``get``/``put``/
#: ``wait`` -- too many non-blocking dict/event idioms share the names.
_BLOCKING_ATTRS = {"sendall", "recv", "recv_into", "accept", "connect",
                   "join", "sleep", "send_message", "publish",
                   "handle_receive_message", "loop_forever"}
#: Bare-name calls that block (this repo's frame helpers + retry send).
_BLOCKING_NAMES = {"_send_frame", "_recv_frame", "send_with_retry"}

#: Methods that transports enter from their receive machinery, treated as
#: handler-thread roots by protocol convention.
_NAMED_ROOTS = {"receive_message", "handle_receive_message"}

#: FL129: calls that block the calling thread inside an event-loop
#: callback/coroutine. A deliberate subset of the FL125 tables:
#: ``recv_into``/``accept``/``connect`` are absent because on a
#: selector-ready non-blocking socket they ARE the loop's correct form;
#: everything here blocks (or dispatches into arbitrary handler code)
#: regardless of socket mode.
_EVENTLOOP_BLOCKING_ATTRS = {"sendall", "recv", "join", "sleep",
                             "send_message", "publish", "loop_forever",
                             "handle_receive_message"}
_EVENTLOOP_BLOCKING_NAMES = {"_send_frame", "_recv_frame",
                             "send_with_retry"}
#: Calls whose callable arguments become loop-callback roots: selector
#: registration (``selectors`` protocol) and asyncio's schedulers.
_LOOP_REGISTER_ATTRS = {"register", "modify", "add_reader", "add_writer",
                        "call_soon", "call_soon_threadsafe", "call_later",
                        "call_at"}
#: Constructors whose callable arguments become decode-worker roots
#: (``net/ingest.py DecodeStage``): a decode callback runs on a shard
#: worker that serves EVERY peer hashed to it -- one blocked decode
#: stalls the shard exactly like a blocked loop callback stalls the
#: loop, so the callback is held to the same FL129 grammar.
_DECODE_STAGE_CTORS = {"DecodeStage"}

#: Public aliases: the cross-class pass (FL126, ``crossclass.py``)
#: shares this pass's vocabulary -- lock-constructor classification and
#: the blocking-call tables -- so the two generations can never disagree
#: about what blocks or what is a state lock.
STATE_CTORS = _STATE_CTORS
IO_CTORS = _IO_CTORS
BLOCKING_ATTRS = _BLOCKING_ATTRS
BLOCKING_NAMES = _BLOCKING_NAMES
NAMED_ROOTS = _NAMED_ROOTS


class _Access:
    __slots__ = ("method", "attr", "kind", "held", "node")

    def __init__(self, method, attr, kind, held, node):
        self.method = method
        self.attr = attr
        self.kind = kind        # "load" | "store" | "aug"
        self.held = held        # frozenset of lock family names
        self.node = node


def check_concurrency(tree, add):
    """Run FL123/FL124/FL125 over every class in ``tree``; findings go to
    ``add(node, code, message)`` (the module linter's collector)."""
    for node in walk(tree):
        if isinstance(node, ast.ClassDef):
            _ClassChecker(node, add).run()


class _ClassChecker:
    def __init__(self, cls, add):
        self.cls = cls
        self.add = add
        self.methods = {m.name: m for m in cls.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))}
        self.families = {}        # attr name -> "state" | "io"
        self.accesses = []        # [_Access]
        self.blocking = []        # (method, label, held, node)
        self.calls = []           # (caller, callee, held-at-site)
        self.edges = []           # (held family, acquired family, method, node)
        self.acquires = []        # every with-acquisition: (family, method, node)
        self.escaped = set()      # methods whose bound form escapes
        self._locals = {}         # per-method: local name -> family

    # -- lock family discovery -------------------------------------------
    def _collect_families(self):
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
                    if attr is not None:
                        self.families[attr] = kind

    def _state_families(self):
        return {f for f, k in self.families.items() if k == "state"}

    # -- per-method walk ---------------------------------------------------
    def run(self):
        self._collect_families()
        if not self.families:
            return  # no locks: no declared concurrency contract to check
        for name, fn in self.methods.items():
            self._locals = self._lock_aliases(fn)
            self._visit_stmts(fn.body, name, frozenset())
        self._apply_held_propagation()
        self._check_fl123()
        self._check_fl124()
        self._check_fl125()

    def _lock_aliases(self, fn):
        """Local names bound (anywhere in the method) from a lock-family
        expression: ``slock = self._send_locks.get(r)``,
        ``slocks = dict(self._send_locks)``."""
        out = {}
        for node in walk(fn):
            if isinstance(node, ast.Assign):
                fam = self._expr_family(node.value)
                if fam is None:
                    continue
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        out[tgt.id] = fam
        return out

    def _expr_family(self, expr):
        for node in walk(expr):
            attr = _self_attr(node)
            if attr is not None and attr in self.families:
                return attr
            if isinstance(node, ast.Name) and node.id in self._locals:
                return self._locals[node.id]
        return None

    def _visit_stmts(self, stmts, method, held):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested scopes run on unknowable threads: skip
            if isinstance(stmt, ast.With):
                new = held
                for item in stmt.items:
                    fam = self._expr_family(item.context_expr)
                    self._scan_expr(item.context_expr, method, held)
                    if fam is not None:
                        self.acquires.append((fam, method, stmt))
                        for h in new:
                            if h != fam:
                                self.edges.append((h, fam, method, stmt))
                        new = new | {fam}
                self._visit_stmts(stmt.body, method, new)
                continue
            if isinstance(stmt, ast.AugAssign):
                attr = _self_attr(stmt.target)
                if attr is not None and attr not in self.families:
                    self.accesses.append(_Access(method, attr, "aug",
                                                 held, stmt))
                elif isinstance(stmt.target, ast.Subscript):
                    self._scan_expr(stmt.target.value, method, held)
                self._scan_expr(stmt.value, method, held)
                continue
            # headers evaluated at this statement's point
            for h in _header_exprs(stmt):
                self._scan_expr(h, method, held)
            for attr_name in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, attr_name, None)
                if isinstance(sub, list):
                    self._visit_stmts(sub, method, held)
            for handler in getattr(stmt, "handlers", ()):
                self._visit_stmts(handler.body, method, held)

    def _scan_expr(self, expr, method, held):
        if expr is None:
            return
        consumed = set()  # attribute nodes handled by the Call branch

        def visit(node):
            if isinstance(node, (ast.Lambda, ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                return  # deferred bodies run later, locks not held
            if isinstance(node, ast.Call):
                f = node.func
                sattr = _self_attr(f)
                if sattr is not None and sattr in self.methods:
                    consumed.add(id(f))
                    self.calls.append((method, sattr, held))
                elif isinstance(f, ast.Attribute) \
                        and f.attr in _BLOCKING_ATTRS:
                    self.blocking.append((method, f.attr, held, node))
                elif isinstance(f, ast.Name) and f.id in _BLOCKING_NAMES:
                    self.blocking.append((method, f.id, held, node))
            attr = _self_attr(node)
            if attr is not None and id(node) not in consumed:
                if attr in self.methods:
                    self.escaped.add(attr)  # bound method escaping
                elif attr not in self.families:
                    kind = ("store" if isinstance(
                        node.ctx, (ast.Store, ast.Del)) else "load")
                    self.accesses.append(_Access(method, attr, kind,
                                                 held, node))
                return  # don't descend into `self`
            for child in ast.iter_child_nodes(node):
                visit(child)

        visit(expr)

    # -- reachability + lock-held propagation ------------------------------
    def _roots(self):
        return (self.escaped | (_NAMED_ROOTS & set(self.methods)))

    def _reachable(self):
        reach = set(self._roots())
        frontier = list(reach)
        graph = {}
        for caller, callee, _held in self.calls:
            graph.setdefault(caller, set()).add(callee)
        while frontier:
            m = frontier.pop()
            for callee in graph.get(m, ()):
                if callee not in reach:
                    reach.add(callee)
                    frontier.append(callee)
        return reach

    def _apply_held_propagation(self):
        """The ``*_locked`` helper idiom: a private, non-escaped method
        whose *every* internal call site holds lock L is analyzed as
        holding L -- callers take the lock, the helper mutates."""
        base = {m: frozenset() for m in self.methods}
        sites = {}
        for caller, callee, held in self.calls:
            sites.setdefault(callee, []).append((caller, held))
        for _ in range(len(self.methods)):
            changed = False
            for m in self.methods:
                if not m.startswith("_") or m in self._roots() \
                        or m == "__init__" or m not in sites:
                    continue
                eff = None
                for caller, held in sites[m]:
                    h = held | base.get(caller, frozenset())
                    eff = h if eff is None else (eff & h)
                eff = frozenset(eff or ())
                if eff != base[m]:
                    base[m] = eff
                    changed = True
            if not changed:
                break
        self._base_held = base
        for a in self.accesses:
            a.held = a.held | base.get(a.method, frozenset())
        self.blocking = [(m, label, held | base.get(m, frozenset()), node)
                         for (m, label, held, node) in self.blocking]
        # propagated holds also create order edges: a helper acquiring F
        # while its callers hold H
        extra = []
        for (fam, m, node) in self.acquires:
            for h in base.get(m, ()):
                if h != fam:
                    extra.append((h, fam, m, node))
        self.edges.extend(extra)

    # -- rules -------------------------------------------------------------
    def _check_fl123(self):
        state = self._state_families()
        reachable = self._reachable()
        by_attr = {}
        for a in self.accesses:
            by_attr.setdefault(a.attr, []).append(a)
        for attr in sorted(by_attr):
            accs = by_attr[attr]
            owned = set()
            for a in accs:
                owned |= (set(a.held) & state)
            writes = [a for a in accs if a.kind in ("store", "aug")
                      and a.method != "__init__"]
            handler_write = any(a.method in reachable for a in writes)
            stored_outside_init = bool(writes)
            if owned:
                for a in sorted(accs, key=lambda a: a.node.lineno):
                    if a.method == "__init__" or set(a.held) & owned:
                        continue
                    involved = handler_write or a.method in reachable
                    if not involved:
                        continue
                    if a.kind == "load" and not stored_outside_init:
                        continue  # reference set once in __init__: stable
                    lock = "/".join(f"self.{f}" for f in sorted(owned))
                    self.add(a.node, "FL123",
                             f"`self.{attr}` is guarded by `{lock}` "
                             "elsewhere in this class but "
                             f"{'written' if a.kind != 'load' else 'read'} "
                             f"here in `{a.method}` without it -- handler "
                             "threads race this access (data race / torn "
                             "state)")
                    break
            else:
                for a in sorted(accs, key=lambda a: a.node.lineno):
                    if a.kind == "aug" and a.method in reachable \
                            and a.method != "__init__" \
                            and not (set(a.held) & state):
                        self.add(a.node, "FL123",
                                 f"read-modify-write of `self.{attr}` on "
                                 f"the handler-thread path `{a.method}` "
                                 "without a lock -- concurrent handler "
                                 "threads lose updates; guard the counter "
                                 "with a state lock")
                        break

    def _check_fl124(self):
        nodes_for = {}
        for (h, f, _m, node) in self.edges:
            nodes_for.setdefault((h, f), node)
        for cycle in find_lock_cycles((h, f) for (h, f, _m, _n)
                                      in self.edges):
            node = nodes_for[(cycle[-1], cycle[0])]
            order = " -> ".join(f"self.{x}" for x in cycle + [cycle[0]])
            self.add(node, "FL124",
                     f"lock-order cycle: {order} -- these locks are "
                     "acquired in opposite orders on different paths; "
                     "the right thread interleaving deadlocks both")

    def _check_fl125(self):
        state = self._state_families()
        for (method, label, held, node) in self.blocking:
            held_state = sorted(set(held) & state)
            if not held_state:
                continue
            locks = ", ".join(f"self.{f}" for f in held_state)
            self.add(node, "FL125",
                     f"blocking call `{label}` while holding state lock "
                     f"{locks} -- one wedged peer (full send buffer, dead "
                     "socket) pins every thread needing the lock. Release "
                     "it first, or serialize the I/O with a dedicated "
                     "`io_lock()` (fedml_tpu_torch.analysis.locks)")


def check_eventloop(tree, add):
    """FL129: event-loop readiness. Roots are (a) bound methods whose
    ``self.m`` reference appears among the arguments of a selector/
    asyncio registration call (``register``/``modify``/``add_reader``/
    ``call_soon``/... -- including inside tuple callback data), and (b)
    every coroutine (``async def``). The per-class ``self.m()`` call
    closure from those roots must be free of blocking calls: the loop
    thread serves every multiplexed connection, so one blocked callback
    is a whole-transport stall -- FL125's hazard without needing a lock.
    Findings go to ``add(node, code, message)``."""
    class_methods = set()  # async METHODS are _EventLoopChecker roots --
    # the free-coroutine branch below must not double-report them
    for node in walk(tree):
        if isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, ast.AsyncFunctionDef):
                    class_methods.add(id(m))
    for node in walk(tree):
        if isinstance(node, ast.ClassDef):
            _EventLoopChecker(node, add).run()
        elif isinstance(node, ast.AsyncFunctionDef) \
                and id(node) not in class_methods:
            # free coroutines: direct-body check (no self-closure)
            for label, call in _blocking_calls(node):
                add(call, "FL129",
                    f"blocking call `{label}` inside coroutine "
                    f"`{node.name}` -- an awaiting event loop cannot run "
                    "any other task while this blocks; use the loop's "
                    "non-blocking primitives or hand the work to a "
                    "dispatcher thread")


def _blocking_calls(fn):
    """(label, Call node) for every FL129-blocking call in ``fn``'s body,
    excluding nested function/class scopes (they run on other threads)."""
    out = []

    def visit(node):
        if isinstance(node, (ast.Lambda, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.ClassDef)):
            return
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) \
                    and f.attr in _EVENTLOOP_BLOCKING_ATTRS:
                out.append((f.attr, node))
            elif isinstance(f, ast.Name) \
                    and f.id in _EVENTLOOP_BLOCKING_NAMES:
                out.append((f.id, node))
        for child in ast.iter_child_nodes(node):
            visit(child)

    for stmt in fn.body:
        visit(stmt)
    return out


class _EventLoopChecker:
    """Per-class FL129: loop-callback roots + self-call closure."""

    def __init__(self, cls, add):
        self.cls = cls
        self.add = add
        self.methods = {m.name: m for m in cls.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))}

    def _roots(self):
        roots = {name for name, fn in self.methods.items()
                 if isinstance(fn, ast.AsyncFunctionDef)}
        for fn in self.methods.values():
            for node in walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                is_sink = (isinstance(f, ast.Attribute)
                           and f.attr in _LOOP_REGISTER_ATTRS)
                if not is_sink:
                    # decode-stage construction: DecodeStage(n, self.m,
                    # out) roots `m` -- the method runs on shard workers
                    last = (f.id if isinstance(f, ast.Name) else
                            f.attr if isinstance(f, ast.Attribute)
                            else None)
                    is_sink = last in _DECODE_STAGE_CTORS
                if not is_sink:
                    continue
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    for sub in walk(arg):
                        attr = _self_attr(sub)
                        if attr is not None and attr in self.methods:
                            roots.add(attr)
        return roots

    def run(self):
        roots = self._roots()
        if not roots:
            return
        graph = {}
        for name, fn in self.methods.items():
            callees = set()
            for node in walk(fn):
                if isinstance(node, ast.Call):
                    attr = _self_attr(node.func)
                    if attr is not None and attr in self.methods:
                        callees.add(attr)
            graph[name] = callees
        reach, frontier = set(roots), list(roots)
        while frontier:
            m = frontier.pop()
            for callee in graph.get(m, ()):
                if callee not in reach:
                    reach.add(callee)
                    frontier.append(callee)
        for name in sorted(reach):
            for label, call in _blocking_calls(self.methods[name]):
                via = ("" if name in roots else
                       " (reached from a registered callback)")
                self.add(call, "FL129",
                         f"blocking call `{label}` in event-loop callback "
                         f"path `{self.cls.name}.{name}`{via} -- the loop "
                         "thread serves EVERY multiplexed connection, so "
                         "one blocked callback stalls the whole "
                         "transport. Use non-blocking socket ops "
                         "(recv_into/send on a ready fd) or queue the "
                         "work to the dispatcher thread")
        # FL136: the write-path complement -- hazards that never block
        # yet still take the loop down
        checked = _checked_attrs(self.cls)
        for name in sorted(reach):
            for loop in _busy_loops(self.methods[name]):
                self.add(loop, "FL136",
                         f"busy loop in event-loop callback path "
                         f"`{self.cls.name}.{name}` -- the body makes no "
                         "calls and no name in the test is assigned in "
                         "the body, so the loop spins the loop thread at "
                         "100% polling state only another thread can "
                         "change. Wait on the selector (register the "
                         "condition as an event) or queue the work to "
                         "the dispatcher thread")
            for attr, site in _growth_sites(self.methods[name]):
                if any(c.startswith(attr) or attr.startswith(c)
                       for c in checked):
                    continue
                self.add(site, "FL136",
                         f"unbounded growth of `.{attr}` in event-loop "
                         f"callback path `{self.cls.name}.{name}` -- "
                         "nothing in the class compares its length or a "
                         "byte counter against a bound, so one slow peer "
                         "grows the buffer without limit. Pair the "
                         "buffer with a watermark check and a congestion "
                         "gate (the eventloop transport's tx_bytes/"
                         "high_watermark shape)")


def _scoped_walk(fn):
    """Every node in ``fn``'s body, excluding nested function/class
    scopes (they run on other threads)."""

    def visit(node):
        if isinstance(node, (ast.Lambda, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.ClassDef)):
            return
        yield node
        for child in ast.iter_child_nodes(node):
            yield from visit(child)

    for stmt in fn.body:
        yield from visit(stmt)


def _busy_loops(fn):
    """FL136 shape 1: While loops that make no calls and cannot make
    progress locally -- no name read in the test is assigned in the
    body, so the loop is waiting on cross-thread state with pure
    spinning (a flag poll, a `while True: pass`)."""
    out = []
    for node in _scoped_walk(fn):
        if not isinstance(node, ast.While):
            continue
        # a call in the TEST is progress too: `while sock.recv_into(b):
        # pass` is the loop's canonical drain shape, not a spin
        body_nodes = [n for stmt in node.body for n in walk(stmt)]
        body_nodes += list(walk(node.test))
        if any(isinstance(n, (ast.Call, ast.Await, ast.Yield,
                              ast.YieldFrom)) for n in body_nodes):
            continue
        test_names = {n.id for n in walk(node.test)
                      if isinstance(n, ast.Name)}
        assigned = set()
        for n in body_nodes:
            if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                tgts = (n.targets if isinstance(n, ast.Assign)
                        else [n.target])
                for t in tgts:
                    for sub in walk(t):
                        if isinstance(sub, ast.Name):
                            assigned.add(sub.id)
        if not (test_names & assigned):
            out.append(node)
    return out


def _growth_sites(fn):
    """FL136 shape 2 candidates: (attr name, node) for buffer growth in
    ``fn`` -- ``X.attr.append/extend/appendleft(...)`` and
    ``X.attr += <non-constant>`` (constant ``+= 1`` counters are not
    growth; data-sized increments are). Only depth-1 receivers
    (``self.buf`` / ``conn.tx``) are this class's to bound: a nested
    object's buffer (``self._window.deferred``) is its own class's
    responsibility, and the cross-class pass follows those chains."""
    out = []

    def depth1(attr_node):
        return isinstance(attr_node, ast.Attribute) \
            and isinstance(attr_node.value, ast.Name)

    for node in _scoped_walk(fn):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("append", "extend", "appendleft") \
                and depth1(node.func.value):
            out.append((node.func.value.attr, node))
        elif isinstance(node, ast.AugAssign) \
                and isinstance(node.op, ast.Add) \
                and depth1(node.target) \
                and not isinstance(node.value, ast.Constant):
            out.append((node.target.attr, node))
    return out


def _checked_attrs(cls):
    """Attribute names the class compares against a bound anywhere: the
    attrs inside any Compare's operands, plus the receivers of ``len()``
    calls. A growth site whose attr shares a name-prefix with one of
    these is bounded (``tx`` grows, ``tx_bytes`` is compared)."""
    out = set()
    for node in walk(cls):
        if isinstance(node, ast.Compare):
            for side in [node.left] + list(node.comparators):
                for sub in walk(side):
                    if isinstance(sub, ast.Attribute):
                        out.add(sub.attr)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "len" and node.args:
            for sub in walk(node.args[0]):
                if isinstance(sub, ast.Attribute):
                    out.add(sub.attr)
    return out


def find_lock_cycles(edges):
    """Unique cycles in a directed acquisition-order edge set, deduped by
    node set; each returned as ``[n1, ..., nk]`` (closing edge
    ``nk -> n1``). Shared by the static FL124 check and the runtime race
    auditor (``analysis.runtime.RaceAuditor``), so the two halves can
    never drift."""
    graph = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    out, seen = [], set()

    def dfs(start, cur, path):
        for nxt in sorted(graph.get(cur, ())):
            if nxt == start:
                key = frozenset(path)
                if key not in seen:
                    seen.add(key)
                    out.append(list(path))
            elif nxt not in path:
                dfs(start, nxt, path + [nxt])

    for start in sorted(graph):
        dfs(start, start, [start])
    return out


def _ctor_kind(func):
    name = func.attr if isinstance(func, ast.Attribute) else (
        func.id if isinstance(func, ast.Name) else None)
    if name in _STATE_CTORS:
        return "state"
    if name in _IO_CTORS:
        return "io"
    return None


def _self_attr(node):
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _header_exprs(stmt):
    """Expressions of a statement evaluated at its own sequence point
    (compound bodies recurse separately)."""
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter, stmt.target]
    if isinstance(stmt, ast.Try):
        return []
    if isinstance(stmt, ast.Return):
        return [stmt.value] if stmt.value is not None else []
    if isinstance(stmt, ast.Expr):
        return [stmt.value]
    if isinstance(stmt, ast.Assign):
        return [stmt.value] + list(stmt.targets)
    if isinstance(stmt, ast.AnnAssign):
        return [e for e in (stmt.value, stmt.target) if e is not None]
    if isinstance(stmt, ast.Delete):
        return list(stmt.targets)
    if isinstance(stmt, (ast.Assert,)):
        return [stmt.test]
    if isinstance(stmt, ast.Raise):
        return [e for e in (stmt.exc, stmt.cause) if e is not None]
    return []


__all__ = ["check_concurrency", "check_eventloop", "find_lock_cycles",
           "STATE_CTORS", "IO_CTORS", "BLOCKING_ATTRS", "BLOCKING_NAMES",
           "NAMED_ROOTS"]
