"""fedmc: bounded model checking of the distributed control plane (the
port's copy of ``fedml_tpu/analysis/modelcheck.py``, framework-neutral;
:func:`trace_to_fault_plan` builds the port's ``resilience.faults``
plans).

The rule-based protocol passes (FL120 sent-but-unhandled, FL127
silent-hang handlers) judge one handler at a time.  This pass compiles
the FSM classes ``protocol.py`` already extracts into abstract
transition systems, composes server x N clients (and the two- and
three-tier EdgeAggregator topologies -- the relay stacked under
itself is the edges-of-edges process tree) over a lossy, reordering
channel with a bounded fault budget, and explores the composed state
space with an explicit-state BFS -- so *temporal* failures (a round that
can never
reach a decision under a particular drop+rejoin interleaving, a
message arriving in a state with no progress path) surface before the
fan-in tree becomes processes.

Per-role abstract state
    server : round phase {OPEN, DONE, FAILED} x folded-report set x
             alive peer set
    client : {IDLE, DONE, DEAD} x revived flag
    channel: multiset of in-flight (type, src, dst) frames -- delivery
             order is nondeterministic, so reordering needs no
             dedicated fault transition

Handler compilation (may-semantics)
    Each registered handler is summarized by walking its body plus the
    transitively reachable own/inherited ``self.*()`` helpers:
    ``sends`` (Message builds), ``advances`` (a call through a
    ``*Controller`` field, any non-logging ``self.<attr>.m()``
    delegation, or a one-level local alias of one), ``terminates``
    (``finish()`` / ``raise``).  A handler none of whose paths does any
    of these is *inert* -- delivery consumes the frame and changes
    nothing.  An unresolvable handler method is assumed to advance
    (optimistic: the checker only ever judges code it can see).

Fault vocabulary (same as resilience/faults.py)
    drop, duplicate, reorder (implicit), kill -> PEER_LOST injection,
    rejoin -> PEER_JOIN injection.  Each faulted run sets a
    ``fault_occurred`` flag; deadline/timer transitions are enabled
    only once that flag is up, so the *fair* fragment (no faults) must
    reach a round decision by pure message exchange -- that is FL141.
    Drops are only injected against servers with *deadline evidence*
    (a controller field, a ``*deadline``/``*timer``/``*timeout``
    method, or a ``*Controller`` import in the module): a minimal FSM
    with no recovery machinery is verified on the reliable-channel
    fragment only, otherwise every toy protocol would "deadlock" under
    message loss and drown the signal.  Rejoin faults are only
    injected when the composition speaks the rejoin vocabulary at all
    (someone references MSG_TYPE_PEER_JOIN).

Properties (each a catalog rule, SARIF tag ``fedcheck-model``)
    FL140  deadlock -- a reachable undecided state with no enabled
           transition (faulted run)
    FL141  round-decision liveness -- the fault-free path must reach
           complete/degraded/abandoned (whole-protocol FL127)
    FL142  state-sensitive unhandled send -- a frame that can arrive,
           while the round is undecided, at a live peer whose
           registered handler is inert (temporal FL120)
    FL143  rejoin safety -- PEER_JOIN after a shed cannot strand a
           rank outside every future cohort

Counterexamples render as message-sequence traces.  Soundness limits:
branch conditions are abstracted optimistically, one round is
modeled, the fault budget and state count are bounded -- a clean
verdict means "no counterexample within the budget", never a proof.
"""

import ast
import re
from collections import Counter, deque

from fedml_tpu_torch.analysis.astwalk import walk
from fedml_tpu_torch.analysis.protocol import (
    FSM_ROOTS, PEER_LOST_NAME, PEER_LOST_VALUE, _RESERVED_PREFIX,
    _SEND_FUNCS, _LOG_ATTRS, _LOG_ROOTS, _merge_role, _resolved,
    _resolve_handler, _type_expr_ref)

PEER_JOIN_NAME = "MSG_TYPE_PEER_JOIN"
PEER_JOIN_VALUE = "__peer_join__"

#: method-name fragments that count as deadline evidence
_DEADLINE_FRAGMENTS = ("deadline", "timer", "timeout")

# exploration bounds: BFS abandons a composition (silently: bounded
# checking promises nothing beyond its budget) past these.  Measured
# full-exploration sizes under the widened default FaultBudget
# (drops=1, dups=1, kills=2, joins=1 for pairs; the two-tier default
# adds an edge-tier kill transition): pair ~= 16.2k states, two-tier
# ~= 43.4k, three-tier ~= 191k -- each cap keeps roughly 2x headroom
# over the measured frontier so a capped result signals a genuinely
# new state-space blowup, not the standing budget.
MAX_STATES_PAIR = 40000
MAX_STATES_TIER = 90000
MAX_STATES_TREE = 400000
MAX_DEPTH = 80
MAX_CHANNEL = 7
MAX_COMPOSITIONS = 16
_TRACE_CAP = 14

SERVER = -1  # src/dst id of the server / coordinator end

# server round phases
OPEN, DONE, FAILED = 0, 1, 2
# client phases
IDLE, CDONE, DEAD = 0, 1, 2
# edge phases (two-tier)
E_OPEN, E_REPORTED, E_ABANDONED = 0, 1, 2


class HandlerSpec:
    """Abstract effect summary of one registered handler."""

    __slots__ = ("name", "sends", "advances", "terminates", "node")

    def __init__(self, name, sends, advances, terminates, node):
        self.name = name
        self.sends = sends          # frozenset of resolved reply types
        self.advances = advances
        self.terminates = terminates
        self.node = node            # report-at node (def or registration)

    @property
    def inert(self):
        return not self.sends and not self.advances and not self.terminates


class RoleSpec:
    """One concrete FSM class compiled for composition."""

    __slots__ = ("cls", "module", "role", "name", "handlers", "class_sent",
                 "companion_sent", "has_deadline", "handles_join",
                 "join_vocab", "node")

    def __init__(self, cls, module, role):
        self.cls = cls
        self.module = module
        self.role = role
        self.name = cls.name
        self.handlers = {}       # resolved type value -> HandlerSpec
        self.class_sent = set()  # resolved non-reserved sent types (chain)
        self.companion_sent = set()  # same-module role-None senders
        self.has_deadline = False
        self.handles_join = False
        self.join_vocab = False  # module references MSG_TYPE_PEER_JOIN
        self.node = cls.node

    def sendable(self):
        return self.class_sent | self.companion_sent


def _alias_map(meth):
    """One-level local aliases of self attributes: ``ctrl = self._c``."""
    out = {}
    for node in walk(meth):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Attribute) \
                and isinstance(node.value.value, ast.Name) \
                and node.value.value.id == "self":
            out[node.targets[0].id] = node.value.attr
    return out


def _attr_root(expr):
    """Innermost Name of an attribute chain, or None."""
    while isinstance(expr, ast.Attribute):
        expr = expr.value
    return expr.id if isinstance(expr, ast.Name) else None


def _method_effects(meth, methods, ctrl_attrs, memo):
    """-> (sends, advances, terminates) for ``meth`` plus reachable
    own/inherited helpers.  May-semantics: any path's effect counts."""
    if meth.name in memo:
        return memo[meth.name]
    memo[meth.name] = (frozenset(), False, False)  # recursion guard
    sends, advances, terminates = set(), False, False
    aliases = _alias_map(meth)
    for node in walk(meth):
        if isinstance(node, ast.Raise):
            terminates = True
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        fname = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        if fname == "Message" and node.args:
            sends.add(node.args[0])  # raw expr; resolved by caller
            continue
        if isinstance(f, ast.Name):
            if f.id in _SEND_FUNCS:
                advances = True
            continue
        if not isinstance(f, ast.Attribute):
            continue
        if f.attr in _SEND_FUNCS:
            advances = True
            continue
        if f.attr == "finish":
            terminates = True
            continue
        if f.attr in _LOG_ATTRS:
            continue
        root = f.value
        if isinstance(root, ast.Name):
            if root.id in _LOG_ROOTS:
                continue
            if root.id == "self":
                if f.attr in methods:
                    s2, a2, t2 = _method_effects(methods[f.attr], methods,
                                                 ctrl_attrs, memo)
                    sends |= set(s2)
                    advances = advances or a2
                    terminates = terminates or t2
                continue
            if root.id in aliases:  # ctrl = self._controller; ctrl.m()
                advances = True
            continue
        # self.<attr>....m(): controller advance or delegation -- any
        # method call through own state is progress under may-semantics
        r = _attr_root(root)
        if r == "self" and f.attr not in _LOG_ATTRS:
            advances = True
    memo[meth.name] = (frozenset(sends), advances, terminates)
    return memo[meth.name]


def _module_mentions_join(info):
    """Does a module speak the rejoin vocabulary at all?"""
    if PEER_JOIN_NAME in info.imports or PEER_JOIN_NAME in info.constants:
        return True
    if PEER_JOIN_VALUE in info.constants.values():
        return True
    for cls in info.classes.values():
        for ref in cls.handled:
            if ref.name == PEER_JOIN_NAME or ref.value == PEER_JOIN_VALUE:
                return True
    return False


def _is_peer_join(index, module, ref):
    return (ref.name == PEER_JOIN_NAME
            or _resolved(index, module, ref) == PEER_JOIN_VALUE)


def compile_specs(index):
    """ProtocolIndex -> [RoleSpec] for every concrete role-carrying FSM,
    plus per-module companion send sets (EdgeAggregator pattern: the
    role-None orchestrator in the same module owns the actual sends)."""
    companion, join_vocab = {}, {}
    for mod, info in sorted(index.modules.items()):
        join_vocab[mod] = _module_mentions_join(info)
        comp = set()
        for cls in info.classes.values():
            role = None
            for base in cls.bases:
                role = role or (FSM_ROOTS.get(base)
                                or index.fsm_role(mod, base))
            if role is not None:
                continue
            for ref in cls.sent:
                v = _resolved(index, mod, ref)
                if v is not None and not v.startswith(_RESERVED_PREFIX):
                    comp.add(v)
        companion[mod] = comp

    specs = []
    for mod, info in sorted(index.modules.items()):
        for cname in sorted(info.classes):
            cls = info.classes[cname]
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
            chain = [(cls, mod)] + index.ancestors(mod, cls.name)
            registers = any(c.registers_any for c, _m in chain)
            if not registers:
                continue
            spec = RoleSpec(cls, mod, role)
            ctrl_attrs, methods = set(), {}
            for acls, amod in chain:
                ctrl_attrs |= acls.controller_attrs
                for m in acls.node.body:
                    if isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                        methods.setdefault(m.name, m)
            for acls, amod in chain:
                for ref in acls.sent:
                    v = _resolved(index, amod, ref)
                    if v is not None and not v.startswith(_RESERVED_PREFIX):
                        spec.class_sent.add(v)
                memo = {}
                for tref, hname in acls.handler_map:
                    if _is_peer_lost_ref(index, amod, tref):
                        key = PEER_LOST_VALUE
                    elif _is_peer_join(index, amod, tref):
                        key = PEER_JOIN_VALUE
                        spec.handles_join = True
                    else:
                        key = _resolved(index, amod, tref)
                    if key is None or key in spec.handlers:
                        continue
                    ocls, omod, meth = _resolve_handler(index, acls, amod,
                                                        hname)
                    if meth is None:
                        # out of static reach: assume it acts
                        spec.handlers[key] = HandlerSpec(
                            hname, frozenset(), True, False, tref.node)
                        continue
                    raw_sends, adv, term = _method_effects(
                        meth, methods, ctrl_attrs, memo)
                    sent = set()
                    for expr in raw_sends:
                        v = _resolved(index, omod,
                                      _type_expr_ref(expr, meth))
                        if v is not None \
                                and not v.startswith(_RESERVED_PREFIX):
                            sent.add(v)
                    spec.handlers[key] = HandlerSpec(
                        hname, frozenset(sent), adv, term, meth)
            spec.companion_sent = set(companion.get(mod, ()))
            spec.join_vocab = join_vocab.get(mod, False)
            spec.has_deadline = bool(ctrl_attrs) or any(
                any(frag in n for frag in _DEADLINE_FRAGMENTS)
                for n in methods) or _module_deadline_evidence(info)
            specs.append(spec)
    return specs


def _is_peer_lost_ref(index, module, ref):
    return (ref.name == PEER_LOST_NAME
            or _resolved(index, module, ref) == PEER_LOST_VALUE)


def _module_deadline_evidence(info):
    """A ``*Controller`` import/definition (or a companion class that
    builds one) marks the module as deadline-capable even when the FSM
    class itself holds no controller field (fanin's EdgeAggregator)."""
    for local, (_src, orig) in info.imports.items():
        if local.endswith("Controller") or orig.endswith("Controller"):
            return True
    for cname, cls in info.classes.items():
        if cname.endswith("Controller") or cls.controller_attrs:
            return True
    return False


class FaultBudget:
    """Per-exploration fault allowance. The default pair budget allows
    TWO kills: with two modeled clients, the whole cohort can die in one
    round, which is exactly the regime where the fail-fast/deadline
    split matters (a deadline server must resolve abandoned, a
    deadline-less one must fail fast rather than hang). One-kill budgets
    provably miss any defect that needs a second concurrent loss (e.g.
    a quorum floor that only wedges at zero live reporters)."""

    __slots__ = ("drops", "dups", "kills", "joins")

    def __init__(self, drops=1, dups=1, kills=2, joins=1):
        self.drops = drops
        self.dups = dups
        self.kills = kills
        self.joins = joins

    def tup(self):
        return (self.drops, self.dups, self.kills, self.joins)


class Counterexample:
    """One property violation with its message-sequence trace."""

    __slots__ = ("code", "trace", "detail", "spec", "node")

    def __init__(self, code, trace, detail, spec, node=None):
        self.code = code
        self.trace = trace
        self.detail = detail
        self.spec = spec
        self.node = node if node is not None else spec.node

    def render_trace(self):
        steps = self.trace[:_TRACE_CAP]
        ell = " ; ..." if len(self.trace) > _TRACE_CAP else ""
        return " ; ".join(steps) + ell


def _who(i):
    return "server" if i == SERVER else "client%d" % i


class PairModel:
    """server x N clients over the abstract channel.

    State tuple: (sphase, reports, alive, cphases, revived, joined,
    channel, budget, fault_occurred) -- every member hashable, BFS
    dedups on the whole tuple.
    """

    def __init__(self, server, client, drive, replies, nclients=2,
                 budget=None, fair=False, seed_lost=()):
        self.server = server
        self.client = client
        self.drive = drive
        self.replies = tuple(sorted(replies))
        self.n = nclients
        self.budget = budget or FaultBudget()
        self.fair = fair
        self.seed_lost = frozenset(seed_lost)

    # -- state helpers -----------------------------------------------------

    def initial(self):
        cphases = tuple(DEAD if c in self.seed_lost else IDLE
                        for c in range(self.n))
        chan = []
        for c in range(self.n):  # open_round syncs the known cohort
            chan.append((self.drive, SERVER, c))
        for c in sorted(self.seed_lost):
            chan.append((PEER_LOST_VALUE, c, SERVER))
        return (OPEN, frozenset(), frozenset(range(self.n)), cphases,
                (False,) * self.n, (False,) * self.n,
                tuple(sorted(chan)), self.budget.tup(),
                bool(self.seed_lost))

    def _decide(self, sphase, reports, alive):
        """Early-resolution check after any server-side act."""
        live = alive & frozenset(range(self.n))
        if not live:
            return FAILED  # every client is lost
        if reports >= live:
            return DONE
        return sphase

    # -- transition relation ----------------------------------------------

    def successors(self, st, events):
        (sphase, reports, alive, cphases, revived, joined, chan, bud,
         faulted) = st
        if sphase != OPEN:
            return
        drops, dups, kills, joins = bud

        seen_msgs = set()
        for i, msg in enumerate(chan):
            if msg in seen_msgs:
                continue
            seen_msgs.add(msg)
            rest = chan[:i] + chan[i + 1:]
            mtype, src, dst = msg
            label = "deliver %s %s->%s" % (mtype, _who(src), _who(dst))
            if dst == SERVER:
                yield from self._deliver_server(
                    label, mtype, src, rest, sphase, reports, alive,
                    cphases, revived, joined, bud, faulted, events)
            else:
                yield from self._deliver_client(
                    label, mtype, dst, rest, sphase, reports, alive,
                    cphases, revived, joined, bud, faulted, events)

            if not self.fair:
                if drops and (self.server.has_deadline
                              or mtype == PEER_JOIN_VALUE):
                    yield ("drop %s %s->%s" % (mtype, _who(src), _who(dst)),
                           (sphase, reports, alive, cphases, revived,
                            joined, rest,
                            (drops - 1, dups, kills, joins), True))
                if dups and len(chan) < MAX_CHANNEL \
                        and not mtype.startswith(_RESERVED_PREFIX):
                    yield ("duplicate %s %s->%s" % (mtype, _who(src),
                                                    _who(dst)),
                           (sphase, reports, alive, cphases, revived,
                            joined, tuple(sorted(chan + (msg,))),
                            (drops, dups - 1, kills, joins), True))

        if not self.fair:
            if kills:
                for c in range(self.n):
                    if cphases[c] == DEAD:
                        continue
                    nphases = _tset(cphases, c, DEAD)
                    nchan = tuple(sorted(
                        chan + ((PEER_LOST_VALUE, c, SERVER),)))
                    yield ("kill client%d" % c,
                           (sphase, reports, alive, nphases, revived,
                            joined, nchan,
                            (drops, dups, kills - 1, joins), True))
            if joins and (self.client.join_vocab
                          or self.server.join_vocab):
                for c in range(self.n):
                    # rejoin is causally AFTER the shed: the transport
                    # detects the loss before the rank re-dials, so a
                    # PEER_LOST still in flight forbids the join fault
                    if cphases[c] != DEAD \
                            or (PEER_LOST_VALUE, c, SERVER) in chan:
                        continue
                    nphases = _tset(cphases, c, IDLE)
                    nrev = _tset(revived, c, True)
                    nchan = tuple(sorted(
                        chan + ((PEER_JOIN_VALUE, c, SERVER),)))
                    yield ("rejoin client%d" % c,
                           (sphase, reports, alive, nphases, nrev,
                            joined, nchan,
                            (drops, dups, kills, joins - 1), True))

        if self.server.has_deadline and faulted:
            outcome = "degraded" if reports else "abandoned"
            yield ("deadline server: round 0 resolved %s" % outcome,
                   (DONE if reports else FAILED, reports, alive, cphases,
                    revived, joined, chan, bud, faulted))

    def _deliver_server(self, label, mtype, src, rest, sphase, reports,
                        alive, cphases, revived, joined, bud, faulted,
                        events):
        spec = self.server.handlers.get(mtype)
        if mtype == PEER_LOST_VALUE:
            if spec is None:
                # core/managers.py fail-fast: unhandled peer loss stops
                # the receive loop -- terminal, but decided (FL121's
                # domain, not a hang)
                yield (label + " (unhandled: fail-fast)",
                       (FAILED, reports, alive, cphases, revived, joined,
                        rest, bud, faulted))
                return
            if spec.inert:
                yield (label + " (handler %s inert)" % spec.name,
                       (sphase, reports, alive, cphases, revived, joined,
                        rest, bud, faulted))
                return
            nalive = alive - {src}
            nphase = self._decide(sphase, reports, nalive)
            yield (label,
                   (nphase, reports, nalive, cphases, revived, joined,
                    rest, bud, faulted))
            return
        if mtype == PEER_JOIN_VALUE:
            njoined = _tset(joined, src, True)
            if spec is None or spec.inert:
                yield (label + " (no join handler: rank stays shed)",
                       (sphase, reports, alive, cphases, revived, njoined,
                        rest, bud, faulted))
                return
            nalive = alive | {src}
            nchan = tuple(sorted(rest + ((self.drive, SERVER, src),)))
            if len(nchan) > MAX_CHANNEL:
                nchan = rest
            yield (label + " (re-admitted, re-synced)",
                   (sphase, reports, nalive, cphases, revived, njoined,
                    nchan, bud, faulted))
            return
        # a reply (or any non-reserved frame) arriving at the server
        if spec is None:
            yield (label + " (no handler on `%s` chain folds it)"
                   % self.server.name,
                   (sphase, reports, alive, cphases, revived, joined,
                    rest, bud, faulted))
            return
        if spec.inert:
            events.add(("FL142", self.server, mtype, spec, label))
            yield (label + " (handler %s inert)" % spec.name,
                   (sphase, reports, alive, cphases, revived, joined,
                    rest, bud, faulted))
            return
        nreports = reports | {src}
        nphase = self._decide(sphase, nreports, alive)
        yield (label,
               (nphase, nreports, alive, cphases, revived, joined, rest,
                bud, faulted))

    def _deliver_client(self, label, mtype, dst, rest, sphase, reports,
                        alive, cphases, revived, joined, bud, faulted,
                        events):
        if cphases[dst] == DEAD:
            yield (label + " (peer dead)",
                   (sphase, reports, alive, cphases, revived, joined,
                    rest, bud, faulted))
            return
        if mtype != self.drive:
            yield (label,
                   (sphase, reports, alive, cphases, revived, joined,
                    rest, bud, faulted))
            return
        spec = self.client.handlers.get(mtype)
        nphases = _tset(cphases, dst, CDONE)
        if spec is not None and spec.inert:
            events.add(("FL142", self.client, mtype, spec, label))
            yield (label + " (handler %s inert: no reply)" % spec.name,
                   (sphase, reports, alive, nphases, revived, joined,
                    rest, bud, faulted))
            return
        if spec is None:
            yield (label + " (unhandled)",
                   (sphase, reports, alive, nphases, revived, joined,
                    rest, bud, faulted))
            return
        out = list(rest)
        reply_types = tuple(sorted(spec.sends)) or self.replies
        for r in reply_types:
            out.append((r, dst, SERVER))
        out = tuple(sorted(out))
        if len(out) > MAX_CHANNEL:
            out = rest
        yield (label,
               (sphase, reports, alive, nphases, revived, joined, out,
                bud, faulted))


def _tset(tup, i, v):
    return tup[:i] + (v,) + tup[i + 1:]


class ExploreResult:
    __slots__ = ("counterexamples", "states", "capped", "decided")

    def __init__(self):
        self.counterexamples = []
        self.states = 0
        self.capped = False
        self.decided = False


def explore(model, max_states, liveness_code, events):
    """Deterministic BFS with state-hash dedup and depth bound.

    -> ExploreResult.  A stuck undecided state yields one
    counterexample under ``liveness_code`` (FL141 on the fair run,
    FL140 on the faulted run); only the first (shortest-trace) stuck
    state is reported per run.
    """
    res = ExploreResult()
    init = model.initial()
    parent = {init: (None, None, 0)}
    q = deque([init])
    stuck = None
    while q:
        st = q.popleft()
        res.states += 1
        if res.states > max_states:
            res.capped = True
            return res
        depth = parent[st][2]
        if st[0] != OPEN:
            res.decided = True
            if st[0] == DONE:
                _check_rejoin_strand(model, st, parent, events)
            continue
        if depth >= MAX_DEPTH:
            continue
        n_succ = 0
        for label, nxt in model.successors(st, events):
            n_succ += 1
            if nxt not in parent:
                parent[nxt] = (st, label, depth + 1)
                q.append(nxt)
        if n_succ == 0 and stuck is None:
            stuck = st
    if stuck is not None and liveness_code is not None:
        res.counterexamples.append(Counterexample(
            liveness_code, _trace(parent, stuck),
            _stuck_detail(model, stuck), model.server))
    return res


def _trace(parent, st):
    steps = []
    while True:
        prev, label, _d = parent[st]
        if prev is None:
            break
        steps.append(label)
        st = prev
    steps.reverse()
    return steps


def _stuck_detail(model, st):
    sphase, reports, alive, cphases, _rev, _join, chan, _bud, _f = st
    live = sorted(alive & frozenset(range(model.n)))
    return ("the channel is drained, %d/%d live-cohort reports folded "
            "and no deadline is armed -- round 0 hangs undecided"
            % (len(reports & frozenset(live)), len(live)))


def _check_rejoin_strand(model, st, parent, events):
    """FL143: a rank whose rejoin HELLO was delivered, who is alive at
    round end, yet sits outside the decided cohort -- stranded."""
    _sp, _rep, alive, cphases, revived, joined, _c, _b, _f = st
    for c in range(model.n):
        if revived[c] and joined[c] and cphases[c] != DEAD \
                and c not in alive:
            events.add(("FL143", model.server, c,
                        tuple(_trace(parent, st))))


# -- composition discovery -------------------------------------------------

def _concrete_types(spec):
    return {t for t in spec.sendable() if not t.startswith(_RESERVED_PREFIX)}


def discover_pairs(specs):
    """(server RoleSpec, client RoleSpec, drive, replies) for every
    composable pair: the server (or a same-module companion) sends a
    type the client handles, and a reply route back exists."""
    servers = [s for s in specs if s.role == "server"]
    clients = [s for s in specs if s.role == "client"]
    pairs = []
    for srv in servers:
        for cli in clients:
            drives = sorted(_concrete_types(srv)
                            & {t for t in cli.handlers
                               if not t.startswith(_RESERVED_PREFIX)})
            if not drives:
                continue
            drive = drives[0]
            hspec = cli.handlers.get(drive)
            replies = set(hspec.sends) if hspec is not None else set()
            if not replies:
                replies = {t for t in cli.class_sent if t != drive}
            if not replies:
                replies = {t for t in cli.companion_sent if t != drive}
            if not replies:
                continue  # a pure sink is out of the model's reach
            pairs.append((srv, cli, drive, tuple(sorted(replies))))
    pairs.sort(key=lambda p: (p[0].module, p[0].name, p[1].module,
                              p[1].name))
    return pairs[:MAX_COMPOSITIONS]


class TwoTierModel:
    """coordinator x E edge relays x per-edge leaves (net/fanin.py
    shape).  The relay is a composite: downlink FSM + orchestrator +
    uplink FSM in one module; an edge that resolves *abandoned*
    forwards nothing upstream -- the coordinator's own staleness
    machinery must absorb the hole (the behavior the multi-tier arc
    relies on).

    State: (cphase, coord_reports, alive_edges, edges, leaves, channel,
    budget, faulted) where edges = ((ephase, leaf_reports), ...) and
    leaves = flat tuple of leaf phases.  Leaf ids: edge e's leaf j is
    ``100*(e+1)+j``; edge ids are 0..E-1 on the coordinator plane.
    """

    def __init__(self, coord, relay, leaf, down, up, edges=2,
                 leaves_per_edge=2, budget=None, fair=False,
                 lost_leaves=()):
        self.coord = coord      # RoleSpec (server role, e.g. async)
        self.relay = relay      # RoleSpec of the downlink (edge face)
        self.leaf = leaf        # RoleSpec (client role)
        self.down = down        # downstream drive type (sync)
        self.up = up            # upstream report type
        self.E = edges
        self.L = leaves_per_edge
        self.budget = budget or FaultBudget(drops=1, dups=0, kills=1,
                                            joins=0)
        self.fair = fair
        self.lost = frozenset(lost_leaves)

    def leaf_id(self, e, j):
        return 100 * (e + 1) + j

    def initial(self):
        leaves = tuple(DEAD if self.leaf_id(e, j) in self.lost else IDLE
                       for e in range(self.E) for j in range(self.L))
        edges = tuple((E_OPEN, frozenset()) for _ in range(self.E))
        chan = [(self.down, SERVER, e) for e in range(self.E)]
        for lid in sorted(self.lost):
            chan.append((PEER_LOST_VALUE, lid, (lid // 100) - 1))
        return (OPEN, frozenset(), frozenset(range(self.E)), edges,
                leaves, tuple(sorted(chan)), self.budget.tup(),
                bool(self.lost))

    def _lidx(self, lid):
        e = (lid // 100) - 1
        return e * self.L + (lid % 100)

    def _edge_live(self, e, leaves):
        return frozenset(self.leaf_id(e, j) for j in range(self.L)
                         if leaves[e * self.L + j] != DEAD)

    def successors(self, st, events):
        (cph, creps, aedges, edges, leaves, chan, bud, faulted) = st
        if cph != OPEN:
            return
        drops, dups, kills, joins = bud
        seen = set()
        for i, msg in enumerate(chan):
            if msg in seen:
                continue
            seen.add(msg)
            rest = chan[:i] + chan[i + 1:]
            mtype, src, dst = msg
            yield from self._deliver(mtype, src, dst, rest, st, events)
            if not self.fair and drops:
                yield ("drop %s" % mtype,
                       (cph, creps, aedges, edges, leaves, rest,
                        (drops - 1, dups, kills, joins), True))
        if not self.fair and kills:
            for e in range(self.E):
                for j in range(self.L):
                    if leaves[e * self.L + j] == DEAD:
                        continue
                    lid = self.leaf_id(e, j)
                    nl = _tset(leaves, e * self.L + j, DEAD)
                    nchan = tuple(sorted(
                        chan + ((PEER_LOST_VALUE, lid, e),)))
                    yield ("kill leaf%d" % lid,
                           (cph, creps, aedges, edges, nl, nchan,
                            (drops, dups, kills - 1, joins), True))
                    break  # one representative per edge bounds the fan
            # edge-tier kill: the relay PROCESS dies -- every leaf under
            # it goes unreachable with it and the coordinator observes a
            # single PEER_LOST from the edge plane. One representative
            # (the lowest-id alive edge) bounds the fan like the leaf
            # kills above; a sole surviving edge is never killed (an
            # empty coordinator plane is topology death, not a protocol
            # defect this model judges).
            for e in sorted(aedges):
                if len(aedges) <= 1:
                    break
                naedges = aedges - {e}
                nl = leaves
                for j in range(self.L):
                    nl = _tset(nl, e * self.L + j, DEAD)
                nedges = _tset(edges, e, (E_ABANDONED, edges[e][1]))
                nchan = tuple(sorted(
                    chan + ((PEER_LOST_VALUE, e, SERVER),)))
                yield ("kill edge%d" % e,
                       (cph, creps, naedges, nedges, nl, nchan,
                        (drops, dups, kills - 1, joins), True))
                break
        # edge deadlines: a below-quorum edge resolves abandoned and
        # forwards NOTHING (fanin._on_edge_abandoned)
        if faulted:
            for e in range(self.E):
                eph, ereps = edges[e]
                if eph != E_OPEN:
                    continue
                if ereps:
                    nedges = _tset(edges, e, (E_REPORTED, ereps))
                    nchan = tuple(sorted(chan + ((self.up, e, SERVER),)))
                    yield ("deadline edge%d: degraded, reports upstream"
                           % e,
                           (cph, creps, aedges, nedges, leaves, nchan,
                            bud, faulted))
                else:
                    nedges = _tset(edges, e, (E_ABANDONED, ereps))
                    yield ("deadline edge%d: abandoned, forwards nothing"
                           % e,
                           (cph, creps, aedges, nedges, leaves, chan,
                            bud, faulted))
            if self.coord.has_deadline:
                outcome = "degraded" if creps else "abandoned"
                yield ("deadline coordinator: round 0 resolved %s "
                       "(staleness machinery absorbs the missing edge "
                       "report)" % outcome,
                       (DONE if creps else FAILED, creps, aedges, edges,
                        leaves, chan, bud, faulted))

    def _deliver(self, mtype, src, dst, rest, st, events):
        (cph, creps, aedges, edges, leaves, _chan, bud, faulted) = st
        base = (cph, creps, aedges, edges, leaves, rest, bud, faulted)
        if dst == SERVER:  # coordinator plane
            label = "deliver %s edge%s->coordinator" % (mtype, src)
            if mtype == PEER_LOST_VALUE:
                # an edge-plane loss reaching the coordinator: the
                # runtime _on_peer_lost re-cohorts, so the quorum the
                # kill transition already shrank can decide the round
                # here (the remaining edges' reports may all be folded)
                ncph = DONE if creps and creps >= aedges else cph
                yield (label, (ncph, creps, aedges, edges, leaves, rest,
                               bud, faulted))
                return
            spec = self.coord.handlers.get(mtype)
            if spec is None or spec.inert:
                if spec is not None and spec.inert:
                    events.add(("FL142", self.coord, mtype, spec, label))
                yield (label + " (not folded)", base)
                return
            ncreps = creps | {src}
            ncph = DONE if ncreps >= aedges else cph
            yield (label,
                   (ncph, ncreps, aedges, edges, leaves, rest, bud,
                    faulted))
            return
        if dst < 100:  # edge plane
            e = dst
            eph, ereps = edges[e]
            label = "deliver %s %s->edge%d" % (
                mtype, _who(src) if src == SERVER else "leaf%d" % src, e)
            if mtype == self.down and eph == E_OPEN:
                # uplink _on_sync -> edge.open_round: sync the leaves
                out = list(rest)
                for j in range(self.L):
                    out.append((self.down, e, self.leaf_id(e, j)))
                out = tuple(sorted(out))
                yield (label + " (edge opens, syncs leaves)",
                       (cph, creps, aedges, edges, leaves,
                        out if len(out) <= MAX_CHANNEL + self.E * self.L
                        else rest, bud, faulted))
                return
            if mtype == PEER_LOST_VALUE and eph == E_OPEN:
                live = self._edge_live(e, leaves) - {src}
                ereps2 = ereps - {src}
                if live and ereps2 >= live:
                    nedges = _tset(edges, e, (E_REPORTED, ereps2))
                    nchan = tuple(sorted(rest + ((self.up, e, SERVER),)))
                    yield (label + " (edge sheds, resolves, reports)",
                           (cph, creps, aedges, nedges, leaves, nchan,
                            bud, faulted))
                else:
                    nedges = _tset(edges, e, (eph, ereps2))
                    yield (label + " (edge sheds leaf)",
                           (cph, creps, aedges, nedges, leaves, rest,
                            bud, faulted))
                return
            if mtype == self.up and eph == E_OPEN:
                # a leaf report reaching its edge (downlink _on_report)
                spec = self.relay.handlers.get(mtype)
                if spec is not None and spec.inert:
                    events.add(("FL142", self.relay, mtype, spec, label))
                    yield (label + " (handler inert)", base)
                    return
                ereps2 = ereps | {src}
                live = self._edge_live(e, leaves)
                if live and ereps2 >= live:
                    nedges = _tset(edges, e, (E_REPORTED, ereps2))
                    nchan = tuple(sorted(rest + ((self.up, e, SERVER),)))
                    yield (label + " (quorum: edge reports upstream)",
                           (cph, creps, aedges, nedges, leaves, nchan,
                            bud, faulted))
                else:
                    nedges = _tset(edges, e, (eph, ereps2))
                    yield (label,
                           (cph, creps, aedges, nedges, leaves, rest,
                            bud, faulted))
                return
            yield (label + " (consumed)", base)
            return
        # leaf plane
        lid = dst
        li = self._lidx(lid)
        label = "deliver %s edge%d->leaf%d" % (mtype, src, lid)
        if leaves[li] == DEAD:
            yield (label + " (leaf dead)", base)
            return
        if mtype == self.down:
            spec = self.leaf.handlers.get(mtype)
            nl = _tset(leaves, li, CDONE)
            if spec is not None and spec.inert:
                events.add(("FL142", self.leaf, mtype, spec, label))
                yield (label + " (handler inert: no report)",
                       (cph, creps, aedges, edges, nl, rest, bud,
                        faulted))
                return
            nchan = tuple(sorted(rest + ((self.up, lid, src),)))
            yield (label + " (leaf trains, reports)",
                   (cph, creps, aedges, edges, nl,
                    nchan if len(nchan) <= MAX_CHANNEL + self.E * self.L
                    else rest, bud, faulted))
            return
        yield (label + " (consumed)", base)


def explore_two_tier(model, max_states, liveness_code, events):
    """Same BFS loop as :func:`explore`, over the tiered state shape."""
    res = ExploreResult()
    init = model.initial()
    parent = {init: (None, None, 0)}
    q = deque([init])
    stuck = None
    while q:
        st = q.popleft()
        res.states += 1
        if res.states > max_states:
            res.capped = True
            return res
        depth = parent[st][2]
        if st[0] != OPEN:
            res.decided = True
            continue
        if depth >= MAX_DEPTH:
            continue
        n_succ = 0
        for label, nxt in model.successors(st, events):
            n_succ += 1
            if nxt not in parent:
                parent[nxt] = (st, label, depth + 1)
                q.append(nxt)
        if n_succ == 0 and stuck is None:
            stuck = st
    if stuck is not None and liveness_code is not None:
        res.counterexamples.append(Counterexample(
            liveness_code, _trace(parent, stuck),
            "round 0 hangs undecided at the coordinator", model.coord))
    return res


def discover_two_tier(specs):
    """(coordinator, relay-downlink, leaf, down, up) tuples for every
    relay module: a module holding a client-role uplink, a server-role
    downlink, and a role-None companion that owns both the downstream
    and upstream sends (net/fanin.py shape), paired with an external
    coordinator that handles the upstream type and external leaves
    that handle the downstream type."""
    out = []
    by_module = {}
    for s in specs:
        by_module.setdefault(s.module, []).append(s)
    for mod in sorted(by_module):
        members = by_module[mod]
        ups = [s for s in members if s.role == "client"
               and s.companion_sent]
        downs = [s for s in members if s.role == "server"
                 and s.companion_sent]
        if not ups or not downs:
            continue
        uplink, downlink = ups[0], downs[0]
        down_types = sorted(
            t for t in uplink.companion_sent if t in uplink.handlers)
        up_types = sorted(
            t for t in downlink.companion_sent if t in downlink.handlers)
        if not down_types or not up_types:
            continue
        down, up = down_types[0], up_types[0]
        coords = sorted((s for s in specs
                         if s.role == "server" and s.module != mod
                         and up in s.handlers),
                        key=lambda s: (s.module, s.name))
        leaves = sorted((s for s in specs
                         if s.role == "client" and s.module != mod
                         and down in s.handlers),
                        key=lambda s: (s.module, s.name))
        for coord in coords:
            for leaf in leaves[:1]:
                out.append((coord, downlink, leaf, down, up))
    return out[:MAX_COMPOSITIONS]


class ThreeTierModel:
    """coordinator x E tier-1 relays x S tier-2 relays each x per-edge
    leaves: the relay module stacked UNDER ITSELF (topology/'s
    edges-of-edges process tree).  The same (coord, relay, leaf, down,
    up) tuple :func:`discover_two_tier` yields composes one tier
    deeper because the relay's uplink handles ``down`` and its
    downlink handles ``up`` -- a tier-2 relay's upstream report is
    indistinguishable, on the wire, from a leaf's.

    Id planes: tier-1 edges ``0..E-1``; tier-2 edge ``s`` under tier-1
    edge ``e`` is ``100*(e+1)+s``; leaf ``j`` under tier-2 edge ``t``
    is ``100*t+j`` (>= 10000).  State: (cphase, coord_reports,
    alive_edges, tier1, tier2, leaves, channel, budget, faulted) with
    tier1/tier2 = ((ephase, folded-child set), ...).

    Default fault budget is drops-only: one drop arms every tier's
    deadline machinery, which is the hazard DISTINCTIVE to the deeper
    tree (the abandon cascade -- an empty tier forwards nothing and
    each parent must absorb the hole); leaf kills are the two-tier
    model's job and triple the state space past any useful bound.
    """

    def __init__(self, coord, relay, leaf, down, up, edges=2,
                 sub_edges=2, leaves_per_edge=1, budget=None,
                 fair=False, lost_leaves=()):
        self.coord = coord
        self.relay = relay
        self.leaf = leaf
        self.down = down
        self.up = up
        self.E = edges
        self.S = sub_edges
        self.L = leaves_per_edge
        self.budget = budget or FaultBudget(drops=1, dups=0, kills=0,
                                            joins=0)
        self.fair = fair
        self.lost = frozenset(lost_leaves)
        # sync/report fan-out headroom, same discipline as TwoTierModel
        self._chan_cap = MAX_CHANNEL + edges * (1 + sub_edges
                                                * (1 + leaves_per_edge))

    def t2_id(self, e, s):
        return 100 * (e + 1) + s

    def leaf_id(self, e, s, j):
        return 100 * self.t2_id(e, s) + j

    def _t2_idx(self, tid):
        return ((tid // 100) - 1) * self.S + tid % 100

    def _lidx(self, lid):
        return self._t2_idx(lid // 100) * self.L + lid % 100

    def _t2_live(self, tidx, leaves):
        base = tidx * self.L
        e, s = divmod(tidx, self.S)
        return frozenset(self.leaf_id(e, s, j) for j in range(self.L)
                         if leaves[base + j] != DEAD)

    def initial(self):
        leaves = tuple(
            DEAD if self.leaf_id(e, s, j) in self.lost else IDLE
            for e in range(self.E) for s in range(self.S)
            for j in range(self.L))
        t1 = tuple((E_OPEN, frozenset()) for _ in range(self.E))
        t2 = tuple((E_OPEN, frozenset())
                   for _ in range(self.E * self.S))
        chan = [(self.down, SERVER, e) for e in range(self.E)]
        for lid in sorted(self.lost):
            chan.append((PEER_LOST_VALUE, lid, lid // 100))
        return (OPEN, frozenset(), frozenset(range(self.E)), t1, t2,
                leaves, tuple(sorted(chan)), self.budget.tup(),
                bool(self.lost))

    def successors(self, st, events):
        (cph, creps, aedges, t1, t2, leaves, chan, bud, faulted) = st
        if cph != OPEN:
            return
        drops, dups, kills, joins = bud
        seen = set()
        for i, msg in enumerate(chan):
            if msg in seen:
                continue
            seen.add(msg)
            rest = chan[:i] + chan[i + 1:]
            mtype, src, dst = msg
            yield from self._deliver(mtype, src, dst, rest, st, events)
            if not self.fair and drops:
                yield ("drop %s" % mtype,
                       (cph, creps, aedges, t1, t2, leaves, rest,
                        (drops - 1, dups, kills, joins), True))
        if not self.fair and kills:
            for tidx in range(self.E * self.S):
                for j in range(self.L):
                    if leaves[tidx * self.L + j] == DEAD:
                        continue
                    e, s = divmod(tidx, self.S)
                    lid = self.leaf_id(e, s, j)
                    nl = _tset(leaves, tidx * self.L + j, DEAD)
                    nchan = tuple(sorted(
                        chan + ((PEER_LOST_VALUE, lid, lid // 100),)))
                    yield ("kill leaf%d" % lid,
                           (cph, creps, aedges, t1, t2, nl, nchan,
                            (drops, dups, kills - 1, joins), True))
                    break  # one representative per tier-2 edge
        if faulted:
            # per-tier deadlines, bottom-up identity: an edge with
            # folded children resolves degraded and reports upstream;
            # an empty one abandons and forwards NOTHING (the local
            # retry is invisible one tier up -- the parent's own
            # deadline machinery must absorb the hole either way)
            for tidx in range(self.E * self.S):
                eph, ereps = t2[tidx]
                if eph != E_OPEN:
                    continue
                e, s = divmod(tidx, self.S)
                if ereps:
                    nt2 = _tset(t2, tidx, (E_REPORTED, ereps))
                    nchan = tuple(sorted(
                        chan + ((self.up, self.t2_id(e, s), e),)))
                    yield ("deadline tier2-edge%d: degraded, reports "
                           "upstream" % self.t2_id(e, s),
                           (cph, creps, aedges, t1, nt2, leaves, nchan,
                            bud, faulted))
                else:
                    nt2 = _tset(t2, tidx, (E_ABANDONED, ereps))
                    yield ("deadline tier2-edge%d: abandoned, forwards "
                           "nothing" % self.t2_id(e, s),
                           (cph, creps, aedges, t1, nt2, leaves, chan,
                            bud, faulted))
            for e in range(self.E):
                eph, ereps = t1[e]
                if eph != E_OPEN:
                    continue
                if ereps:
                    nt1 = _tset(t1, e, (E_REPORTED, ereps))
                    nchan = tuple(sorted(chan + ((self.up, e, SERVER),)))
                    yield ("deadline tier1-edge%d: degraded, reports "
                           "upstream" % e,
                           (cph, creps, aedges, nt1, t2, leaves, nchan,
                            bud, faulted))
                else:
                    nt1 = _tset(t1, e, (E_ABANDONED, ereps))
                    yield ("deadline tier1-edge%d: abandoned, forwards "
                           "nothing" % e,
                           (cph, creps, aedges, nt1, t2, leaves, chan,
                            bud, faulted))
            if self.coord.has_deadline:
                outcome = "degraded" if creps else "abandoned"
                yield ("deadline coordinator: round 0 resolved %s "
                       "(staleness machinery absorbs the missing edge "
                       "report)" % outcome,
                       (DONE if creps else FAILED, creps, aedges, t1,
                        t2, leaves, chan, bud, faulted))

    def _deliver(self, mtype, src, dst, rest, st, events):
        (cph, creps, aedges, t1, t2, leaves, _chan, bud, faulted) = st
        base = (cph, creps, aedges, t1, t2, leaves, rest, bud, faulted)
        if dst == SERVER:  # coordinator plane
            label = "deliver %s tier1-edge%s->coordinator" % (mtype, src)
            if mtype == PEER_LOST_VALUE:
                yield (label, base)
                return
            spec = self.coord.handlers.get(mtype)
            if spec is None or spec.inert:
                if spec is not None and spec.inert:
                    events.add(("FL142", self.coord, mtype, spec, label))
                yield (label + " (not folded)", base)
                return
            ncreps = creps | {src}
            ncph = DONE if ncreps >= aedges else cph
            yield (label,
                   (ncph, ncreps, aedges, t1, t2, leaves, rest, bud,
                    faulted))
            return
        if dst < 100:  # tier-1 edge plane
            e = dst
            eph, ereps = t1[e]
            label = "deliver %s %s->tier1-edge%d" % (
                mtype, _who(src) if src == SERVER
                else "tier2-edge%d" % src, e)
            if mtype == self.down and eph == E_OPEN:
                out = list(rest)
                for s in range(self.S):  # open, sync the sub-edges
                    out.append((self.down, e, self.t2_id(e, s)))
                out = tuple(sorted(out))
                yield (label + " (edge opens, syncs sub-edges)",
                       (cph, creps, aedges, t1, t2, leaves,
                        out if len(out) <= self._chan_cap else rest,
                        bud, faulted))
                return
            if mtype == self.up and eph == E_OPEN:
                spec = self.relay.handlers.get(mtype)
                if spec is not None and spec.inert:
                    events.add(("FL142", self.relay, mtype, spec, label))
                    yield (label + " (handler inert)", base)
                    return
                ereps2 = ereps | {src}
                # sub-edges never die in this model: quorum = all of them
                if len(ereps2) >= self.S:
                    nt1 = _tset(t1, e, (E_REPORTED, ereps2))
                    nchan = tuple(sorted(rest + ((self.up, e, SERVER),)))
                    yield (label + " (quorum: edge reports upstream)",
                           (cph, creps, aedges, nt1, t2, leaves, nchan,
                            bud, faulted))
                else:
                    nt1 = _tset(t1, e, (eph, ereps2))
                    yield (label,
                           (cph, creps, aedges, nt1, t2, leaves, rest,
                            bud, faulted))
                return
            yield (label + " (consumed)", base)
            return
        if dst < 10000:  # tier-2 edge plane
            tid = dst
            tidx = self._t2_idx(tid)
            eph, ereps = t2[tidx]
            e = (tid // 100) - 1
            label = "deliver %s %s->tier2-edge%d" % (
                mtype, "tier1-edge%d" % src if src < 100
                else "leaf%d" % src, tid)
            if mtype == self.down and eph == E_OPEN:
                out = list(rest)
                for j in range(self.L):
                    out.append((self.down, tid, 100 * tid + j))
                out = tuple(sorted(out))
                yield (label + " (edge opens, syncs leaves)",
                       (cph, creps, aedges, t1, t2, leaves,
                        out if len(out) <= self._chan_cap else rest,
                        bud, faulted))
                return
            if mtype == PEER_LOST_VALUE and eph == E_OPEN:
                live = self._t2_live(tidx, leaves) - {src}
                ereps2 = ereps - {src}
                if live and ereps2 >= live:
                    nt2 = _tset(t2, tidx, (E_REPORTED, ereps2))
                    nchan = tuple(sorted(rest + ((self.up, tid, e),)))
                    yield (label + " (edge sheds, resolves, reports)",
                           (cph, creps, aedges, t1, nt2, leaves, nchan,
                            bud, faulted))
                else:
                    nt2 = _tset(t2, tidx, (eph, ereps2))
                    yield (label + " (edge sheds leaf)",
                           (cph, creps, aedges, t1, nt2, leaves, rest,
                            bud, faulted))
                return
            if mtype == self.up and eph == E_OPEN:
                spec = self.relay.handlers.get(mtype)
                if spec is not None and spec.inert:
                    events.add(("FL142", self.relay, mtype, spec, label))
                    yield (label + " (handler inert)", base)
                    return
                ereps2 = ereps | {src}
                live = self._t2_live(tidx, leaves)
                if live and ereps2 >= live:
                    nt2 = _tset(t2, tidx, (E_REPORTED, ereps2))
                    nchan = tuple(sorted(rest + ((self.up, tid, e),)))
                    yield (label + " (quorum: edge reports upstream)",
                           (cph, creps, aedges, t1, nt2, leaves, nchan,
                            bud, faulted))
                else:
                    nt2 = _tset(t2, tidx, (eph, ereps2))
                    yield (label,
                           (cph, creps, aedges, t1, nt2, leaves, rest,
                            bud, faulted))
                return
            yield (label + " (consumed)", base)
            return
        # leaf plane
        lid = dst
        li = self._lidx(lid)
        label = "deliver %s tier2-edge%d->leaf%d" % (mtype, src, lid)
        if leaves[li] == DEAD:
            yield (label + " (leaf dead)", base)
            return
        if mtype == self.down:
            spec = self.leaf.handlers.get(mtype)
            nl = _tset(leaves, li, CDONE)
            if spec is not None and spec.inert:
                events.add(("FL142", self.leaf, mtype, spec, label))
                yield (label + " (handler inert: no report)",
                       (cph, creps, aedges, t1, t2, nl, rest, bud,
                        faulted))
                return
            nchan = tuple(sorted(rest + ((self.up, lid, src),)))
            yield (label + " (leaf trains, reports)",
                   (cph, creps, aedges, t1, t2, nl,
                    nchan if len(nchan) <= self._chan_cap else rest,
                    bud, faulted))
            return
        yield (label + " (consumed)", base)


# -- counterexample -> runtime fault plan ----------------------------------

#: trace-label grammar fragments the compiler understands.
_FAULT_STEP = re.compile(
    r"^(?P<action>deliver|drop|duplicate)\s+(?P<mtype>\S+)\s+"
    r"(?P<src>\S+?)->(?P<dst>\S+?)(\s+\(.*)?$")
_KILL_STEP = re.compile(r"^kill\s+(?P<who>\S+)$")
_REJOIN_STEP = re.compile(r"^rejoin\s+(?P<who>\S+)$")
_WHO = re.compile(r"^(?P<plane>server|coordinator|client|leaf|edge|"
                  r"tier1-edge|tier2-edge)(?P<id>\d*)$")


def _runtime_rank(who):
    """Model participant label -> runtime rank. Pair-model clients are
    0-based where the tcp runner's client ranks are 1-based (the +1);
    tier/tree planes keep their model ids (the process-tree spawner's
    own id space)."""
    m = _WHO.match(who)
    if m is None:
        return None
    plane, num = m.group("plane"), m.group("id")
    if plane in ("server", "coordinator"):
        return 0
    if plane == "client":
        return int(num) + 1
    return int(num)


def trace_to_fault_plan(trace, seed=0, strict=False):
    """Compile an FL140-FL143 counterexample trace into a seeded,
    replayable :class:`resilience.faults.FaultPlan`.

    Each ``drop``/``duplicate`` step becomes a deterministic ``nth``
    rule against the sending rank's outbound stream of that message
    type; ``kill <who>`` becomes a kill on that rank's next outbound
    send. ``nth`` is recovered by counting the type's earlier wire
    appearances from the same sender in the trace -- exact for the
    round-0 scope the model explores (every (sender, type) appears at
    most once per attempt), an approximation beyond it.

    Inexpressible steps -- ``rejoin`` (a send-side wrapper cannot
    restart a process; that needs the run's launcher) and pure deliveries/
    deadlines (the transport's own behavior) -- are skipped, or raise
    ``ValueError`` for rejoin under ``strict=True``.

    The result drives ``run_tcp_fedavg(fault_plan=...)`` so a model
    counterexample re-manifests as a wall-clock hang/TimeoutError --
    ``tests/test_torch_fedcheck_modelcheck.py`` replays FL141's
    inert-handler trace this way."""
    from fedml_tpu_torch.resilience.faults import FaultPlan, FaultRule
    rules = []
    sent = Counter()  # (rank, mtype) -> wire appearances so far
    for step in trace:
        m = _FAULT_STEP.match(step)
        if m is not None:
            rank = _runtime_rank(m.group("src"))
            mtype = m.group("mtype")
            if mtype.startswith(_RESERVED_PREFIX):
                continue  # transport-synthesized, never on a sender
            sent[(rank, mtype)] += 1
            if m.group("action") == "deliver" or rank is None:
                continue
            action = ("drop" if m.group("action") == "drop"
                      else "duplicate")
            rules.append(FaultRule(action=action, rank=rank,
                                   msg_type=mtype,
                                   nth=sent[(rank, mtype)]))
            continue
        m = _KILL_STEP.match(step)
        if m is not None:
            rank = _runtime_rank(m.group("who"))
            if rank is not None:
                rules.append(FaultRule(action="kill", rank=rank, nth=1))
            continue
        if strict and _REJOIN_STEP.match(step):
            raise ValueError(
                "trace step %r is not expressible as a send-side fault "
                "rule: a rejoin needs the run's launcher to restart the "
                "rank" % step)
    return FaultPlan(seed=seed, rules=tuple(rules))


# -- the lint pass ---------------------------------------------------------

def verify_pair(server, client, drive, replies, emit=None,
                budget=None, seed_lost=(), nclients=2):
    """Run the fair + faulted explorations for one composition and
    funnel counterexamples/events into findings.  -> (fair ExploreResult,
    full ExploreResult, events set)."""
    events = set()
    fair = PairModel(server, client, drive, replies, nclients=nclients,
                     fair=True, seed_lost=seed_lost,
                     budget=FaultBudget(0, 0, 0, 0))
    fair_res = explore(fair, MAX_STATES_PAIR, "FL141", events)
    full = PairModel(server, client, drive, replies, nclients=nclients,
                     fair=False, seed_lost=seed_lost, budget=budget)
    full_res = explore(full, MAX_STATES_PAIR, "FL140", events)
    return fair_res, full_res, events


def _emit_counterexample(emit, cex, topo):
    spec = cex.spec
    if cex.code == "FL141":
        emit(spec.module, cex.node, "FL141",
             "round 0 of %s cannot reach a decision "
             "(complete/degraded/abandoned) on the fault-free path: "
             "after %s -- %s. Every fair execution must decide the "
             "round; fold the missing report path or arm a deadline"
             % (topo, cex.render_trace(), cex.detail))
    elif cex.code == "FL140":
        emit(spec.module, cex.node, "FL140",
             "deadlock in %s: a reachable undecided state has no "
             "enabled transition after %s -- %s. No handler, fault "
             "budget or deadline can move the composition; the round "
             "is wedged" % (topo, cex.render_trace(), cex.detail))


def check_model(index, emit):
    """The fedmc pass: compile, compose, explore, report FL140-FL143.

    ``emit(module, node, code, message)`` -- same shape as the other
    project passes; counterexample traces ride in the message text.
    """
    specs = compile_specs(index)
    pairs = discover_pairs(specs)
    fl142_seen, fl143_seen, cex_seen = set(), set(), set()

    def emit_cex(cex, topo):
        # one finding per defect site: the same missing fold path hangs
        # every composition that drives the server, so dedup liveness
        # counterexamples on (code, module, role) -- the first
        # (shortest-trace) composition reports it
        key = (cex.code, cex.spec.module, cex.spec.name)
        if key in cex_seen:
            return
        cex_seen.add(key)
        _emit_counterexample(emit, cex, topo)

    for srv, cli, drive, replies in pairs:
        topo = ("`%s` x 2 `%s` (drive '%s')" % (srv.name, cli.name, drive))
        fair_res, full_res, events = verify_pair(srv, cli, drive, replies)
        if fair_res.capped or full_res.capped:
            continue  # out of budget: bounded checking promises nothing
        for cex in fair_res.counterexamples + full_res.counterexamples:
            emit_cex(cex, topo)
        _emit_events(emit, events, fl142_seen, fl143_seen, topo)
    for coord, relay, leaf, down, up in discover_two_tier(specs):
        topo = ("two-tier `%s` <- `%s` relay <- `%s` leaves"
                % (coord.name, relay.name, leaf.name))
        events = set()
        fair = TwoTierModel(coord, relay, leaf, down, up, fair=True,
                            budget=FaultBudget(0, 0, 0, 0))
        fair_res = explore_two_tier(fair, MAX_STATES_TIER, "FL141",
                                    events)
        full = TwoTierModel(coord, relay, leaf, down, up, fair=False)
        full_res = explore_two_tier(full, MAX_STATES_TIER, "FL140",
                                    events)
        if fair_res.capped or full_res.capped:
            continue
        for cex in fair_res.counterexamples + full_res.counterexamples:
            emit_cex(cex, topo)
        _emit_events(emit, events, fl142_seen, fl143_seen, topo)
        # the same tuple stacks the relay under itself: edges-of-edges
        # (topology/'s fanout=(2, 2) process tree), one tier deeper
        topo3 = ("three-tier `%s` <- `%s` <- `%s` relays <- `%s` leaves"
                 % (coord.name, relay.name, relay.name, leaf.name))
        events3 = set()
        fair3 = ThreeTierModel(coord, relay, leaf, down, up, fair=True,
                               budget=FaultBudget(0, 0, 0, 0))
        fair3_res = explore_two_tier(fair3, MAX_STATES_TREE, "FL141",
                                     events3)
        full3 = ThreeTierModel(coord, relay, leaf, down, up, fair=False)
        full3_res = explore_two_tier(full3, MAX_STATES_TREE, "FL140",
                                     events3)
        if fair3_res.capped or full3_res.capped:
            continue
        for cex in (fair3_res.counterexamples
                    + full3_res.counterexamples):
            emit_cex(cex, topo3)
        _emit_events(emit, events3, fl142_seen, fl143_seen, topo3)


def _emit_events(emit, events, fl142_seen, fl143_seen, topo):
    for ev in sorted(events, key=_event_key):
        if ev[0] == "FL142":
            _code, spec, mtype, hspec, label = ev
            key = (spec.module, spec.name, hspec.name, mtype)
            if key in fl142_seen:
                continue
            fl142_seen.add(key)
            emit(spec.module, hspec.node, "FL142",
                 "in %s the frame '%s' can arrive (%s) while round 0 "
                 "is undecided, but `%s.%s` neither replies, advances "
                 "a controller, nor terminates on any path -- the "
                 "delivery is consumed and the round keeps waiting "
                 "(state-sensitive FL120)"
                 % (topo, mtype, label, spec.name, hspec.name))
        elif ev[0] == "FL143":
            _code, spec, rank, trace = ev
            key = (spec.module, spec.name)
            if key in fl143_seen:
                continue
            fl143_seen.add(key)
            emit(spec.module, spec.node, "FL143",
                 "in %s a shed rank can rejoin (PEER_JOIN delivered: %s) "
                 "yet `%s` never re-admits it to the cohort -- round 0 "
                 "decides with client%d alive but stranded outside every "
                 "future cohort. Register a PEER_JOIN handler that "
                 "re-adds and re-syncs the rank"
                 % (topo, " ; ".join(trace[:_TRACE_CAP]), spec.name,
                    rank))


def _event_key(ev):
    if ev[0] == "FL142":
        return (ev[0], ev[1].module, ev[1].name, ev[2], ev[4])
    return (ev[0], ev[1].module, ev[1].name, str(ev[2]))


def verify_two_tier(index, coordinator=None, lost_leaves=(),
                    edges=2, leaves_per_edge=2, fair_only=False):
    """Public API for topology pinning tests: build the two-tier model
    from an indexed fileset and explore it.

    ``lost_leaves`` pre-seeds dead leaves (their PEER_LOST already in
    flight and ``fault_occurred`` set, so deadline machinery is armed
    -- a below-quorum edge resolves abandoned and the coordinator's
    staleness machinery must absorb the hole).  -> dict with
    ``findings`` (counterexample list), ``decided``, ``states``.
    """
    specs = compile_specs(index)
    tiers = discover_two_tier(specs)
    if coordinator is not None:
        tiers = [t for t in tiers if t[0].name == coordinator]
    if not tiers:
        raise ValueError("no two-tier topology discoverable in fileset")
    coord, relay, leaf, down, up = tiers[0]
    events = set()
    model = TwoTierModel(coord, relay, leaf, down, up, edges=edges,
                         leaves_per_edge=leaves_per_edge, fair=True,
                         budget=FaultBudget(0, 0, 0, 0),
                         lost_leaves=lost_leaves)
    res = explore_two_tier(model, MAX_STATES_TIER, "FL141", events)
    out = {"findings": list(res.counterexamples), "decided": res.decided,
           "states": res.states, "coordinator": coord.name,
           "relay": relay.name, "leaf": leaf.name}
    if not fair_only:
        full = TwoTierModel(coord, relay, leaf, down, up, edges=edges,
                            leaves_per_edge=leaves_per_edge, fair=False,
                            lost_leaves=lost_leaves)
        fres = explore_two_tier(full, MAX_STATES_TIER, "FL140", events)
        out["findings"].extend(fres.counterexamples)
        out["full_states"] = fres.states
    out["events"] = events
    return out


def verify_three_tier(index, coordinator=None, lost_leaves=(),
                      edges=2, sub_edges=2, leaves_per_edge=1,
                      fair_only=False):
    """Public API for the edges-of-edges topology pinning tests:
    :func:`verify_two_tier` one tier deeper -- the discovered relay
    stacked under itself (the process tree's ``fanout=(2, 2)`` shape).
    ``lost_leaves`` pre-seeds dead leaves by their three-tier id
    (``100*(100*(e+1)+s)+j``).  -> same result dict shape."""
    specs = compile_specs(index)
    tiers = discover_two_tier(specs)
    if coordinator is not None:
        tiers = [t for t in tiers if t[0].name == coordinator]
    if not tiers:
        raise ValueError("no relay topology discoverable in fileset")
    coord, relay, leaf, down, up = tiers[0]
    events = set()
    model = ThreeTierModel(coord, relay, leaf, down, up, edges=edges,
                           sub_edges=sub_edges,
                           leaves_per_edge=leaves_per_edge, fair=True,
                           budget=FaultBudget(0, 0, 0, 0),
                           lost_leaves=lost_leaves)
    res = explore_two_tier(model, MAX_STATES_TREE, "FL141", events)
    out = {"findings": list(res.counterexamples), "decided": res.decided,
           "states": res.states, "coordinator": coord.name,
           "relay": relay.name, "leaf": leaf.name}
    if not fair_only:
        full = ThreeTierModel(coord, relay, leaf, down, up, edges=edges,
                              sub_edges=sub_edges,
                              leaves_per_edge=leaves_per_edge,
                              fair=False, lost_leaves=lost_leaves)
        fres = explore_two_tier(full, MAX_STATES_TREE, "FL140", events)
        out["findings"].extend(fres.counterexamples)
        out["full_states"] = fres.states
    out["events"] = events
    return out
