"""fedcheck determinism pass (feddet): FL131-FL135, bitwise-determinism
verification for the fold, cohort, and control-law paths (the port's copy
of ``fedml_tpu/analysis/determinism.py``; FL133 reads torch's global
stream and its seeding calls beside numpy's and ``random``'s).

Every acceptance gate in this repo is a bitwise or byte-equal claim:
sorted-key fp64 folds (``program/aggregation.py``), seeded cohort draws
(``program/cohort.py``), a wall-clock-free pace law
(``resilience/steering.py``), canonical wire codecs
(``tests/test_torch_wire.py``). Yet each determinism bug the reference
met was caught by hand: a review found ``aggregate_reports`` summing its
guard total in arrival-order dict order; a trace-shaping draft
serialized attempts through an inline sleep. This pass decides
those hazard shapes statically, before the multi-tier fan-in / device-
resident-fold arc multiplies them.

**Region model.** Rules do not run everywhere -- each has a
determinism-critical region where its hazard is a correctness bug rather
than a measurement idiom:

- *aggregation-reachable* (FL131, callgraph-derived): functions/methods
  whose name contains ``fold``/``aggregate``/``flush``, plus everything
  they transitively call. The callgraph enters module-level function
  bodies (``aggregate_reports``) and follows ``self.m()`` and imported
  bare-name calls.
- *control-law files* (FL132, path-derived): ``*steering*`` modules and
  ``fedml_tpu_torch/program/`` legs -- the code whose module contracts say "no
  wall-clock read inside the law". Deadline timers (``resilience/
  policy.py``) are *supposed* to read the clock and stay out of scope.
- *cohort/fault/trace paths* (FL133, path-derived): ``fedml_tpu_torch/
  program/``, ``fedml_tpu_torch/resilience/``, and any ``*cohort*``/
  ``*fault*``/``*trace*`` module -- where every draw must derive from
  ``SeedSequence`` spawns or the program's ``attempt_seed``.
- *handler-thread-reachable methods* (FL134, reachability-derived,
  reusing the concurrency pass's vocabulary): escaped bound methods +
  the named transport roots, closed over ``self.m()`` and same-project
  module-function calls. ``program/aggregation.py`` (the canonical fold
  -- ``fold_entries_fp64``/``BufferedAggregator`` sort before touching
  floats) and ``fedml_tpu_torch/observability/`` (telemetry accumulators never
  feed a computed value; the disabled-path bitwise A/B pins it) are
  exempt by construction.
- *manifest/status/wire-adjacent paths* (FL135, path-derived): status/
  manifest writers (``perfmon``, ``checkpoint``, ``metrics``), the
  program package, and the wire serializers (``core/message.py``,
  ``compression/codec.py``). Directory enumeration (``os.listdir``/
  ``glob``) is checked everywhere: filesystem order is never
  deterministic.

**Flow rules.**

- FL131: inside an aggregation-reachable function, a ``sum(...)`` or
  loop ``+=`` accumulation with *float evidence* (a ``float(...)`` call
  or float literal in the accumulated expression) whose iteration source
  is unordered dict/set iteration (``.values()``/``.items()``/``.keys()``
  or a bare mapping iterated and subscripted by its loop variable)
  without a ``sorted(`` normalization. Integer tallies
  (``sum(self._entry_clients.values())``) carry no float evidence and
  stay legal -- int addition commutes exactly, floats do not.
- FL132: a ``time.time()``/``monotonic()``/``perf_counter()`` read whose
  value (directly, through a chain of local bindings -- fixpoint taint
  -- or via a clock-tainted ``self.<attr>`` stored by a sibling method,
  the *attribute hop*) reaches a *decision point*: an ``if``/``while``
  test, a comparison, a ``return``, or a ``self.*`` store.
  Measurement-only reads -- deltas passed to ``observe(...)``-style
  calls -- never reach one and stay legal.
- FL133: a global-stream draw (``np.random.choice``, ``random.shuffle``,
  ``torch.randperm`` and torch's other draws with no ``generator=``,
  ...) with no earlier reseed in the same function (the legal shape is
  the historical derived-reseed idiom,
  ``np.random.seed(attempt_seed(...))``, or
  ``torch.manual_seed(attempt_seed(...))``); any *constant* seeding
  (``np.random.seed(42)``, ``default_rng()``, ``default_rng(0)``,
  ``torch.manual_seed(0)``, ``torch.cuda.manual_seed[_all](0)``,
  ``torch.Generator().manual_seed(0)``): a constant key replays the same
  draw every round, an unseeded one is irreproducible. The reference's
  ``PRNGKey(0)`` branch has no torch meaning; the seeded ``Generator``
  takes its place. A constant reseed still suppresses the
  draws after it -- it is flagged itself, and one finding at the root
  cause beats one per downstream draw.
- FL134: an ``+=`` accumulation with float evidence in a handler-
  thread-reachable method: handlers run in arrival order by
  construction, so the fold order is the network's, not the program's.
- FL135: ``json.dump``/``json.dumps`` without ``sort_keys=True`` on a
  manifest/status/wire-adjacent path, or -- cross-function -- an
  unsorted dump in an *unscoped* module whose payload traces (directly
  or through one local) to a call of a *manifest producer*: a
  module-level function in a scoped module that returns a dict it
  built. Also an ``os.listdir``/``glob`` enumeration whose result is
  not normalized with ``sorted(``/``.sort()``.

**Soundness limits (documented, deliberate).** Float evidence for
FL131/FL134 is syntactic plus a light local inference: ``float(``
calls, float literals, ``float``-annotated parameters/locals,
literal propagation through assignments (to a fixpoint), and
``@dataclass`` fields annotated ``float`` in the same module. A dict
of floats summed raw, with none of that evidence anywhere in the
function, is still invisible -- there is no interprocedural type
inference, and int-only folds stay legal by construction. FL132's taint is
intraprocedural plus the per-class attribute hop: a clock value
laundered through a container element, a tuple unpack, or a method
*return value* still escapes it. FL133 treats any non-constant
``seed(...)`` argument as derived; a seed read from the wall clock
would pass (and is FL132's business in scope). FL134's reachability is
per-class plus same-project module functions; callables smuggled
through untyped containers are the cross-class pass's (FL126) domain.
FL135's cross-function tracking follows one bare-name call hop to a
scoped producer (``DeterminismIndex.resolve_func``); a manifest
re-shaped through intermediate helpers or returned from a method is
only caught at scoped serialization sites.
"""

from __future__ import annotations

import ast
from fnmatch import fnmatch

from fedml_tpu_torch.analysis.astwalk import walk
from fedml_tpu_torch.analysis.concurrency import NAMED_ROOTS

#: Aggregation-entry name fragments: a function/method whose name
#: contains one of these is an aggregation region root.
_AGG_NAME_FRAGMENTS = ("fold", "aggregate", "flush")

#: FL132 control-law files: pace-steering modules and the program legs.
#: Deadline controllers (resilience/policy.py) legitimately read the
#: clock and are deliberately NOT in scope.
_FL132_PATHS = ("*steering*", "*/program/*", "program/*")

#: FL133 cohort/fault/trace paths.
_FL133_PATHS = ("*/program/*", "program/*", "*/resilience/*",
                "resilience/*", "*cohort*", "*fault*", "*trace*")

#: FL134 exemptions: the canonical fold module (sorts before floats) and
#: telemetry accumulators (never feed a computed value -- pinned by the
#: disabled-path bitwise A/B in tests/test_torch_observability.py).
_FL134_EXEMPT_PATHS = ("*/observability/*", "observability/*",
                       "*/program/aggregation.py", "program/aggregation.py")
_FL134_EXEMPT_FUNCS = {"fold_entries_fp64"}
_FL134_EXEMPT_CLASSES = {"BufferedAggregator"}

#: FL135 serialization scope: manifest/status writers + wire-adjacent
#: serializers. Diagnostic streams (flight recorder, chrome traces) are
#: deliberately out: their consumers are humans, not byte-equality gates.
_FL135_JSON_PATHS = ("*perfmon*", "*checkpoint*", "*metrics*",
                     "*manifest*", "*status*", "*/program/*", "program/*",
                     "*/core/message.py", "core/message.py",
                     "*/compression/codec.py", "compression/codec.py")

#: Global-stream draw attributes (FL133). ``seed`` and ``default_rng``
#: are classified separately.
_RANDOM_DRAW_ATTRS = {"choice", "random", "shuffle", "sample", "randint",
                      "uniform", "normal", "permutation", "rand", "randn",
                      "standard_normal", "binomial", "poisson", "bytes",
                      "integers"}

#: torch's global-stream draws (FL133): a call on the ``torch`` module
#: with no ``generator=`` draws from the process-wide default generator.
_TORCH_DRAW_ATTRS = {"rand", "randn", "randint", "randperm", "normal",
                     "bernoulli", "multinomial", "rand_like", "randn_like",
                     "randint_like"}

#: torch's seeding methods (FL133): ``torch.manual_seed``,
#: ``torch.cuda.manual_seed[_all]`` and ``Generator.manual_seed``.
_TORCH_SEED_ATTRS = {"manual_seed", "manual_seed_all"}

#: Wall clocks (FL132) -- same set as FL114's measurement rule.
_CLOCK_ATTRS = {"time", "monotonic", "perf_counter"}

#: Directory-enumeration calls whose result order is filesystem-defined.
_LISTING_ATTRS = {"listdir", "glob", "iglob", "iterdir", "scandir"}


class _FuncInfo:
    """One analyzed function scope (module-level def or method)."""

    __slots__ = ("module", "path", "cls", "name", "node", "calls")

    def __init__(self, module, path, cls, name, node):
        self.module = module
        self.path = path
        self.cls = cls          # class name or None for module functions
        self.name = name
        self.node = node
        #: outgoing edges: ("self", m) for self.m(...) calls,
        #: ("name", n) for bare-name calls (resolved via imports later)
        self.calls = []
        for sub in walk(node):
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            if isinstance(f, ast.Name):
                self.calls.append(("name", f.id))
            elif isinstance(f, ast.Attribute) \
                    and isinstance(f.value, ast.Name) \
                    and f.value.id == "self":
                self.calls.append(("self", f.attr))


class _ClassScope:
    """Handler-thread roots of one class (concurrency.py's model: escaped
    bound methods + the named transport entry points)."""

    __slots__ = ("name", "methods", "escaped")

    def __init__(self, node):
        self.name = node.name
        self.methods = {m.name for m in node.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))}
        self.escaped = set()
        for m in node.body:
            if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for sub in walk(m):
                if isinstance(sub, ast.Call):
                    # self.m as the CALLED function is an edge, not an
                    # escape; self.m anywhere else in the call is one
                    args = list(sub.args) + [kw.value
                                             for kw in sub.keywords]
                    for a in args:
                        for n in walk(a):
                            attr = _self_attr(n)
                            if attr in self.methods:
                                self.escaped.add(attr)

    def roots(self):
        return self.escaped | (NAMED_ROOTS & self.methods)


def _self_attr(node):
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _match(path, patterns):
    p = path.replace("\\", "/")
    return any(fnmatch(p, pat) for pat in patterns)


class DeterminismIndex:
    """Pass 1: per-module function/class/import tables for the
    determinism callgraph."""

    def __init__(self):
        self.modules = {}   # dotted module -> module record

    @staticmethod
    def module_name(path):
        # delegated, not copied: findings keyed by a diverging module
        # string are silently dropped by the linter's emit pipeline
        from fedml_tpu_torch.analysis.protocol import ProtocolIndex
        return ProtocolIndex.module_name(path)

    def add_module(self, path, tree):
        mod = self.module_name(path)
        imports = {}
        has_random = has_np = False
        torch_names = set()
        for node in walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    imports[a.asname or a.name] = (node.module, a.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "random":
                        has_random = True
                    if a.name in ("numpy", "numpy.random"):
                        has_np = True
                    if a.name == "torch":
                        torch_names.add(a.asname or "torch")
                    elif a.name.startswith("torch.") and not a.asname:
                        torch_names.add("torch")
                    imports.setdefault(a.asname or a.name.split(".")[0],
                                       (a.name, None))
        funcs = {}      # (cls or None, name) -> _FuncInfo
        classes = {}
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                funcs[(None, node.name)] = _FuncInfo(
                    mod, path, None, node.name, node)
            elif isinstance(node, ast.ClassDef):
                classes[node.name] = _ClassScope(node)
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                        funcs[(node.name, m.name)] = _FuncInfo(
                            mod, path, node.name, m.name, m)
        self.modules[mod] = {
            "path": path, "tree": tree, "imports": imports,
            "funcs": funcs, "classes": classes,
            "has_random": has_random, "has_np": has_np,
            "torch_names": torch_names,
        }

    # -- cross-module function resolution ---------------------------------
    def _candidates(self, src_mod):
        return [m for m in self.modules
                if m == src_mod or m.endswith("." + src_mod)]

    def resolve_func(self, mod, name):
        """A bare-name call target: same-module function first, then one
        import hop. Returns a (module, funcs-key) pair or None."""
        rec = self.modules.get(mod)
        if rec is None:
            return None
        if (None, name) in rec["funcs"]:
            return (mod, (None, name))
        imp = rec["imports"].get(name)
        if imp is None or imp[1] is None:
            return None
        src_mod, src_name = imp
        for cand in self._candidates(src_mod):
            if (None, src_name) in self.modules[cand]["funcs"]:
                return (cand, (None, src_name))
        return None

    def _closure(self, seeds):
        """Transitive closure over self-calls and resolvable bare-name
        calls from ``seeds`` (a set of (module, funcs-key) pairs)."""
        reach = set(seeds)
        frontier = list(seeds)
        while frontier:
            mod, key = frontier.pop()
            fi = self.modules[mod]["funcs"].get(key)
            if fi is None:
                continue
            for kind, name in fi.calls:
                if kind == "self" and fi.cls is not None:
                    tgt = (mod, (fi.cls, name))
                    if tgt[1] in self.modules[mod]["funcs"] \
                            and tgt not in reach:
                        reach.add(tgt)
                        frontier.append(tgt)
                elif kind == "name":
                    tgt = self.resolve_func(mod, name)
                    if tgt is not None and tgt not in reach:
                        reach.add(tgt)
                        frontier.append(tgt)
        return reach

    def aggregation_reach(self):
        seeds = set()
        for mod, rec in self.modules.items():
            for key, fi in rec["funcs"].items():
                if any(f in fi.name.lower() for f in _AGG_NAME_FRAGMENTS):
                    seeds.add((mod, key))
        return self._closure(seeds)

    def handler_reach(self):
        """(module, funcs-key) set reachable from handler-thread roots
        (per-class escaped methods + named transport entries), including
        module functions they call."""
        seeds = set()
        for mod, rec in self.modules.items():
            for cname, cscope in rec["classes"].items():
                for m in cscope.roots():
                    if (cname, m) in rec["funcs"]:
                        seeds.add((mod, (cname, m)))
        return self._closure(seeds)


# -- rule implementations --------------------------------------------------

def _float_evidence(expr, env=frozenset(), float_attrs=frozenset()):
    """Float-type evidence anywhere in ``expr``: a ``float(...)`` call,
    a float literal, a local name the function-level inference proved
    float (``env``, see :func:`_float_env`), or an attribute access
    whose name is a dataclass ``float`` field in the same module
    (``float_attrs``)."""
    for node in walk(expr):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "float":
            return True
        if isinstance(node, ast.Constant) and isinstance(node.value, float):
            return True
        if isinstance(node, ast.Name) and node.id in env:
            return True
        if isinstance(node, ast.Attribute) and node.attr in float_attrs:
            return True
    return False


def _is_float_ann(ann):
    """A ``float`` annotation (bare name or a string literal 'float')."""
    if isinstance(ann, ast.Name) and ann.id == "float":
        return True
    return isinstance(ann, ast.Constant) and ann.value == "float"


def _dataclass_float_fields(tree):
    """Field names annotated ``float`` on ``@dataclass`` classes in this
    module: accessing one (``self.lr``, ``cfg.deadline_s``) is float
    evidence for FL131/FL134 regardless of receiver -- dataclass fields
    are declared types, the strongest evidence this pass has."""
    fields = set()
    for node in walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        names = set()
        for dec in node.decorator_list:
            d = dec.func if isinstance(dec, ast.Call) else dec
            if isinstance(d, ast.Attribute):
                names.add(d.attr)
            elif isinstance(d, ast.Name):
                names.add(d.id)
        if "dataclass" not in names:
            continue
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name) \
                    and _is_float_ann(stmt.annotation):
                fields.add(stmt.target.id)
    return frozenset(fields)


def _float_env(fn, float_attrs=frozenset()):
    """Local names with float-type evidence in one function: parameters
    annotated ``float``, ``x: float`` annotated assignments, and --
    iterated to a fixpoint -- locals assigned an expression that already
    carries evidence (literal propagation). Reassignment to a non-float
    is not tracked (a name stays in the env once proven); int-only
    folds never enter the env, which is the property the FL131/FL134
    negative tests pin."""
    env = set()
    args = fn.args
    for a in (args.posonlyargs + args.args + args.kwonlyargs):
        if a.annotation is not None and _is_float_ann(a.annotation):
            env.add(a.arg)
    changed = True
    while changed:
        changed = False
        for node in walk(fn):
            targets = None
            if isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name) \
                    and _is_float_ann(node.annotation):
                targets = [node.target]
            elif isinstance(node, ast.Assign) and _float_evidence(
                    node.value, env, float_attrs):
                targets = [t for t in node.targets
                           if isinstance(t, ast.Name)]
            elif isinstance(node, ast.AugAssign) \
                    and isinstance(node.target, ast.Name) \
                    and _float_evidence(node.value, env, float_attrs):
                targets = [node.target]
            for tgt in targets or ():
                if tgt.id not in env:
                    env.add(tgt.id)
                    changed = True
    return frozenset(env)


def _dict_iter_attr(expr):
    """``X.values()`` / ``X.items()`` / ``X.keys()`` -> the receiver
    expression, else None. ``sorted(...)`` wrappers never match (the
    caller sees a ``sorted`` Name call instead)."""
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute) \
            and expr.func.attr in ("values", "items", "keys") \
            and not expr.args and not expr.keywords:
        return expr.func.value
    return None


def _iter_name(expr):
    return expr.id if isinstance(expr, ast.Name) else None


def _subscripted_by(body_nodes, name, targets):
    """True when ``name[<loop var>]`` appears in ``body_nodes`` -- the
    bare-mapping iteration giveaway (lists are never indexed by their
    own elements)."""
    for root in body_nodes:
        for node in walk(root):
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == name:
                for sub in walk(node.slice):
                    if isinstance(sub, ast.Name) and sub.id in targets:
                        return True
    return False


def _target_names(target):
    return {n.id for n in walk(target) if isinstance(n, ast.Name)}


def _check_fl131(fi, add, float_attrs=frozenset()):
    """Unordered-iteration float folds in an aggregation-reachable
    function."""
    fn = fi.node
    env = _float_env(fn, float_attrs)
    for node in walk(fn):
        # shape 1: sum(<genexp over unordered dict iteration>)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "sum" and node.args \
                and isinstance(node.args[0], ast.GeneratorExp):
            gen = node.args[0]
            if not _float_evidence(node.args[0], env, float_attrs):
                continue
            for comp in gen.generators:
                recv = _dict_iter_attr(comp.iter)
                bare = None
                if recv is None:
                    name = _iter_name(comp.iter)
                    if name is not None and _subscripted_by(
                            [gen.elt], name, _target_names(comp.target)):
                        bare = name
                if recv is None and bare is None:
                    continue
                what = (f"`{bare}`" if bare is not None
                        else f"`.{comp.iter.func.attr}()`")
                add(node, "FL131",
                    f"float fold over unordered {what} iteration in "
                    f"aggregation-reachable `{fi.name}` -- the sum's "
                    "value depends on dict/set arrival order (floats do "
                    "not commute); normalize with `sorted(...)` first "
                    "(the fold_entries_fp64 contract)")
                break
        # shape 2: for-loop over unordered dict iteration with a float
        # `+=` accumulation in the body
        elif isinstance(node, ast.For):
            recv = _dict_iter_attr(node.iter)
            bare = None
            if recv is None:
                name = _iter_name(node.iter)
                if name is not None and _subscripted_by(
                        node.body, name, _target_names(node.target)):
                    bare = name
            if recv is None and bare is None:
                continue
            for stmt in node.body:
                for sub in walk(stmt):
                    if isinstance(sub, ast.AugAssign) \
                            and isinstance(sub.op, ast.Add) \
                            and (_float_evidence(sub.value, env,
                                                 float_attrs)
                                 or (isinstance(sub.target, ast.Name)
                                     and sub.target.id in env)):
                        what = (f"`{bare}`" if bare is not None
                                else f"`.{node.iter.func.attr}()`")
                        add(sub, "FL131",
                            "float `+=` accumulation over unordered "
                            f"{what} iteration in aggregation-reachable "
                            f"`{fi.name}` -- arrival-order float fold "
                            "(the aggregate_reports arrival-order bug); "
                            "iterate `sorted(...)` instead")
                        break
                else:
                    continue
                break


def _clock_calls(fn, time_mods, clock_funcs):
    """Wall-clock read Call nodes in ``fn``."""
    out = []
    for node in walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _CLOCK_ATTRS \
                and isinstance(f.value, ast.Name) \
                and f.value.id in time_mods:
            out.append(node)
        elif isinstance(f, ast.Name) and f.id in clock_funcs:
            out.append(node)
    return out


def _local_clock_taint(fn, time_mods, clock_funcs, attr_taint):
    """Fixpoint local taint for FL132: a local is tainted when assigned
    (or ``+=``-folded) from an expression holding a clock read, an
    already-tainted local, or a clock-tainted ``self.<attr>`` load.
    Returns ``(clock_call_ids, tainted_local_names)``."""
    clock_ids = {id(c) for c in _clock_calls(fn, time_mods, clock_funcs)}
    tainted = set()

    def expr_tainted(expr):
        for n in walk(expr):
            if id(n) in clock_ids:
                return True
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                    and n.id in tainted:
                return True
            if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load) \
                    and _self_attr(n) in attr_taint:
                return True
        return False

    changed = True
    while changed:       # fixpoint: taint through local->local chains
        changed = False
        for node in walk(fn):
            if isinstance(node, ast.Assign) and expr_tainted(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and tgt.id not in tainted:
                        tainted.add(tgt.id)
                        changed = True
            elif isinstance(node, ast.AugAssign) \
                    and isinstance(node.target, ast.Name) \
                    and node.target.id not in tainted \
                    and expr_tainted(node.value):
                tainted.add(node.target.id)
                changed = True
    return clock_ids, tainted


def _class_clock_attrs(rec, time_mods, clock_funcs):
    """Per-class clock-tainted ``self.<attr>`` sets for the FL132
    attribute hop: an attribute is tainted when any method of the class
    stores a clock-derived value into it. Fixpoint over the class so
    attr-to-attr laundering (``self._b = self._a``) converges too."""
    by_class = {}
    for (cls, _name), fi in rec["funcs"].items():
        if cls is not None:
            by_class.setdefault(cls, []).append(fi)
    out = {}
    for cls, methods in by_class.items():
        attrs = set()
        changed = True
        while changed:
            changed = False
            for fi in methods:
                clock_ids, tainted = _local_clock_taint(
                    fi.node, time_mods, clock_funcs, attrs)

                def value_tainted(expr):
                    for n in walk(expr):
                        if id(n) in clock_ids:
                            return True
                        if isinstance(n, ast.Name) \
                                and isinstance(n.ctx, ast.Load) \
                                and n.id in tainted:
                            return True
                        if isinstance(n, ast.Attribute) \
                                and isinstance(n.ctx, ast.Load) \
                                and _self_attr(n) in attrs:
                            return True
                    return False

                for node in walk(fi.node):
                    if not isinstance(node, (ast.Assign, ast.AugAssign)):
                        continue
                    if not value_tainted(node.value):
                        continue
                    targets = (node.targets
                               if isinstance(node, ast.Assign)
                               else [node.target])
                    for tgt in targets:
                        a = _self_attr(tgt)
                        if a is not None and a not in attrs:
                            attrs.add(a)
                            changed = True
        if attrs:
            out[cls] = attrs
    return out


def _check_fl132(fi, time_mods, clock_funcs, add, attr_taint=frozenset()):
    """Wall-clock reads flowing into a control-law decision value --
    directly, through a chain of local bindings (fixpoint taint), or via
    a clock-tainted class attribute stored by a sibling method
    (``attr_taint``, the attribute hop)."""
    fn = fi.node
    clock_ids, tainted = _local_clock_taint(fn, time_mods, clock_funcs,
                                            attr_taint)
    if not clock_ids and not attr_taint:
        return

    def is_decision_value(expr):
        """The expression reaches a decision point if it holds a clock
        read, a tainted local, or a clock-tainted attribute load."""
        for n in walk(expr):
            if id(n) in clock_ids:
                return True
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                    and n.id in tainted:
                return True
            if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load) \
                    and _self_attr(n) in attr_taint:
                return True
        return False

    def flag(node):
        add(node, "FL132",
            f"wall-clock read decides control-law behavior in "
            f"`{fi.name}` -- the steering contract is a deterministic "
            "law (quantized observations in, quantized knobs out; "
            "tests/test_torch_steering.py replays it); feed the clock "
            "through an observation histogram instead of branching on "
            "it")

    flagged = set()     # linenos: an if-test and the Compare inside it
                        # are one decision, not two

    def flag_once(expr, anchor):
        if anchor.lineno not in flagged:
            flagged.add(anchor.lineno)
            flag(anchor)

    for node in walk(fn):
        if isinstance(node, (ast.If, ast.While)) \
                and is_decision_value(node.test):
            flag_once(node.test, node)
        elif isinstance(node, ast.IfExp) and is_decision_value(node.test):
            flag_once(node.test, node)
        elif isinstance(node, ast.Compare) and is_decision_value(node):
            flag_once(node, node)
        elif isinstance(node, ast.Return) and node.value is not None \
                and is_decision_value(node.value):
            flag_once(node.value, node)
        elif isinstance(node, ast.Assign) \
                and any(_self_attr(t) is not None for t in node.targets) \
                and is_decision_value(node.value):
            flag_once(node.value, node)


def _random_receiver(func, rec):
    """Classify a call's receiver as the global ``random`` /
    ``np.random`` stream. Returns the attr name or None."""
    if not isinstance(func, ast.Attribute):
        return None
    v = func.value
    if isinstance(v, ast.Name) and v.id == "random" and rec["has_random"]:
        return func.attr
    if isinstance(v, ast.Attribute) and v.attr == "random" \
            and isinstance(v.value, ast.Name) \
            and v.value.id in ("np", "numpy"):
        return func.attr
    return None


def _torch_attr(func, rec):
    """A call on the ``torch`` module (``torch.rand``, or one level down,
    ``torch.cuda.manual_seed``): the called attr name, else None."""
    if not isinstance(func, ast.Attribute):
        return None
    v = func.value
    if isinstance(v, ast.Attribute):
        v = v.value
    if isinstance(v, ast.Name) and v.id in rec["torch_names"]:
        return func.attr
    return None


def _is_constant_expr(expr):
    return isinstance(expr, ast.Constant) or (
        isinstance(expr, ast.UnaryOp)
        and isinstance(expr.operand, ast.Constant))


def _check_fl133(fi, rec, add):
    """Unseeded/constant-seeded randomness on cohort/fault/trace paths."""
    fn = fi.node
    # reseeds legalize later global draws in the same function (the
    # historical `np.random.seed(attempt_seed(...))` cohort idiom). A
    # CONSTANT reseed suppresses them too -- it is flagged itself below,
    # and one finding at the root cause beats one per downstream draw.
    reseed_lines = []
    for node in walk(fn):
        if isinstance(node, ast.Call) and node.args and (
                _random_receiver(node.func, rec) == "seed"
                or _torch_attr(node.func, rec) in _TORCH_SEED_ATTRS):
            reseed_lines.append(node.lineno)
    for node in walk(fn):
        if not isinstance(node, ast.Call):
            continue
        attr = _random_receiver(node.func, rec)
        f = node.func
        if attr in _RANDOM_DRAW_ATTRS:
            if not any(ln <= node.lineno for ln in reseed_lines):
                add(node, "FL133",
                    f"global `{_dotted(f)}` draw in `{fi.name}` without "
                    "a derived reseed -- cohort/fault/trace draws must "
                    "derive from SeedSequence spawns or the program's "
                    "attempt_seed (np.random.seed(attempt_seed(...)) "
                    "before the draw, or a seeded Generator)")
        elif attr == "seed" and node.args \
                and _is_constant_expr(node.args[0]):
            add(node, "FL133",
                f"constant seed in `{fi.name}` -- every round replays "
                "the identical draw; derive the seed from attempt_seed "
                "or a SeedSequence spawn")
        elif attr == "default_rng":
            if not node.args or _is_constant_expr(node.args[0]):
                add(node, "FL133",
                    f"`default_rng({'' if not node.args else '<const>'})`"
                    f" in `{fi.name}` -- an unseeded generator is "
                    "irreproducible and a constant one replays; pass a "
                    "SeedSequence spawn or a derived seed")
        elif isinstance(f, ast.Attribute) and f.attr in _TORCH_SEED_ATTRS:
            if node.args and _is_constant_expr(node.args[0]):
                add(node, "FL133",
                    f"constant `{f.attr}` in `{fi.name}` -- every round "
                    "replays the identical draw; seed the generator from "
                    "attempt_seed or a SeedSequence spawn, not a literal")
        elif _torch_attr(f, rec) in _TORCH_DRAW_ATTRS \
                and not any(kw.arg == "generator" for kw in node.keywords):
            if not any(ln <= node.lineno for ln in reseed_lines):
                add(node, "FL133",
                    f"global `{_dotted(f)}` draw in `{fi.name}` without "
                    "a derived reseed -- cohort/fault/trace draws must "
                    "derive from SeedSequence spawns or the program's "
                    "attempt_seed (pass a `generator=` seeded from it, "
                    "or torch.manual_seed(attempt_seed(...)) before the "
                    "draw)")


def _dotted(func):
    parts = []
    node = func
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _check_fl134(fi, add, float_attrs=frozenset()):
    """Float accumulation in a handler-thread-reachable scope."""
    if fi.name in _FL134_EXEMPT_FUNCS \
            or fi.cls in _FL134_EXEMPT_CLASSES \
            or _match(fi.path, _FL134_EXEMPT_PATHS):
        return
    where = (f"`{fi.cls}.{fi.name}`" if fi.cls is not None
             else f"`{fi.name}`")
    env = _float_env(fi.node, float_attrs)
    for node in walk(fi.node):
        if isinstance(node, ast.AugAssign) and isinstance(node.op, ast.Add) \
                and _float_evidence(node.value, env, float_attrs):
            add(node, "FL134",
                f"float `+=` accumulation in handler-thread-reachable "
                f"{where} -- handlers run in network arrival order, so "
                "this fold's value depends on the schedule. Buffer the "
                "entries and fold through program.fold_entries_fp64 / "
                "BufferedAggregator (sorted-key fp64) instead")


def _unsorted_json_call(node):
    """``json.dump``/``json.dumps`` without an effective
    ``sort_keys=True`` -> the attr name (``dump``/``dumps``), else
    None."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if not (isinstance(f, ast.Attribute)
            and f.attr in ("dump", "dumps")
            and isinstance(f.value, ast.Name) and f.value.id == "json"):
        return None
    sk = next((kw for kw in node.keywords if kw.arg == "sort_keys"),
              None)
    if sk is not None and not (isinstance(sk.value, ast.Constant)
                               and sk.value.value is False):
        return None
    return f.attr


def _check_fl135_json(fi_or_tree, module_funcs, add):
    """json.dump/dumps without sort_keys=True (scope-gated by path)."""
    for node in walk(fi_or_tree):
        attr = _unsorted_json_call(node)
        if attr is None:
            continue
        add(node, "FL135",
            f"`json.{attr}` without `sort_keys=True` on a manifest/"
            "status/wire-adjacent path -- dict insertion order is a "
            "program accident, not a contract; two writers of the same "
            "logical record must produce identical bytes")


def _is_dict_expr(expr):
    return isinstance(expr, ast.Dict) or (
        isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name)
        and expr.func.id == "dict")


def _fl135_is_producer(fi):
    """A manifest producer: a module-level function that returns a dict
    it built (a dict display / ``dict(...)`` call, directly or through a
    local)."""
    dict_locals = set()
    for node in walk(fi.node):
        if isinstance(node, ast.Assign) and _is_dict_expr(node.value):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    dict_locals.add(tgt.id)
    for node in walk(fi.node):
        if isinstance(node, ast.Return) and node.value is not None:
            if _is_dict_expr(node.value):
                return True
            if isinstance(node.value, ast.Name) \
                    and node.value.id in dict_locals:
                return True
    return False


def _fl135_producers(index):
    """(module, funcs-key) set of manifest producers defined in
    FL135-scoped modules -- the cross-function tracking roots."""
    producers = set()
    for mod, rec in index.modules.items():
        if not _match(rec["path"], _FL135_JSON_PATHS):
            continue
        for key, fi in rec["funcs"].items():
            if key[0] is None and _fl135_is_producer(fi):
                producers.add((mod, key))
    return producers


def _check_fl135_cross(fi, mod, index, producers, add):
    """Cross-function dict-order tracking: in an *unscoped* module, an
    unsorted ``json.dump(s)`` whose payload traces (directly or through
    one local binding) to a call of a manifest producer defined in a
    scoped module. The record is a manifest no matter which module
    serializes it."""
    fn = fi.node

    def producer_call(expr):
        if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name):
            tgt = index.resolve_func(mod, expr.func.id)
            if tgt is not None and tgt in producers:
                return expr.func.id
        return None

    prod_locals = {}
    for node in walk(fn):
        if isinstance(node, ast.Assign):
            name = producer_call(node.value)
            if name is not None:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        prod_locals[tgt.id] = name
    for node in walk(fn):
        attr = _unsorted_json_call(node)
        if attr is None or not node.args:
            continue
        arg = node.args[0]
        src = producer_call(arg)
        if src is None and isinstance(arg, ast.Name):
            src = prod_locals.get(arg.id)
        if src is None:
            continue
        add(node, "FL135",
            f"`json.{attr}` without `sort_keys=True` serializes the "
            f"manifest built by `{src}` (a scoped manifest producer) -- "
            "the record stays a manifest wherever it is written; two "
            "writers of the same logical record must produce identical "
            "bytes")


def _check_fl135_listings(tree, add):
    """Unsorted os.listdir/glob enumeration anywhere in the module."""
    sorted_args = set()       # ids of calls wrapped in sorted(...)
    sorted_names = set()      # locals later normalized with .sort()
    listing_assigns = {}      # local name -> listing call node
    for node in walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "sorted" and node.args:
            for sub in walk(node.args[0]):
                sorted_args.add(id(sub))
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "sort" \
                and isinstance(node.func.value, ast.Name):
            sorted_names.add(node.func.value.id)
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and _is_listing_call(node.value):
            listing_assigns[id(node.value)] = node.targets[0].id
    for node in walk(tree):
        if not _is_listing_call(node) or id(node) in sorted_args:
            continue
        local = listing_assigns.get(id(node))
        if local is not None and local in sorted_names:
            continue
        add(node, "FL135",
            f"`{_dotted(node.func)}(...)` result used without "
            "`sorted(...)` -- directory enumeration order is "
            "filesystem-dependent, so anything derived from it "
            "(party order, manifest rows, shard assignment) varies "
            "across hosts; wrap the call in sorted()")


def _is_listing_call(node):
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _LISTING_ATTRS):
        return False
    v = node.func.value
    # os.listdir / os.scandir / glob.glob / glob.iglob / <path>.glob /
    # <path>.iterdir -- but NOT <string>.glob-alikes on arbitrary calls
    if isinstance(v, ast.Name) and v.id in ("os", "glob"):
        return True
    return node.func.attr in ("glob", "iterdir")


def check_determinism(index, emit):
    """Run FL131-FL135 over every module in ``index``. ``emit(module,
    node, code, message)`` receives each finding."""
    agg_reach = index.aggregation_reach()
    handler_reach = index.handler_reach()
    producers = _fl135_producers(index)
    for mod, rec in sorted(index.modules.items()):
        path = rec["path"]
        tree = rec["tree"]

        def add(node, code, message, _mod=mod):
            emit(_mod, node, code, message)

        # clock aliases for FL132 (module-level import scan)
        time_mods, clock_funcs = set(), set()
        for node in walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "time":
                        time_mods.add(a.asname or "time")
            elif isinstance(node, ast.ImportFrom) and node.module == "time":
                for a in node.names:
                    if a.name in _CLOCK_ATTRS:
                        clock_funcs.add(a.asname or a.name)

        fl132_scope = _match(path, _FL132_PATHS)
        fl133_scope = _match(path, _FL133_PATHS)
        fl135_scope = _match(path, _FL135_JSON_PATHS)
        attr_taint = (_class_clock_attrs(rec, time_mods, clock_funcs)
                      if fl132_scope else {})
        float_attrs = _dataclass_float_fields(tree)

        for key, fi in sorted(rec["funcs"].items(),
                              key=lambda kv: kv[1].node.lineno):
            if (mod, key) in agg_reach:
                _check_fl131(fi, add, float_attrs)
            if fl132_scope:
                _check_fl132(fi, time_mods, clock_funcs, add,
                             attr_taint.get(fi.cls, frozenset()))
            if fl133_scope:
                _check_fl133(fi, rec, add)
            if (mod, key) in handler_reach:
                _check_fl134(fi, add, float_attrs)
            if fl135_scope:
                _check_fl135_json(fi.node, rec["funcs"], add)
            else:
                _check_fl135_cross(fi, mod, index, producers, add)
        _check_fl135_listings(tree, add)


__all__ = ["DeterminismIndex", "check_determinism"]
