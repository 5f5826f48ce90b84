"""fedcheck privacy pass (fedpriv): information-flow verification of the
trust boundary (FL150-FL153); the port's copy of
``fedml_tpu/analysis/privacy.py``, with taint carried through torch's
shape-preserving calls and torch ``Generator`` seeding read for FL151.

The resilience stack is built so that per-client raw material (params,
deltas, gradients read out of a report payload) only ever crosses the
trust boundary after passing through a *sanitizer*: the DP leg
(clip-then-noise, ``program.privacy.DPPolicy``), the secure-aggregation
masking path (``core.mpc``), the wire codec, or a quorum-gated fold.
This pass checks that discipline statically, as a small interprocedural
taint analysis over the ast that :class:`analysis.protocol.ProtocolIndex`
already holds -- no new index, same single-parse budget.

The model:

- **sources** -- per-client raw material: reads of material payload keys
  (``msg.get("params")``, ``msg.get(WIRE_DELTA_KEY)``, subscripts) inside
  FSM handler methods, and results of ``self.*payload*`` helpers fed the
  message.
- **sinks** -- trust-boundary escapes that serialize outside the
  aggregation path: ``logging.*``, ``json.dump(s)``, metrics/telemetry
  and flight-recorder calls (``observe``/``record``/``event``/
  ``status_update``/``set``/``inc``).
- **sanitizers** -- the DP leg, MPC masking, the codec, the fold.
  Taint deliberately does NOT propagate through arbitrary call results:
  a call is a sanitization opportunity, so only an explicit whitelist of
  shape-preserving builtins/methods carries taint through. This keeps
  the pass zero-baseline on the real tree (e.g. the async server logging
  ``self.agg.fold(...)``'s returned depth is clean) at the cost of
  missing taint laundered through helper functions -- a documented
  soundness limit, same trade the crossclass pass makes.

Rules:

- **FL150**: in a server-role FSM method, material read from a report
  payload reaches a telemetry/manifest sink. Telemetry must carry
  sanitized aggregates or scalar metadata only.
- **FL151**: DP ordering defects in ``*privacy*`` modules -- a clip-ish
  call consuming a noise-ish result (noise-before-clip voids the
  sensitivity bound the noise scale is calibrated to), or a noise draw
  on an rng that is not a derived stream (``*rng(...)`` /
  ``default_rng(<non-constant key>)`` / a torch ``Generator`` bound by
  ``.manual_seed(<non-constant key>)``, drawn from as ``rng.normal(...)``
  or through ``generator=rng``) -- underived noise is either
  unreplayable or constant-across-calls.
- **FL152**: secure-agg commutation defects in ``*mpc*``/``*mask*``/
  ``*secagg*``/``*turboaggregate*`` modules -- field encode/quantize of
  an already-masked value, or additive/BGW reconstruction of
  float-domain (dequantized) partials. Masking only cancels in the
  field domain; either order swap silently corrupts the aggregate or
  voids secrecy.
- **FL153**: a client-role FSM that declares a DP leg (``dp``
  constructor param or ``self.dp``) has a method that ``.add()``s
  material to an outbound message with no ``*privatize*`` call
  reachable through its same-class ``self.*()`` call closure -- the
  sanitizer is declared but bypassed on that send path.

Soundness limits (deliberate, documented): intraprocedural taint plus a
same-class call closure for FL153 only; no aliasing through attributes
or containers mutated via method calls; FL151/FL152 recognize the
sanitizer families by name. The revert-mutation fixtures in
``tests/test_torch_fedcheck_mutations.py`` pin that each rule still
catches its seeded defect on the port's own files.
"""

from __future__ import annotations

import ast
from fnmatch import fnmatch

from fedml_tpu_torch.analysis.astwalk import walk
from fedml_tpu_torch.analysis.protocol import (
    FSM_ROOTS,
    _LOG_ATTRS,
    _LOG_ROOTS,
    _merge_role,
)

# ---------------------------------------------------------------------------
# vocabulary

#: payload keys that carry per-client raw update material over the wire
#: (the codec's WIRE_DELTA_KEY is "cdelta"; sync/report payloads use
#: "params"). Resolved constants are followed; in single-file runs an
#: unresolvable constant NAME matching _MATERIAL_NAME_FRAGMENTS is
#: credited so fixtures behave identically to whole-tree runs.
_MATERIAL_KEYS = frozenset({
    "params", "cdelta", "delta", "update", "weights",
    "grads", "gradients", "model", "state",
})
_MATERIAL_NAME_FRAGMENTS = ("DELTA", "PARAM", "UPDATE", "GRAD", "WEIGHT")

#: calls whose result keeps the argument's taint (shape/identity
#: preserving); everything else is treated as a sanitization opportunity.
#: torch's conversions and concatenation (``torch.as_tensor``/``tensor``/
#: ``from_numpy``/``cat``) carry it as numpy's do.
_PRESERVE_CALLS = frozenset({
    "asarray", "array", "dict", "list", "tuple", "sorted", "reversed",
    "abs", "copy", "deepcopy", "stack",
    "as_tensor", "tensor", "from_numpy", "cat",
})
#: <tainted>.m(...) method results that keep the receiver's taint; the
#: torch tensor's copies, moves and views (``payload.detach().cpu()``)
#: are the same material.
_PRESERVE_METHODS = frozenset({
    "items", "values", "keys", "copy", "astype",
    "flatten", "ravel", "reshape", "get",
    "detach", "cpu", "clone", "numpy", "tolist", "to", "float",
    "contiguous", "view",
})

#: telemetry-ish method names whose call with a tainted argument is an
#: FL150 escape (metrics registries, flight recorder, status writer,
#: tracer spans).
_TELEMETRY_ATTRS = frozenset({
    "observe", "record", "event", "status_update", "set", "inc",
})

_FL151_SCOPE = ("*privacy*",)
_FL152_SCOPE = ("*mpc*", "*turboaggregate*", "*secagg*", "*mask*")

#: mask-family producers (their result lives in the masked/shared field
#: domain) and the un-mask consumers that must see field-domain inputs.
_MASK_CALLS = frozenset({"additive_shares", "bgw_encode", "secure_aggregate"})
_FIELD_ENCODE_CALLS = frozenset({"quantize", "encode", "ef_step"})
_UNMASK_CALLS = frozenset({"reconstruct_additive", "bgw_decode"})
_FIELD_DECODE_CALLS = frozenset({"dequantize", "decode"})

#: rng-draw method names (mirrors determinism's FL133 vocabulary).
_DRAW_ATTRS = frozenset({
    "standard_normal", "normal", "uniform", "integers", "random",
    "choice", "permutation", "shuffle",
})

_MSG_PARAM_NAMES = frozenset({"msg", "message", "msg_params"})


# ---------------------------------------------------------------------------
# small ast helpers

def _short_name(func):
    """Trailing identifier of a call target (``a.b.c(...)`` -> ``c``)."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _call_args(node):
    return list(node.args) + [kw.value for kw in node.keywords]


def _walk_funcs(tree):
    for node in walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _match_mod(module, patterns):
    return any(fnmatch(module, p) for p in patterns)


def _local_names(func):
    """Every name the function binds locally (assignments, loop and
    comprehension targets, with-as): a key NAME bound here is runtime
    data, not a module-level wire constant."""
    return {node.id for node in walk(func)
            if isinstance(node, ast.Name) and
            isinstance(node.ctx, ast.Store)}


def _material_key(index, module, expr, local_names=frozenset()):
    """The material key a key-expression denotes, or None. Follows
    module constants via the protocol index; falls back to crediting
    SCREAMING_CASE names that look material when the constant's home
    module is not indexed (single-file lint runs). Locally bound names
    are never credited -- a loop/assignment target is opaque data even
    when it is spelled like a wire constant."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value if expr.value in _MATERIAL_KEYS else None
    name = None
    if isinstance(expr, ast.Name):
        if expr.id in local_names:
            return None
        name = expr.id
    elif isinstance(expr, ast.Attribute):
        name = expr.attr
    if name is None:
        return None
    val = index.resolve_const(module, name)
    if val is not None:
        return val if val in _MATERIAL_KEYS else None
    if name.isupper() and any(f in name for f in _MATERIAL_NAME_FRAGMENTS):
        return name
    return None


# ---------------------------------------------------------------------------
# the taint engine

class _Taint:
    """Fixpoint local-name taint for one function body.

    ``is_source(expr) -> bool`` seeds taint; propagation covers
    assignments, aug-assignments, for/comprehension targets, and the
    data-shaping expression forms plus the preserve whitelists above.
    Arbitrary call results are UNTAINTED by design (see module doc)."""

    def __init__(self, fn, is_source):
        self.fn = fn
        self.is_source = is_source
        self.tainted = set()
        self._fixpoint()

    def _fixpoint(self):
        changed = True
        while changed:
            changed = False
            for node in walk(self.fn):
                targets = None
                if isinstance(node, ast.Assign) and self.expr(node.value):
                    targets = node.targets
                elif isinstance(node, ast.AugAssign) and (
                        self.expr(node.value) or self.expr(node.target)):
                    targets = [node.target]
                elif isinstance(node, (ast.For, ast.AsyncFor)) and \
                        self.expr(node.iter):
                    targets = [node.target]
                elif isinstance(node, ast.comprehension) and \
                        self.expr(node.iter):
                    targets = [node.target]
                if not targets:
                    continue
                for tgt in targets:
                    for sub in walk(tgt):
                        if isinstance(sub, ast.Name) and \
                                sub.id not in self.tainted:
                            self.tainted.add(sub.id)
                            changed = True

    def expr(self, node):
        if node is None:
            return False
        if self.is_source(node):
            return True
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Call):
            name = _short_name(node.func)
            if name in _PRESERVE_CALLS:
                return any(self.expr(a) for a in _call_args(node))
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _PRESERVE_METHODS:
                return self.expr(node.func.value)
            return False
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self.expr(node.elt) or \
                any(self.expr(g.iter) for g in node.generators)
        if isinstance(node, ast.DictComp):
            return self.expr(node.key) or self.expr(node.value) or \
                any(self.expr(g.iter) for g in node.generators)
        if isinstance(node, ast.BinOp):
            return self.expr(node.left) or self.expr(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.expr(node.operand)
        if isinstance(node, ast.IfExp):
            return self.expr(node.body) or self.expr(node.orelse)
        if isinstance(node, (ast.Subscript, ast.Attribute, ast.Starred)):
            return self.expr(node.value)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.expr(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(self.expr(v) for v in node.values if v is not None)
        return False


def _named_call_source(families):
    """is_source over call results whose short name matches a family
    (exact set membership)."""
    def is_source(node):
        return isinstance(node, ast.Call) and \
            _short_name(node.func) in families
    return is_source


# ---------------------------------------------------------------------------
# class-role plumbing (shared with the protocol pass's model)

def _class_role(index, module, cls):
    role = None
    for base in cls.bases:
        if base is None:
            continue
        if base in FSM_ROOTS:
            role = _merge_role(role, FSM_ROOTS[base])
        else:
            role = _merge_role(role, index.fsm_role(module, base))
    return role


def _class_methods(info, cls_name):
    for node in info.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls_name:
            return {m.name: m for m in node.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
    return {}


# ---------------------------------------------------------------------------
# FL150: raw material -> telemetry/manifest sink in server-role FSMs

def _is_log_call(node):
    if not isinstance(node.func, ast.Attribute):
        return False
    if node.func.attr not in _LOG_ATTRS:
        return False
    root = node.func.value
    while isinstance(root, ast.Attribute):
        root = root.value
    return isinstance(root, ast.Name) and root.id in _LOG_ROOTS


def _is_json_dump(node):
    return isinstance(node.func, ast.Attribute) and \
        node.func.attr in ("dump", "dumps") and \
        isinstance(node.func.value, ast.Name) and \
        node.func.value.id == "json"


def _is_telemetry_call(node):
    return isinstance(node.func, ast.Attribute) and \
        node.func.attr in _TELEMETRY_ATTRS


def _sink_label(node):
    if _is_log_call(node):
        return "logging.%s" % node.func.attr
    if _is_json_dump(node):
        return "json.%s" % node.func.attr
    return ".%s(...)" % node.func.attr


def _material_source_pred(index, module, msg_names, local_names):
    def is_source(node):
        if isinstance(node, ast.Subscript) and \
                isinstance(node.value, ast.Name) and \
                node.value.id in msg_names:
            return _material_key(index, module, node.slice,
                                 local_names) is not None
        if not isinstance(node, ast.Call):
            return False
        func = node.func
        if isinstance(func, ast.Attribute) and \
                isinstance(func.value, ast.Name) and \
                func.value.id in msg_names:
            if func.attr == "get" and node.args:
                return _material_key(index, module, node.args[0],
                                     local_names) is not None
            if func.attr == "get_params":
                return True
        # self._report_payload(msg) and friends: the decoded material dict
        if isinstance(func, ast.Attribute) and "payload" in func.attr:
            return any(isinstance(a, ast.Name) and a.id in msg_names
                       for a in _call_args(node))
        return False
    return is_source


def _check_fl150(index, module, info, emit):
    for cls_name, cls in sorted(info.classes.items()):
        if _class_role(index, module, cls) not in ("server", "both"):
            continue
        for meth in _class_methods(info, cls_name).values():
            msg_names = {a.arg for a in meth.args.args
                         if a.arg in _MSG_PARAM_NAMES}
            if not msg_names:
                continue
            taint = _Taint(meth, _material_source_pred(
                index, module, msg_names, _local_names(meth)))
            for node in walk(meth):
                if not isinstance(node, ast.Call):
                    continue
                if not (_is_log_call(node) or _is_json_dump(node) or
                        _is_telemetry_call(node)):
                    continue
                if any(taint.expr(a) for a in _call_args(node)):
                    emit(module, node, "FL150",
                         "%s.%s: per-client update material from the "
                         "report payload reaches %s -- a telemetry/"
                         "manifest escape outside the trust boundary. "
                         "Log/record only sanitized aggregates (fold/"
                         "privatize/encode outputs) or scalar metadata "
                         "(round, rank, sizes), never raw client "
                         "tensors" % (cls_name, meth.name,
                                      _sink_label(node)))
                    break  # one finding per method is enough signal


# ---------------------------------------------------------------------------
# FL151: DP ordering / underived noise stream

def _is_noise_call(node):
    if not isinstance(node, ast.Call):
        return False
    name = _short_name(node.func)
    if name is None:
        return False
    return name == "noise" or name == "add_gaussian_noise" or \
        (name.endswith("noise") and not name.endswith("rng"))


def _is_clip_call(node):
    if not isinstance(node, ast.Call):
        return False
    name = _short_name(node.func)
    return name is not None and "clip" in name


def _rng_binding_derived(fn, receiver):
    """True/False when the local rng's binding call is classifiable,
    None when unknown (judge nothing). A torch ``Generator`` bound
    through ``.manual_seed(<key>)`` is judged as ``default_rng(<key>)``
    is: derived unless every argument is a constant."""
    verdict = None
    for node in walk(fn):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        tgt = node.targets[0]
        if not (isinstance(tgt, ast.Name) and tgt.id == receiver):
            continue
        if not isinstance(node.value, ast.Call):
            return None
        name = _short_name(node.value.func)
        if name is None:
            return None
        if name.endswith("rng") and name != "default_rng":
            verdict = True  # mask_rng / noise_rng / encode_rng family
        elif name in ("default_rng", "manual_seed"):
            args = _call_args(node.value)
            verdict = bool(args) and not all(
                isinstance(a, ast.Constant) for a in args)
        else:
            return None
    return verdict


def _draw_receiver(node):
    """The local name a draw reads its stream from: ``rng`` in
    ``rng.standard_normal(...)``, or in any ``...(generator=rng)``
    (torch's draws take their ``Generator`` as a keyword;
    ``torch.normal(..., generator=rng)`` reads ``rng``, not ``torch``)."""
    for kw in node.keywords:
        if kw.arg == "generator" and isinstance(kw.value, ast.Name):
            return kw.value.id
    if isinstance(node.func, ast.Attribute) and \
            node.func.attr in _DRAW_ATTRS and \
            isinstance(node.func.value, ast.Name):
        return node.func.value.id
    return None


def _check_fl151(fn, module, emit):
    taint = _Taint(fn, _is_noise_call)
    for node in walk(fn):
        if not isinstance(node, ast.Call):
            continue
        if _is_clip_call(node) and not _is_noise_call(node) and \
                any(taint.expr(a) for a in _call_args(node)):
            emit(module, node, "FL151",
                 "%s: clipping a noised value -- the DP leg must clip "
                 "FIRST (bounding per-client sensitivity) and add "
                 "calibrated noise to the clipped value; noise-before-"
                 "clip voids the (epsilon, delta) accounting the noise "
                 "scale was calibrated to" % fn.name)
            continue
        receiver = _draw_receiver(node)
        if receiver is not None:
            derived = _rng_binding_derived(fn, receiver)
            if derived is False:
                emit(module, node, "FL151",
                     "%s: noise draw on an underived rng -- bind the "
                     "generator from a keyed derived stream "
                     "(noise_rng/mask_rng/encode_rng over (rank, round, "
                     "attempt)); an unseeded or constant default_rng "
                     "(or a constant-seeded torch Generator) is either "
                     "unreplayable or reuses the identical stream every "
                     "call" % fn.name)


# ---------------------------------------------------------------------------
# FL152: mask/codec commutation

def _check_fl152(fn, module, emit):
    mask_taint = _Taint(fn, _named_call_source(_MASK_CALLS))
    float_taint = _Taint(fn, _named_call_source(_FIELD_DECODE_CALLS))
    for node in walk(fn):
        if not isinstance(node, ast.Call):
            continue
        name = _short_name(node.func)
        if name in _FIELD_ENCODE_CALLS and \
                any(mask_taint.expr(a) for a in _call_args(node)):
            emit(module, node, "FL152",
                 "%s: field-encoding an already-masked/shared value -- "
                 "quantization does not commute with masking; shares "
                 "must be produced FROM field-domain (quantized) "
                 "secrets, or the masks no longer cancel on "
                 "reconstruction" % fn.name)
        elif name in _UNMASK_CALLS and \
                any(float_taint.expr(a) for a in _call_args(node)):
            emit(module, node, "FL152",
                 "%s: reconstructing from float-domain (dequantized) "
                 "partials -- modular reconstruction is exact only over "
                 "field elements; dequantize strictly AFTER the final "
                 "reconstruct, or rounding corrupts the aggregate "
                 "silently" % fn.name)


# ---------------------------------------------------------------------------
# FL153: declared DP leg bypassed on a material send path

def _declares_dp(methods):
    init = methods.get("__init__")
    if init is not None and any(a.arg == "dp" for a in init.args.args):
        return True
    for meth in methods.values():
        for node in walk(meth):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute) and \
                            tgt.attr == "dp" and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id == "self":
                        return True
    return False


def _contains_privatize(meth):
    for node in walk(meth):
        if isinstance(node, ast.Call):
            name = _short_name(node.func)
            if name is not None and "privatize" in name:
                return True
    return False


def _self_callees(meth):
    out = set()
    for node in walk(meth):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id == "self":
            out.add(node.func.attr)
    return out


def _privatize_reachable(meth, methods):
    seen = set()
    frontier = [meth]
    while frontier:
        cur = frontier.pop()
        if cur.name in seen:
            continue
        seen.add(cur.name)
        if _contains_privatize(cur):
            return True
        for callee in _self_callees(cur):
            if callee in methods and callee not in seen:
                frontier.append(methods[callee])
    return False


def _material_adds(index, module, meth):
    adds = []
    local = _local_names(meth)
    for node in walk(meth):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "add" and len(node.args) >= 2 and \
                _material_key(index, module, node.args[0],
                              local) is not None:
            adds.append(node)
    return adds


def _check_fl153(index, module, info, emit):
    for cls_name, cls in sorted(info.classes.items()):
        if _class_role(index, module, cls) not in ("client", "both"):
            continue
        methods = _class_methods(info, cls_name)
        if not _declares_dp(methods):
            continue
        for name in sorted(methods):
            meth = methods[name]
            adds = _material_adds(index, module, meth)
            if not adds:
                continue
            if _privatize_reachable(meth, methods):
                continue
            # one finding per send path (method), anchored at the first
            # material add -- a multi-key payload is still one bypass
            emit(module, adds[0], "FL153",
                 "%s.%s: client update material is added to an outbound "
                 "message with no privatize call on the path, but this "
                 "FSM declares a DP leg (dp) -- the sanitizer is "
                 "declared and then bypassed. Route the payload through "
                 "self.dp.privatize*/privatize_params before .add(), "
                 "BEFORE the codec (noise must precede lossy "
                 "compression)" % (cls_name, name))


# ---------------------------------------------------------------------------
# entry point

def check_privacy(index, emit):
    """Run FL150-FL153 over a :class:`ProtocolIndex`.

    ``emit(module, node, code, message)`` mirrors the other pass
    drivers; module keys come straight from the index so findings land
    on the right file in both whole-tree and single-file runs."""
    for module in sorted(index.modules):
        info = index.modules[module]
        _check_fl150(index, module, info, emit)
        _check_fl153(index, module, info, emit)
        if _match_mod(module, _FL151_SCOPE):
            for fn in _walk_funcs(info.tree):
                _check_fl151(fn, module, emit)
        if _match_mod(module, _FL152_SCOPE):
            for fn in _walk_funcs(info.tree):
                _check_fl152(fn, module, emit)
