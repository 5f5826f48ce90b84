"""fedlint core for the port: AST rules for PyTorch/CUDA and FL antipatterns.

Pure stdlib (``ast`` + ``tokenize``): linting must run on hosts with no
accelerator and must never import the code under analysis. Each rule has a
stable ``FL1xx`` code, the reference's (``fedml_tpu/analysis/linter.py``);
findings can be suppressed per line (``# fedlint: disable=FL101``) or per
file (``# fedlint: disable-file=FL101`` in the module header), and a JSON
baseline makes the gate incremental -- pre-existing findings are
tolerated, new ones fail the build.

The reference keys its device-code rules on ``jax.jit``. Their torch
counterpart is the **traced site**: a function that torch traces or
captures into a program -- ``torch.compile`` (decorator, call, or through
``functools.partial``), ``torch.jit.script``/``torch.jit.trace``,
``torch.cuda.make_graphed_callables``, and the body of a ``with
torch.cuda.graph(...)`` block. Inside one, a host sync is a graph break
or a capture error, a Python scalar is a recompile, and a closed-over
tensor is frozen into the program. The detection is syntactic, as the
reference's: a closure returned from a builder and compiled by the
caller is not seen.

Two reference rules have no torch meaning and are never reported: FL104
(torch has no buffer donation) and FL111 (torch has no ``lax.scan``
carry). FL110 keeps its code with the torch hazard closest to a use
after donation: reading a CUDA-graph output after the next replay
overwrote it (:mod:`fedml_tpu_torch.analysis.dataflow`). The reference's
project-wide passes (protocol, cross-class, determinism, model checking,
privacy) are not part of the port yet (ROADMAP A16b (ii)); naming one
of their codes in the CLI's ``--select``/``--ignore`` is a usage error
(:func:`unported_codes`).
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from collections import Counter
from dataclasses import dataclass, field
from fnmatch import fnmatch

_NO_TORCH_MEANING = "no torch meaning; the port never reports it: "

#: Rule catalog: code -> (title, rationale); ``fedlint --list-rules``
#: prints it. Holds exactly the codes the port runs.
RULES = {
    "FL101": (
        "host-device sync inside a traced function",
        "`.item()`, `.tolist()`, `.cpu()`, `.numpy()`, `float()/int()/"
        "bool()` of a tensor, `np.asarray`/`np.array`, or "
        "`torch.cuda.synchronize()` inside a `torch.compile`d, scripted, "
        "traced or CUDA-graph-captured function forces a blocking "
        "device->host transfer: a graph break under dynamo, a constant "
        "baked in by `torch.jit.trace`, a capture error inside "
        "`torch.cuda.graph`."),
    "FL102": (
        "Python control flow on a tensor inside a traced function",
        "`if`/`while`/`for` over a traced function's tensor argument "
        "syncs to read the value: dynamo breaks the graph there, "
        "`torch.jit.trace` bakes in the branch it saw, and CUDA-graph "
        "capture fails. Use `torch.where`/`torch.cond`, or pass the "
        "value as a Python scalar."),
    "FL103": (
        "torch.compile over Python-scalar params",
        "a `torch.compile`d function whose signature takes Python scalars "
        "(bool/int/str annotations or defaults) guards on each value: "
        "every new value compiles a new graph (ints until dynamo marks "
        "them dynamic, bools and strings always), and past dynamo's "
        "cache size limit the function silently runs eagerly. Pass "
        "`dynamic=True` (ints become symbolic) or make the scalar a "
        "tensor."),
    "FL104": (
        "aggregation-path jit without donate_argnums",
        _NO_TORCH_MEANING + "torch has no buffer donation (an eager "
        "update step writes in place or frees the old state when its "
        "last reference drops), so there is no donate_argnums to "
        "forget, and the port has no donation fixer (no `--fix`)."),
    "FL105": (
        "NumPy interop inside a traced function",
        "`np.*` ops on traced tensors pull them to the host and compute "
        "in float64 (a graph break under dynamo, a baked constant under "
        "`torch.jit.trace`, a capture error in a CUDA graph). Use the "
        "`torch` equivalent; `np.float64` dtypes do not belong in device "
        "code."),
    "FL106": (
        "unordered dict iteration feeding pytree construction",
        "`.values()`/`.keys()`/`.items()` order is insertion order -- which "
        "differs across processes when dicts come from JSON/argparse/"
        "checkpoint restores; feeding it into `torch.stack`/`torch.cat`/"
        "`tree_map`/`tree_unflatten` builds rank-dependent trees that "
        "desync collective programs. Wrap in `sorted(...)`."),
    "FL107": (
        "broad exception handler in comm/transport code",
        "`except:`/`except Exception:` in transport or codec paths turns "
        "wire corruption, version skew, and peer death into silent round "
        "corruption. Catch the specific decode/socket error types and log."),
    "FL108": (
        "debug output left in library code",
        "`print(...)` and `breakpoint()` in library modules bypass the "
        "logging config (and a `.debug.print` host callback in a traced "
        "program is a per-step device->host sync)."),
    "FL109": (
        "sharded step with every operand placed replicated",
        "a function whose every `global_put` "
        "(`fedml_tpu_torch/parallel/multihost.py`) places its tree with "
        "the replicating spec `()` (or `replicated_sharding(mesh)`, or "
        "no spec) pays the mesh's collective plumbing while every rank "
        "computes the full arrays. Put the cohort/batch operands on the "
        "`clients` (or another mesh) axis (`client_sharding(mesh)`), or "
        "drop the mesh."),
    "FL110": (
        "use of a CUDA-graph output after the next replay",
        "a graphed callable (`torch.cuda.make_graphed_callables`, "
        "`torch.compile(mode='reduce-overhead'|'max-autotune')`, a "
        "`torch.cuda.CUDAGraph`'s static outputs) returns its graph's "
        "static output buffers: the next call (replay) overwrites them "
        "in place. A result read after that call silently holds the new "
        "values. `.clone()` what must outlive the next call, or rebind "
        "the result (`out = g(x)`)."),
    "FL111": (
        "lax.scan carry initialized from a weak-typed Python scalar",
        _NO_TORCH_MEANING + "torch has no `lax.scan` and no weak-typed "
        "carry; a Python loop's accumulator takes the dtype of what it "
        "is assigned."),
    "FL112": (
        "traced function captures a large concrete tensor",
        "a traced function that closes over a module/outer-scope tensor "
        "freezes it into the program: `torch.jit.trace`/`script` keep a "
        "constant copy, a CUDA graph keeps its address (a rebind is "
        "never seen), and dynamo guards on it. Pass large tensors as "
        "arguments instead."),
    "FL113": (
        "traced function captures a host-loaded/converted tensor of "
        "statically unknowable size",
        "a traced function closing over a `torch.as_tensor(...)`/"
        "`torch.load(...)`/`np.load(...)` result freezes a tensor whose "
        "size the linter cannot bound into the program -- "
        "checkpoint-sized data silently becomes a per-program constant. "
        "Pass it as an argument (FL112's reasoning, without the size "
        "escape hatch)."),
    "FL114": (
        "wall-clock timing around asynchronous CUDA work without a sync",
        "CUDA launches are asynchronous: a `time.time()`/`perf_counter` "
        "delta measured around a traced callable, a kernel entry point "
        "of `fedml_tpu_torch/ops/`, an `nn.Module` call or a traced "
        "builder's return measures the *enqueue*, not the work -- the "
        "timing can be 10-1000x too small. Call "
        "`torch.cuda.synchronize()` (or the round loops' "
        "`end_of_round_sync`, or time with CUDA events and "
        "`elapsed_time`) inside the measured region; value fetches "
        "(`float(...)`, `.item()`, `.tolist()`, `.cpu()`, `.numpy()`) "
        "also count -- reading a value blocks on the work producing it."),
    "FL115": (
        "unbounded metric label cardinality from a per-client identifier",
        "a registry counter/gauge/histogram call whose label VALUE derives "
        "from a per-client identifier (a client id / rank variable, "
        "msg.get_sender_id(), or a cohort-loop variable) creates one time "
        "series per client -- at the population scales this repo targets "
        "(10^4-10^6 clients) that is an unbounded-cardinality leak that "
        "OOMs the registry and every scrape. Aggregate across clients, "
        "bucket the value into a histogram, or drop the label."),
    "FL123": (
        "cross-thread instance state accessed without its owning lock",
        "an attribute guarded by a state lock elsewhere in the class is "
        "accessed without it on a path handler threads reach (or a "
        "counter is `+=`-mutated on a handler path with no lock at "
        "all): a data race that surfaces as a flaky chaos run, not a "
        "test failure."),
    "FL124": (
        "lock-order cycle across nested lock acquisitions",
        "two lock families acquired in opposite nesting orders on "
        "different paths deadlock under the right thread interleaving; "
        "acquire in one global order or restructure so the second lock "
        "is taken after the first is released."),
    "FL125": (
        "blocking call while holding a state lock",
        "a frame send/recv, sendall, join, or sleep under a lock that "
        "also guards shared state lets one wedged peer (full send "
        "buffer, dead socket) pin every thread that needs the lock. "
        "Serialize I/O with a dedicated io_lock() "
        "(fedml_tpu_torch.analysis.locks) and keep state locks "
        "non-blocking."),
    "FL129": (
        "blocking call inside an event-loop callback or coroutine",
        "a method registered as selector/asyncio callback data (or any "
        "coroutine) reaches a blocking call (sendall, bare recv, join, "
        "sleep, send_with_retry, a transport send): the loop thread "
        "serves every multiplexed connection, so one blocked callback "
        "stalls the whole transport -- FL125's hazard without a lock in "
        "sight. Use non-blocking ops on ready fds (recv_into/send) or "
        "queue the work to the dispatcher thread "
        "(fedml_tpu_torch/net/eventloop.py is the reference shape)."),
    "FL130": (
        "paradigm bypass: round machinery constructed outside the program",
        "cohort/aggregation state built directly (a legacy RoundPolicy/"
        "AsyncAggPolicy constructor, a raw fold_entries_fp64 call) "
        "instead of through fedml_tpu_torch.program re-grows a "
        "paradigm-private copy of a RoundProgram leg -- the drift the "
        "program subsystem exists to prevent. Build a RoundProgram "
        "(CohortPolicy/AggregationPolicy are its vocabulary) and drive "
        "folds through program.host_view()."),
    "FL136": (
        "busy loop or unbounded buffer growth in an event-loop callback",
        "a while-loop with no calls at all (no sleep, no I/O, no "
        "selector wait) spins the loop thread at 100% without yielding; "
        "a per-connection buffer that only ever grows (append/extend/"
        "`+=` with no watermark or len() check anywhere in the class) "
        "lets one slow peer absorb the process heap. The eventloop "
        "transport's high/low watermark pair "
        "(fedml_tpu_torch/net/eventloop.py) is the reference shape."),
}

#: The reference's project-wide passes, not ported yet (ROADMAP A16b
#: (ii)): naming one of their codes in --select/--ignore is a usage
#: error rather than a silent no-op.
UNPORTED_CODES = frozenset((
    "FL120", "FL121", "FL122", "FL126", "FL127", "FL128",
    "FL131", "FL132", "FL133", "FL134", "FL135",
    "FL140", "FL141", "FL142", "FL143",
    "FL150", "FL151", "FL152", "FL153"))


def unported_codes(*code_sets):
    """Sorted codes of the not-yet-ported passes named in ``code_sets``
    (each an iterable of codes, or None)."""
    return sorted(set().union(*(set(c or ()) for c in code_sets))
                  & UNPORTED_CODES)


#: SARIF rule metadata: which analysis pass owns each rule (rendered as
#: SARIF ``properties.tags`` so PR-annotation UIs can group findings).
RULE_PASS = {
    "FL123": "fedcheck-concurrency", "FL124": "fedcheck-concurrency",
    "FL125": "fedcheck-concurrency", "FL129": "fedcheck-concurrency",
    "FL136": "fedcheck-concurrency",
    "FL130": "fedlint-program",
}


def rule_tags(code):
    """SARIF tags for one rule: the owning pass, plus the runtime
    cross-reference for the rules whose findings the race sanitizer /
    flight recorder mirror at runtime."""
    tags = [RULE_PASS.get(code, "fedlint-torch")]
    if code in ("FL124", "FL125"):
        tags.append("race-audit-crossref")
    return tags

#: FL112 only flags captures whose *static* element count is at least
#: this (64 KiB of f32): closing over small constant tables is idiomatic.
FL112_MIN_ELEMENTS = 16384

#: FL114: clock sources whose deltas measure wall time, and the sync
#: calls whose presence in the measured region makes such deltas honest
#: (``torch.cuda.synchronize``, ``Event.synchronize``/``elapsed_time``,
#: ``Stream.synchronize``, the round loops' syncs). Value fetches
#: (``float()``/``.item()``/``.tolist()``/``.cpu()``/``.numpy()``)
#: count: reading a value blocks on the work producing it.
_WALLCLOCK_ATTRS = ("time", "perf_counter", "monotonic")
_SYNC_CALL_NAMES = ("synchronize", "elapsed_time", "end_of_round_sync",
                    "sync_and_mark_round", "item", "tolist", "cpu",
                    "numpy")
_SYNC_BUILTIN_NAMES = ("float", "int")

#: FL114: the port's kernel entry points (``fedml_tpu_torch/ops/``):
#: each launches a hand-written CUDA kernel and returns before it runs.
#: ``tests/test_torch_fedlint_rules.py`` holds this set to the ops
#: package's public functions that reach a launch count.
KERNEL_ENTRY_POINTS = frozenset((
    "flash_attention", "flash_attention_fwd", "flash_attention_dq",
    "flash_attention_dkv", "grouped_conv_dw", "lane_conv_pallas"))
_OPS_PACKAGE = "fedml_tpu_torch.ops"


def _time_aliases(tree):
    """Local names bound to the ``time`` module and to its from-imported
    clock functions (``from time import perf_counter`` style)."""
    mods, funcs = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time":
                    mods.add(a.asname or "time")
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            for a in node.names:
                if a.name in _WALLCLOCK_ATTRS:
                    funcs.add(a.asname or a.name)
    return mods, funcs

#: FL107 only applies to transport/codec paths (broad handlers elsewhere
#: are a judgement call; on the wire they corrupt rounds silently).
#: Segment-anchored where needed: a bare "*comm*" would swallow
#: experiments/common.py.
_FL107_PATHS = ("*/comm/*", "*transport*", "*codec*", "*compression*",
                "*mqtt*", "*tcp*")
#: FL108 skips user-facing CLIs, where print IS the interface. The bench
#: drivers (bench.py, __graft_entry__.py, scripts/) are CLIs too: their
#: stdout is parsed by the measurement harness, so print is load-bearing.
_FL108_EXCLUDED = ("*/experiments/*", "*prepare.py", "*/scripts/*",
                   "scripts/*", "*cli.py", "bench.py", "*/bench.py",
                   "__graft_entry__.py", "*/__graft_entry__.py")

#: FL130: the legacy round-machinery names whose direct call/construction
#: outside the program package is a paradigm bypass. The program's own
#: vocabulary (CohortPolicy/AggregationPolicy ctors, host-view methods,
#: aggregate_reports through the facade) is NOT flagged -- only the
#: pre-program spellings that used to be copied per paradigm. Classmethod
#: constructors (``AsyncAggPolicy.from_args``) and ``dataclasses.replace``
#: evolution resolve to different call names and stay legal.
_FL130_BYPASS_NAMES = {"RoundPolicy", "AsyncAggPolicy", "fold_entries_fp64"}
#: ...and where constructing them directly is the job, not a bypass.
_FL130_EXEMPT_PATHS = ("*/program/*",)

#: FL115: the metrics-registry write surface, how a receiver is known to
#: BE the registry (assigned from these factories, or a `registry`-named
#: attribute), which keywords are not labels, and what reads as a
#: per-client identifier. Collection-iter names are matched exactly
#: (not substring): `for r in sorted(self.alive)` taints `r`, while
#: `range(0, C, self.client_chunk)` taints nothing.
_REGISTRY_METHODS = {"inc", "set_gauge", "observe", "declare_histogram"}
_REGISTRY_FACTORIES = {"get_registry", "MetricsRegistry"}
_FL115_NON_LABEL_KW = {"help", "buckets", "value"}
_FL115_ID_RE = re.compile(
    r"(?:^|_)(?:rank|client|peer|cid|sender)(?:_?(?:id|idx|index|rank))?$",
    re.IGNORECASE)
_FL115_COHORT_ITERS = {"clients", "client_indexes", "client_ids", "cohort",
                       "ranks", "peers", "alive", "alive_ranks"}
_FL115_ID_CALLS = {"get_sender_id"}

#: traced-site constructors, by canonical dotted name
_TRACERS = {"torch.compile": "compile", "torch.jit.script": "script",
            "torch.jit.trace": "trace",
            "torch.cuda.make_graphed_callables": "graphed"}
_GRAPH_CONTEXT = "torch.cuda.graph"
_GRAPH_CTOR = "torch.cuda.CUDAGraph"
#: torch.compile modes that capture CUDA graphs (cudagraph trees): their
#: outputs are static buffers the next call overwrites
GRAPHED_COMPILE_MODES = ("reduce-overhead", "max-autotune")

_SYNC_BUILTINS = {"float", "int", "bool"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_NP_SYNC_ATTRS = {"asarray", "array"}
_STRUCTURAL_ATTRS = {"shape", "ndim", "dtype", "size", "device",
                     "is_cuda", "requires_grad", "layout"}
_PYTREE_SINKS = {"stack", "concatenate", "cat", "vstack", "hstack",
                 "tree_map", "map", "tree_unflatten", "unflatten"}
_LOG_CALL_NAMES = {"logging", "logger", "log", "warnings"}
#: FL112: tensor constructors whose size is static given literal shapes
_TORCH_SHAPED_CTORS = {"zeros", "ones", "empty", "rand", "randn"}
#: FL113: host loads / conversions of statically unknowable size
_TORCH_CONVERSIONS = {"as_tensor", "tensor", "asarray", "from_numpy"}

_DISABLE_RE = re.compile(
    r"#\s*fedlint:\s*disable(?P<file>-file)?\s*(?:=\s*"
    r"(?P<codes>[A-Za-z0-9_,\s]+))?")


@dataclass
class Finding:
    path: str
    line: int
    col: int
    code: str
    message: str
    text: str = ""  # stripped source line, the baseline fingerprint
    baselined: bool = False

    def key(self):
        """Baseline identity: line numbers shift on unrelated edits, so the
        fingerprint is (path, code, source text)."""
        return (self.path.replace(os.sep, "/"), self.code, self.text)

    def as_dict(self):
        return {"path": self.path.replace(os.sep, "/"), "line": self.line,
                "col": self.col, "code": self.code, "message": self.message,
                "text": self.text, "baselined": self.baselined}


# -- suppression comments -------------------------------------------------

def _parse_suppressions(src):
    """-> (line -> set of codes or {"*"}, file-level set of codes/{"*"})."""
    per_line, per_file = {}, set()
    try:
        tokens = tokenize.generate_tokens(io.StringIO(src).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _DISABLE_RE.search(tok.string)
            if not m:
                continue
            codes = ({c.strip().upper() for c in m.group("codes").split(",")
                      if c.strip()} if m.group("codes") else {"*"})
            if m.group("file"):
                per_file |= codes
            else:
                per_line.setdefault(tok.start[0], set()).update(codes)
    except tokenize.TokenError:
        pass  # syntax trouble surfaces via ast.parse, not here
    return per_line, per_file


def _suppressed(finding, per_line, per_file):
    codes = per_line.get(finding.line, set()) | per_file
    return "*" in codes or finding.code in codes


# -- traced-site detection ------------------------------------------------

@dataclass
class _TracedSite:
    func: ast.AST     # FunctionDef / Lambda traced, or the graph's With
    site: ast.AST     # node to report configuration rules at
    kind: str         # "compile" | "script" | "trace" | "graphed" | "graph"
    kwargs: dict = field(default_factory=dict)  # tracer keyword -> node


class _Aliases:
    """Import-alias resolution: each local name bound by an import, as
    the canonical dotted name it stands for (``np`` -> ``numpy``,
    ``nn`` -> ``torch.nn``, ``fa`` -> ``fedml_tpu_torch.ops.
    flash_attention``). A bare ``partial`` means ``functools.partial``
    unless rebound, as in the reference."""

    def __init__(self, tree):
        self.names = {"partial": "functools.partial"}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.names[a.asname] = a.name
                    else:
                        root = a.name.split(".")[0]
                        self.names[root] = root
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    self.names[a.asname or a.name] = \
                        f"{node.module}.{a.name}"
        self.np = {k for k, v in self.names.items() if v == "numpy"}

    def canon(self, node):
        """Canonical dotted name of a Name/Attribute chain rooted at an
        imported name, else None."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name) or node.id not in self.names:
            return None
        return ".".join([self.names[node.id]] + parts[::-1])

    def tracer_kind(self, node):
        return _TRACERS.get(self.canon(node))

    def is_partial_ref(self, node):
        return self.canon(node) == "functools.partial"

    def is_np_attr(self, node, attrs=None):
        """`np.<attr>` where np aliases real numpy."""
        return (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in self.np
                and (attrs is None or node.attr in attrs))

    def torch_attr(self, node):
        """``<attr>`` for a ``torch.<attr>`` reference, else None."""
        name = self.canon(node)
        if name and name.startswith("torch.") and name.count(".") == 1:
            return name[len("torch."):]
        return None

    def is_kernel_entry(self, node):
        """A reference to a kernel entry point of ``fedml_tpu_torch/ops/``
        (from-imported, or through an imported ops module)."""
        name = self.canon(node)
        return bool(name and name.startswith(_OPS_PACKAGE + ".")
                    and name.rsplit(".", 1)[1] in KERNEL_ENTRY_POINTS)


def tracer_call_info(call, aliases):
    """If ``call`` invokes a tracer (``torch.compile(...)``,
    ``torch.jit.script(...)``, ..., possibly through ``partial``), return
    ``(kind, keyword dict)``, else None."""
    kwargs = {kw.arg: kw.value for kw in call.keywords if kw.arg}
    kind = aliases.tracer_kind(call.func)
    if kind is not None:
        return kind, kwargs
    if aliases.is_partial_ref(call.func) and call.args:
        kind = aliases.tracer_kind(call.args[0])
        if kind is not None:
            return kind, kwargs
    return None


def is_graphed(kind, kwargs):
    """Whether a tracer's result replays a CUDA graph (its outputs are
    static buffers)."""
    if kind in ("graphed", "graph"):
        return True
    mode = kwargs.get("mode")
    return (kind == "compile" and isinstance(mode, ast.Constant)
            and mode.value in GRAPHED_COMPILE_MODES)


def graph_context_target(item, aliases):
    """The graph expression of a ``with torch.cuda.graph(g):`` item, or
    None."""
    ctx = item.context_expr
    if isinstance(ctx, ast.Call) and aliases.canon(ctx.func) \
            == _GRAPH_CONTEXT:
        return ctx.args[0] if ctx.args else None
    return None


def collect_traced_sites(tree, aliases):
    sites = []
    defs = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, node)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                kind = aliases.tracer_kind(dec)
                if kind is not None:
                    sites.append(_TracedSite(node, node, kind))
                elif isinstance(dec, ast.Call):
                    info = tracer_call_info(dec, aliases)
                    if info is not None:
                        sites.append(_TracedSite(node, node, *info))
        elif isinstance(node, ast.Call):
            info = tracer_call_info(node, aliases)
            if info is None or not node.args:
                continue
            target = node.args[0]
            if isinstance(target, ast.Lambda):
                sites.append(_TracedSite(target, node, *info))
            elif isinstance(target, ast.Name) and target.id in defs:
                sites.append(_TracedSite(defs[target.id], node, *info))
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            if any(graph_context_target(item, aliases) is not None
                   for item in node.items):
                sites.append(_TracedSite(node, node, "graph"))
    # dedup: `@torch.compile(...)` decorators are also Call nodes in the
    # walk -- keyed by the traced function object, first site wins
    seen, out = set(), []
    for s in sites:
        if id(s.func) not in seen:
            seen.add(id(s.func))
            out.append(s)
    return out


def _param_names(func):
    if isinstance(func, (ast.With, ast.AsyncWith)):
        return []
    a = func.args
    return ([p.arg for p in a.posonlyargs] + [p.arg for p in a.args]
            + [p.arg for p in a.kwonlyargs])


def _scalar_params(func):
    """(name, type) of the params that read as Python scalars: an
    int/bool/str annotation, or a bool/int/str constant default."""
    if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return []
    out = []
    a = func.args
    pos = list(a.posonlyargs) + list(a.args)
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    for p, d in list(zip(pos, defaults)) + [
            (p, d) for p, d in zip(a.kwonlyargs, a.kw_defaults)]:
        ann = p.annotation
        if isinstance(ann, ast.Name) and ann.id in ("int", "bool", "str"):
            out.append((p.arg, ann.id))
        elif isinstance(d, ast.Constant) \
                and isinstance(d.value, (bool, int, str)):
            out.append((p.arg, type(d.value).__name__))
    return out


# -- per-rule checks ------------------------------------------------------

def _tracer_name_uses(expr, params):
    """Param Name nodes in ``expr`` used as *values* -- excluding static
    accesses (`x.shape`, `x.ndim`, `len(x)`, `x is None`) that are legal
    Python-control-flow inputs under trace."""
    hits = []

    def visit(node, parent):
        if isinstance(node, ast.Name) and node.id in params:
            if isinstance(parent, ast.Attribute) \
                    and parent.attr in _STRUCTURAL_ATTRS:
                return
            if isinstance(parent, ast.Call) \
                    and isinstance(parent.func, ast.Name) \
                    and parent.func.id in ("len", "isinstance", "type") \
                    and node in parent.args:
                return
            if isinstance(parent, ast.Compare) \
                    and all(isinstance(op, (ast.Is, ast.IsNot))
                            for op in parent.ops):
                return
            hits.append(node)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, node)

    visit(expr, None)
    return hits


def _call_root_name(node):
    """Dotted name of a call target, e.g. torch.stack -> ('torch',
    'stack')."""
    if isinstance(node, ast.Name):
        return None, node.id
    if isinstance(node, ast.Attribute):
        base = node.value
        root = base.id if isinstance(base, ast.Name) else (
            _call_root_name(base)[1] if isinstance(base, ast.Attribute)
            else None)
        return root, node.attr
    return None, None


def _unsorted_dict_iter(node):
    """First `.values()/.keys()/.items()` call in ``node`` that is not
    wrapped in `sorted(...)` anywhere on its path."""
    def visit(n, sorted_depth):
        if isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Name) and f.id in ("sorted", "dict",
                                                    "OrderedDict"):
                sorted_depth += 1
            if (isinstance(f, ast.Attribute)
                    and f.attr in ("values", "keys", "items")
                    and not n.args and sorted_depth == 0):
                return n
        for child in ast.iter_child_nodes(n):
            found = visit(child, sorted_depth)
            if found is not None:
                return found
        return None
    return visit(node, 0)


def _int_constants(nodes):
    """Product of a list of int Constant nodes, else None."""
    size = 1
    for e in nodes:
        if not (isinstance(e, ast.Constant) and isinstance(e.value, int)
                and not isinstance(e.value, bool)):
            return None
        size *= e.value
    return size


class _ModuleLinter:
    def __init__(self, path, src, tree, index=None):
        self.path = path
        self.src_lines = src.splitlines()
        self.tree = tree
        self.aliases = _Aliases(tree)
        self.index = index
        self.findings = []

    def _line_text(self, lineno):
        if 1 <= lineno <= len(self.src_lines):
            return self.src_lines[lineno - 1].strip()
        return ""

    def add(self, node, code, message):
        self.findings.append(Finding(
            path=self.path, line=node.lineno,
            col=getattr(node, "col_offset", 0) + 1, code=code,
            message=message, text=self._line_text(node.lineno)))

    def run(self):
        sites = collect_traced_sites(self.tree, self.aliases)
        parents = {id(child): node for node in ast.walk(self.tree)
                   for child in ast.iter_child_nodes(node)}
        self._parents = parents
        self._collect_fl115_bindings()
        for site in sites:
            self._check_traced_body(site)
            self._check_compile_config(site)
            self._check_captures(site, parents)
        self._check_module_wide()
        self._check_replicated_placement()
        self._check_wallclock_timing(sites)
        return self.findings

    # FL101 / FL102 / FL105: body of a traced function
    def _check_traced_body(self, site):
        scalars = {name for name, _ in _scalar_params(site.func)}
        params = set(_param_names(site.func)) - scalars
        graph_body = isinstance(site.func, (ast.With, ast.AsyncWith))
        flagged_stmts = set()
        for node in ast.walk(site.func):
            if isinstance(node, ast.Call):
                self._check_sync_call(node, params, graph_body)
                self._check_np_call(node)
            elif isinstance(node, (ast.If, ast.While)) \
                    and id(node) not in flagged_stmts:
                if _tracer_name_uses(node.test, params):
                    flagged_stmts.add(id(node))
                    kind = "if" if isinstance(node, ast.If) else "while"
                    self.add(node, "FL102",
                             f"Python `{kind}` on a tensor argument inside "
                             "traced code -- a graph break (or a baked-in "
                             "branch); use torch.where/torch.cond or pass "
                             "a Python scalar")
            elif isinstance(node, ast.For) and id(node) not in flagged_stmts:
                if _tracer_name_uses(node.iter, params):
                    flagged_stmts.add(id(node))
                    self.add(node, "FL102",
                             "Python `for` over a tensor argument inside "
                             "traced code -- iterating a tensor syncs on "
                             "its length and unrolls the values; index "
                             "with a static bound")

    def _check_sync_call(self, node, params, graph_body):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS \
                and not node.args:
            self.add(node, "FL101",
                     f"`.{f.attr}()` inside traced code forces a host "
                     "sync (a graph break, or a capture error)")
        elif isinstance(f, ast.Name) and f.id in _SYNC_BUILTINS \
                and len(node.args) == 1 \
                and not isinstance(node.args[0], ast.Constant) \
                and (graph_body or _tracer_name_uses(node.args[0],
                                                     params)):
            self.add(node, "FL101",
                     f"`{f.id}()` of a tensor inside traced code reads "
                     "the value on the host (sync)")
        elif self.aliases.is_np_attr(f, _NP_SYNC_ATTRS):
            self.add(node, "FL101",
                     f"`np.{f.attr}` inside traced code pulls the tensor "
                     "to host -- use torch")
        elif self.aliases.canon(f) == "torch.cuda.synchronize":
            self.add(node, "FL101",
                     "`torch.cuda.synchronize()` inside traced code "
                     "blocks the host (a graph break, or a capture "
                     "error)")

    def _check_np_call(self, node):
        f = node.func
        if self.aliases.is_np_attr(f) and f.attr not in _NP_SYNC_ATTRS \
                and f.attr not in ("float64", "double"):
            self.add(node, "FL105",
                     f"`np.{f.attr}` inside traced code computes on host in "
                     "float64 -- use the torch equivalent")
        for kw in node.keywords:
            if kw.arg == "dtype" and self.aliases.is_np_attr(
                    kw.value, ("float64", "double")):
                self.add(kw.value, "FL105",
                         "explicit float64 dtype in device code")
        if self.aliases.is_np_attr(f, ("float64", "double")):
            self.add(node, "FL105", "np.float64 cast in device code")

    # FL103: the torch.compile call site configuration
    def _check_compile_config(self, site):
        if site.kind != "compile" or isinstance(site.func, ast.Lambda):
            return
        dynamic = site.kwargs.get("dynamic")
        symbolic_ints = (isinstance(dynamic, ast.Constant)
                         and dynamic.value is True)
        scalars = [name for name, kind in _scalar_params(site.func)
                   if not (symbolic_ints and kind == "int")]
        if scalars:
            self.add(site.site, "FL103",
                     f"torch.compile of `{site.func.name}` takes "
                     f"Python-scalar params ({', '.join(scalars)}) -- each "
                     "new value compiles a new graph, and past dynamo's "
                     "cache size limit the function runs eagerly")

    # FL106 / FL107 / FL108 / FL115 / FL130: module-wide
    def _check_module_wide(self):
        posix = self.path.replace(os.sep, "/")
        fl107_scoped = any(fnmatch(posix, pat) for pat in _FL107_PATHS)
        fl108_scoped = not any(fnmatch(posix, pat)
                               for pat in _FL108_EXCLUDED)
        fl130_scoped = not any(fnmatch(posix, pat)
                               for pat in _FL130_EXEMPT_PATHS)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                self._check_pytree_sink(node)
                self._check_metric_labels(node)
                if fl108_scoped:
                    self._check_debug_call(node)
                if fl130_scoped:
                    self._check_paradigm_bypass(node)
            elif isinstance(node, ast.ExceptHandler) and fl107_scoped:
                self._check_except(node)

    # FL130: paradigm bypass -- legacy round machinery built inline
    def _check_paradigm_bypass(self, node):
        _, fname = _call_root_name(node.func)
        if fname in _FL130_BYPASS_NAMES:
            self.add(node, "FL130",
                     f"`{fname}(...)` constructs round machinery outside "
                     "fedml_tpu_torch/program/ -- build a RoundProgram "
                     "(CohortPolicy/AggregationPolicy) and drive folds "
                     "through program.host_view() instead")

    # FL115: unbounded metric label cardinality
    def _enclosing_fn(self, node):
        """The innermost FunctionDef/Lambda containing ``node`` (None at
        module level)."""
        p = self._parents.get(id(node))
        while p is not None:
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                return p
            p = self._parents.get(id(p))
        return None

    def _collect_fl115_bindings(self):
        """Module prepass: which names/attributes hold the metrics
        registry (assigned from ``get_registry()``/``MetricsRegistry()``)
        and which loop variables iterate a client/rank collection. Loop
        taint is scoped to the loop's ENCLOSING FUNCTION: a cohort loop's
        short `r` in one method must not taint an unrelated `r` used as
        a label elsewhere in the module."""
        self._registry_names, self._registry_attrs = set(), set()
        self._client_loop_vars = {}  # name -> {id(enclosing fn) | None}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                _, fname = _call_root_name(node.value.func)
                if fname in _REGISTRY_FACTORIES:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            self._registry_names.add(t.id)
                        elif isinstance(t, ast.Attribute):
                            self._registry_attrs.add(t.attr)
            elif isinstance(node, ast.For):
                iter_names = set()
                for n in ast.walk(node.iter):
                    if isinstance(n, ast.Name):
                        iter_names.add(n.id)
                    elif isinstance(n, ast.Attribute):
                        iter_names.add(n.attr)
                if iter_names & _FL115_COHORT_ITERS:
                    scope = self._enclosing_fn(node)
                    for n in ast.walk(node.target):
                        if isinstance(n, ast.Name):
                            self._client_loop_vars.setdefault(
                                n.id, set()).add(
                                None if scope is None else id(scope))

    def _per_client_ident(self, expr, scope_id):
        """First sub-expression of a label value that reads as a
        per-client identifier, or None. ``scope_id``: id() of the call
        site's enclosing function (loop-var taint is function-scoped)."""
        for n in ast.walk(expr):
            if isinstance(n, ast.Name):
                if _FL115_ID_RE.search(n.id) \
                        or scope_id in self._client_loop_vars.get(
                            n.id, ()):
                    return n.id
            elif isinstance(n, ast.Attribute) \
                    and _FL115_ID_RE.search(n.attr):
                return n.attr
            elif isinstance(n, ast.Call):
                _, fname = _call_root_name(n.func)
                if fname in _FL115_ID_CALLS:
                    return fname + "()"
        return None

    def _check_metric_labels(self, node):
        f = node.func
        if not (isinstance(f, ast.Attribute)
                and f.attr in _REGISTRY_METHODS):
            return
        recv = f.value
        if isinstance(recv, ast.Name):
            if recv.id not in self._registry_names:
                return
        elif isinstance(recv, ast.Attribute):
            if recv.attr not in self._registry_attrs \
                    and recv.attr != "registry":
                return
        else:
            return
        scope = self._enclosing_fn(node)
        scope_id = None if scope is None else id(scope)
        for kw in node.keywords:
            if kw.arg is None or kw.arg in _FL115_NON_LABEL_KW:
                continue
            ident = self._per_client_ident(kw.value, scope_id)
            if ident is not None:
                self.add(kw.value, "FL115",
                         f"metric label `{kw.arg}` derives from the "
                         f"per-client identifier `{ident}` -- one time "
                         "series per client/rank is unbounded label "
                         "cardinality; aggregate, bucket into a "
                         "histogram, or drop the label")
                return  # one finding per call site is enough

    # FL109: a sharded step whose every placement replicates
    def _check_replicated_placement(self):
        """Group the module's ``global_put(mesh, tree, spec)`` calls by
        enclosing scope: a scope whose every placement is replicating
        (``()``, ``replicated_sharding(...)``, the default spec) fires
        once, at its first placement. A spec out of static reach (a
        parameter, a rebound name) judges the whole scope clean."""
        scopes = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call) and self._is_global_put(node):
                scope = self._enclosing_fn(node)
                scopes.setdefault(id(scope), []).append(node)
        for calls in scopes.values():
            verdicts = [self._placement_replicates(c) for c in calls]
            if all(v is True for v in verdicts):
                first = min(calls, key=lambda c: (c.lineno, c.col_offset))
                self.add(first, "FL109",
                         "every `global_put` of this step places its tree "
                         "with the replicating spec `()` -- no operand is "
                         "split over any mesh axis (the `clients` cohort "
                         "operand should be), so every rank computes the "
                         "full arrays")

    def _is_global_put(self, call):
        name = self.aliases.canon(call.func)
        if name is not None:
            return name.endswith(".global_put")
        return isinstance(call.func, ast.Name) \
            and call.func.id == "global_put"

    def _placement_replicates(self, call):
        """True (replicating), False (partitioned) or None (unknown)."""
        spec = call.args[2] if len(call.args) >= 3 else None
        for kw in call.keywords:
            if kw.arg == "spec":
                spec = kw.value
        if spec is None:
            return True  # global_put's default spec is ()
        if isinstance(spec, ast.Name):
            # a name-bound spec resolves through up to two single-binding
            # assignment hops (the reference's FL109 reach)
            spec = self._resolve_spec_assignment(spec, call)
            if spec is None:
                return None
        return _spec_replicates(spec)

    def _resolve_spec_assignment(self, entry, near, depth=0):
        """Name resolution for FL109 through up to TWO single-binding
        assignment hops: find the single ``name = <expr>`` binding of
        ``entry`` in an enclosing scope of ``near`` (innermost first) and
        return the assigned expression; a value that is itself a bare
        name (``spec = a`` where ``a = ()``) resolves through one more
        hop. Returns None -- judge nothing -- when the name is a function
        parameter (caller-supplied), is bound more than once or through
        non-Assign forms (loop targets, tuple unpacking), or the chain
        runs deeper than two hops."""
        if not isinstance(entry, ast.Name):
            return None
        name = entry.id
        scope = near
        while scope is not None:
            if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and name in _param_names(scope):
                return None
            if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Module)):
                assigns = [stmt.value for stmt in scope.body
                           if isinstance(stmt, ast.Assign)
                           and len(stmt.targets) == 1
                           and isinstance(stmt.targets[0], ast.Name)
                           and stmt.targets[0].id == name]
                stores = [n for n in ast.walk(scope)
                          if isinstance(n, ast.Name)
                          and isinstance(n.ctx, ast.Store) and n.id == name]
                if len(assigns) == 1 and len(stores) == 1:
                    value = assigns[0]
                    if isinstance(value, ast.Name):
                        return (self._resolve_spec_assignment(
                                    value, near, depth + 1)
                                if depth + 1 < 2 else None)
                    return value
                if stores:  # rebound or bound through complex targets
                    return None
            scope = self._parents.get(id(scope))
        return None

    # FL112 / FL113: traced closures over concrete tensors
    def _check_captures(self, site, parents):
        func = site.func
        bound = set(_param_names(func))
        for n in ast.walk(func):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                bound.add(n.id)
            elif isinstance(n, ast.arg):
                bound.add(n.arg)
            elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and n is not func:
                bound.add(n.name)
        free = {}
        for n in ast.walk(func):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                    and n.id not in bound:
                free.setdefault(n.id, n)
        if not free:
            return
        scope_assigns = {}
        p = parents.get(id(func))
        while p is not None:
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Module)):
                for stmt in p.body:
                    if isinstance(stmt, ast.Assign) \
                            and len(stmt.targets) == 1 \
                            and isinstance(stmt.targets[0], ast.Name):
                        scope_assigns.setdefault(stmt.targets[0].id,
                                                 stmt.value)
            p = parents.get(id(p))
        for name in sorted(free):
            value = scope_assigns.get(name)
            size = self._static_tensor_size(value)
            if size is not None and size >= FL112_MIN_ELEMENTS:
                self.add(site.site, "FL112",
                         f"traced function closes over `{name}` "
                         f"(~{size} elements built in an outer scope) -- "
                         "the tensor is frozen into the program; pass it "
                         "as an argument")
                return
            if size is None and self._is_unbounded_load(value):
                self.add(site.site, "FL113",
                         f"traced function closes over `{name}`, built "
                         "by a host load/conversion "
                         "(torch.as_tensor/torch.load/np.load) whose size "
                         "is statically unknowable -- the tensor becomes "
                         "a per-program constant; pass it as an argument "
                         "instead")
                return

    def _is_unbounded_load(self, node):
        """FL113: a call materializing a tensor whose size the linter
        cannot bound -- ``torch.as_tensor``/``torch.tensor``/
        ``torch.from_numpy`` over a non-literal, or any ``torch.load``/
        ``np.load``/``np.loadtxt``/``np.fromfile``. Small literal
        containers (``torch.tensor([1, 2, 3])``) are bounded and
        exempt."""
        if not isinstance(node, ast.Call):
            return False
        f = node.func
        if self.aliases.is_np_attr(f, ("load", "loadtxt", "fromfile")):
            return True
        attr = self.aliases.torch_attr(f)
        if attr == "load":
            return True
        if attr in _TORCH_CONVERSIONS:
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                return False  # scalar constant: trivially bounded
            if isinstance(arg, (ast.List, ast.Tuple)) and all(
                    isinstance(e, ast.Constant) for e in arg.elts):
                return False  # literal table: bounded and idiomatic
            return True
        return False

    def _static_tensor_size(self, node):
        """Element count of a torch/np tensor-constructor call with a
        literal shape (``torch.zeros(512, 512)``, ``torch.zeros((512,
        512))``, ``np.zeros((512, 512))``, ``torch.full((n, m), v)``,
        ``arange(n)``), else None."""
        if not isinstance(node, ast.Call) or not node.args:
            return None
        f = node.func
        attr = self.aliases.torch_attr(f)
        is_np = self.aliases.is_np_attr(f)
        if attr is None and not is_np:
            return None
        attr = attr or f.attr
        shape = node.args[0]
        if attr in _TORCH_SHAPED_CTORS | {"full"}:
            if isinstance(shape, (ast.Tuple, ast.List)):
                return _int_constants(shape.elts)
            if attr == "full" or is_np:
                return _int_constants([shape])
            return _int_constants(node.args)
        if attr == "arange" and len(node.args) == 1:
            return _int_constants([shape])
        return None

    def _check_pytree_sink(self, node):
        root, attr = _call_root_name(node.func)
        if attr not in _PYTREE_SINKS:
            return
        if attr == "map" and root not in ("tree", "tree_util", "jax"):
            return
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            hit = _unsorted_dict_iter(arg)
            if hit is not None:
                self.add(hit, "FL106",
                         f"dict `.{hit.func.attr}()` order feeds "
                         f"`{attr}` -- insertion order is process-dependent "
                         "for restored/parsed dicts; wrap in sorted(...)")
                return

    def _check_debug_call(self, node):
        f = node.func
        if isinstance(f, ast.Name) and f.id in ("print", "breakpoint"):
            self.add(node, "FL108",
                     f"`{f.id}()` in library code -- use logging")
        elif isinstance(f, ast.Attribute) \
                and f.attr in ("print", "breakpoint", "callback") \
                and isinstance(f.value, ast.Attribute) \
                and f.value.attr == "debug":
            self.add(node, "FL108",
                     f"`debug.{f.attr}` left in library code -- a host "
                     "callback in the compiled program")

    def _check_except(self, node):
        t = node.type
        broad = t is None or (isinstance(t, ast.Name)
                              and t.id in ("Exception", "BaseException"))
        if not broad:
            return
        swallows = not any(
            isinstance(n, ast.Raise) or self._is_log_call(n)
            for n in ast.walk(node))
        what = "bare `except:`" if t is None else f"`except {t.id}:`"
        detail = ("silently swallows transport errors"
                  if swallows else "hides the specific failure mode")
        self.add(node, "FL107",
                 f"{what} in comm/transport code {detail} -- catch the "
                 "concrete decode/socket error types")

    @staticmethod
    def _is_log_call(node):
        if not isinstance(node, ast.Call):
            return False
        root, attr = _call_root_name(node.func)
        return root in _LOG_CALL_NAMES or attr in (
            "warning", "error", "exception", "info", "debug", "warn")

    # FL114: wall-clock deltas around asynchronous CUDA work without a sync
    def _async_names(self, sites):
        """Names (bare, or the attribute of ``self.x``-style targets)
        whose calls enqueue CUDA work: traced functions and their
        bindings, graph replays, names bound to ``nn.Module`` instances,
        and the returns of traced builders the project index resolves.
        Kernel entry points are matched by their import
        (``_Aliases.is_kernel_entry``)."""
        names = set()
        for s in sites:
            if isinstance(s.func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.add(s.func.name)
        module_classes = {n.name for n in ast.walk(self.tree)
                          if isinstance(n, ast.ClassDef)
                          and any(self._is_nn_module(b) for b in n.bases)}
        module_name = None
        if self.index is not None:
            from fedml_tpu_torch.analysis.dataflow import ProjectIndex
            module_name = ProjectIndex.module_name(self.path)
        for node in ast.walk(self.tree):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            value = node.value
            if not (tracer_call_info(value, self.aliases) is not None
                    or self.aliases.canon(value.func) == _GRAPH_CTOR
                    or self._is_nn_module(value.func)
                    or (isinstance(value.func, ast.Name)
                        and value.func.id in module_classes)
                    or (module_name is not None
                        and self.index.resolve_binding(module_name,
                                                       value) is not None)):
                continue
            if self.aliases.canon(value.func) == _GRAPH_CTOR:
                names.add("replay")
            for t in node.targets:  # f = torch.compile(...) / self.f = ...
                for e in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                          else [t]):
                    if isinstance(e, ast.Name):
                        names.add(e.id)
                    elif isinstance(e, ast.Attribute):
                        names.add(e.attr)
        return names

    def _is_nn_module(self, node):
        """``nn.<Class>`` / ``torch.nn.<Class>`` (a module class)."""
        name = self.aliases.canon(node)
        if not name or not name.startswith("torch.nn."):
            return False
        last = name[len("torch.nn."):]
        return "." not in last and last[:1].isupper()

    def _check_wallclock_timing(self, sites):
        """Linear scan per statement suite: ``t0 = time.time()`` opens a
        measured region; a later ``time.time() - t0`` (same suite) closes
        it. If the region calls a module-known asynchronous callable
        (:meth:`_async_names`, or a kernel entry point through an ops
        module) and never syncs (``torch.cuda.synchronize`` /
        ``Event.synchronize``/``elapsed_time`` / ``end_of_round_sync`` /
        a value fetch), the delta measures the enqueue, not the work.
        Start and delta in different suites are conservatively skipped
        (static reach ends at the suite boundary)."""
        async_names = self._async_names(sites)
        aliases = self.aliases
        if not async_names and not any(
                v.startswith(_OPS_PACKAGE + ".")
                for v in aliases.names.values()):
            return
        tmods, tfuncs = _time_aliases(self.tree)

        def is_time_call(n):
            if not isinstance(n, ast.Call) or n.args:
                return False
            f = n.func
            if isinstance(f, ast.Attribute):
                return (f.attr in _WALLCLOCK_ATTRS
                        and isinstance(f.value, ast.Name)
                        and f.value.id in tmods)
            return isinstance(f, ast.Name) and f.id in tfuncs

        def region_calls(stmts, names, kernels=False):
            for stmt in stmts:
                for n in ast.walk(stmt):
                    if isinstance(n, ast.Call):
                        f = n.func
                        if isinstance(f, ast.Name) and f.id in names:
                            return True
                        if isinstance(f, ast.Attribute) and f.attr in names:
                            return True
                        if kernels and aliases.is_kernel_entry(f):
                            return True
            return False

        def region_syncs(stmts):
            if region_calls(stmts, _SYNC_CALL_NAMES):
                return True
            for stmt in stmts:
                for n in ast.walk(stmt):
                    # float(x)/int(x) on a non-literal: a value fetch that
                    # blocks on the producing computation
                    if (isinstance(n, ast.Call)
                            and isinstance(n.func, ast.Name)
                            and n.func.id in _SYNC_BUILTIN_NAMES
                            and n.args
                            and not isinstance(n.args[0], ast.Constant)):
                        return True
            return False

        def shallow_exprs(stmt):
            # the statement's own expressions only: nested suites get
            # their own scan (and their own start vars -- an inner
            # reassignment must not match an outer start)
            todo = [stmt]
            while todo:
                n = todo.pop()
                for c in ast.iter_child_nodes(n):
                    if isinstance(c, ast.stmt):
                        continue
                    todo.append(c)
                    yield c

        for node in ast.walk(self.tree):
            for fld in ("body", "orelse", "finalbody"):
                suite = getattr(node, fld, None)
                if (not isinstance(suite, list) or not suite
                        or not isinstance(suite[0], ast.stmt)):
                    continue
                starts = {}
                for i, stmt in enumerate(suite):
                    if (isinstance(stmt, ast.Assign)
                            and len(stmt.targets) == 1
                            and isinstance(stmt.targets[0], ast.Name)
                            and is_time_call(stmt.value)):
                        starts[stmt.targets[0].id] = i
                        continue
                    for sub in shallow_exprs(stmt):
                        if (isinstance(sub, ast.BinOp)
                                and isinstance(sub.op, ast.Sub)
                                and is_time_call(sub.left)
                                and isinstance(sub.right, ast.Name)
                                and sub.right.id in starts):
                            region = suite[starts[sub.right.id] + 1:i + 1]
                            if (region_calls(region, async_names, True)
                                    and not region_syncs(region)):
                                self.add(sub, "FL114",
                                         "wall-clock delta around "
                                         "asynchronous CUDA work with no "
                                         "torch.cuda.synchronize/"
                                         "end_of_round_sync in the "
                                         "measured region -- it measures "
                                         "the enqueue, not the work")


def _spec_replicates(spec):
    """FL109 verdict on a placement-spec expression: True for ``()``/a
    tuple of only ``None``/``replicated_sharding(...)``, False for a
    tuple naming an axis or ``client_sharding(...)``, None otherwise."""
    if isinstance(spec, (ast.Tuple, ast.List)):
        return all(isinstance(e, ast.Constant) and e.value is None
                   for e in spec.elts)
    if isinstance(spec, ast.Call):
        _, fname = _call_root_name(spec.func)
        if fname == "replicated_sharding":
            return True
        if fname == "client_sharding":
            return False
    return None


# -- driver ---------------------------------------------------------------

def _filter_findings(findings, per_line, per_file, select=None, ignore=None):
    out = []
    for f in findings:
        if select and f.code not in select:
            continue
        if ignore and f.code in ignore:
            continue
        if _suppressed(f, per_line, per_file):
            continue
        out.append(f)
    return out


def _lint_module(path, src, tree, index, select=None, ignore=None):
    """Per-module rules (including the class-local concurrency pass) +
    the project-wide FL110 replay pass over ``index``, filtered through
    suppressions/select/ignore."""
    from fedml_tpu_torch.analysis.concurrency import (check_concurrency,
                                                      check_eventloop)
    from fedml_tpu_torch.analysis.dataflow import (ProjectIndex,
                                                   check_use_after_replay)
    per_line, per_file = _parse_suppressions(src)
    linter = _ModuleLinter(path, src, tree, index)
    linter.run()
    check_concurrency(tree, linter.add)
    check_eventloop(tree, linter.add)
    check_use_after_replay(index, ProjectIndex.module_name(path), tree,
                           linter.add)
    out = _filter_findings(linter.findings, per_line, per_file,
                           select=select, ignore=ignore)
    out.sort(key=lambda f: (f.line, f.col, f.code))
    return out


def lint_source(src, path="<string>", select=None, ignore=None):
    """Lint one module's source (project-wide rules see only this one
    module). Returns non-suppressed findings."""
    from fedml_tpu_torch.analysis.dataflow import ProjectIndex
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding(path=path, line=e.lineno or 1, col=(e.offset or 0),
                        code="FL100", message=f"syntax error: {e.msg}")]
    index = ProjectIndex()
    index.add_module(path, tree, _Aliases(tree))
    return _lint_module(path, src, tree, index, select=select,
                        ignore=ignore)


def iter_python_files(paths):
    for p in paths:
        if os.path.isfile(p):
            yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)


def lint_paths(paths, select=None, ignore=None):
    """Two-pass project lint: pass 1 parses every file and builds the
    cross-module symbol table (traced and graphed callables travel
    through builder returns and imports); pass 2 runs the per-module
    rules with that index in scope."""
    from fedml_tpu_torch.analysis.dataflow import ProjectIndex
    index = ProjectIndex()
    modules, findings = [], []
    for path in iter_python_files(paths):
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        rel = os.path.relpath(path)
        try:
            tree = ast.parse(src, filename=rel)
        except SyntaxError as e:
            findings.append(Finding(
                path=rel, line=e.lineno or 1, col=(e.offset or 0),
                code="FL100", message=f"syntax error: {e.msg}"))
            continue
        index.add_module(rel, tree, _Aliases(tree))
        modules.append((rel, src, tree))
    for rel, src, tree in modules:
        findings.extend(_lint_module(rel, src, tree, index, select=select,
                                     ignore=ignore))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return findings


# -- baseline -------------------------------------------------------------

def load_baseline(path):
    """-> Counter of finding keys; empty when the file doesn't exist."""
    if not path or not os.path.exists(path):
        return Counter()
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    return Counter((e["path"], e["code"], e.get("text", ""))
                   for e in data.get("findings", []))


def apply_baseline(findings, baseline):
    """Mark findings present in the baseline (multiset semantics: N
    baselined occurrences tolerate N findings with the same fingerprint).
    Returns the list of NEW findings."""
    budget = Counter(baseline)
    new = []
    for f in findings:
        if budget[f.key()] > 0:
            budget[f.key()] -= 1
            f.baselined = True
        else:
            new.append(f)
    return new


def write_baseline(findings, path):
    entries = [{"path": f.path.replace(os.sep, "/"), "code": f.code,
                "text": f.text} for f in findings]
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": 1, "findings": entries}, fh, indent=2,
                  sort_keys=True)
        fh.write("\n")


# -- reporters ------------------------------------------------------------

def render_text(findings, show_baselined=False):
    lines = []
    for f in findings:
        if f.baselined and not show_baselined:
            continue
        tag = " [baselined]" if f.baselined else ""
        lines.append(f"{f.path}:{f.line}:{f.col}: {f.code} {f.message}{tag}")
    new = sum(1 for f in findings if not f.baselined)
    base = sum(1 for f in findings if f.baselined)
    lines.append(f"fedlint: {len(findings)} finding(s) "
                 f"({base} baselined, {new} new)")
    return "\n".join(lines)


def render_json(findings):
    return json.dumps({
        "findings": [f.as_dict() for f in findings],
        "summary": {"total": len(findings),
                    "baselined": sum(1 for f in findings if f.baselined),
                    "new": sum(1 for f in findings if not f.baselined)},
    }, indent=2)


def render_sarif(findings):
    """SARIF 2.1.0 report (one run), so CI can annotate findings on PRs.
    Baselined findings carry a ``suppressions`` entry -- SARIF viewers
    show them greyed out instead of failing the check."""
    catalog = dict(RULES)
    catalog.setdefault("FL100", (
        "syntax error in a linted file",
        "the file never parsed; nothing else was checked."))
    rules = [{
        "id": code,
        "shortDescription": {"text": title},
        "fullDescription": {"text": rationale},
        "defaultConfiguration": {"level": "warning"},
        "properties": {"tags": rule_tags(code)},
    } for code, (title, rationale) in sorted(catalog.items())]
    rule_index = {r["id"]: i for i, r in enumerate(rules)}
    results = []
    for f in findings:
        res = {
            "ruleId": f.code,
            "ruleIndex": rule_index.get(f.code, -1),
            "level": "warning",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f.path.replace(os.sep, "/")},
                    "region": {"startLine": f.line,
                               "startColumn": max(f.col, 1)},
                },
            }],
        }
        if f.baselined:
            res["suppressions"] = [{
                "kind": "external",
                "justification": "accepted debt in fedlint_baseline.json",
            }]
        results.append(res)
    return json.dumps({
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "fedlint",
                "rules": rules,
            }},
            "results": results,
        }],
    }, indent=2)
