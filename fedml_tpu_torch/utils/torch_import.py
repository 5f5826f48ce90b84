"""The port's weight carrier: the JAX package's CifarResNet and
TransformerLM variables <-> the port's state (counterpart of
``fedml_tpu/utils/torch_import.py``).

JAX side: ``{"params": ..., "batch_stats": ...}`` nested dicts of numpy
arrays with flax names (``layer{s}_block{b}/{conv1,bn1,...}``), conv
kernels HWIO, dense kernels ``[in, out]``. Port side: ``{"params":
{name: tensor}, "batch_stats": {name: tensor}}`` with torch state_dict
names (``layer{s}.{b}.conv1.weight``, ``layer{s}.{b}.downsample.{0,1}``),
conv weights OIHW, linear weights ``[out, in]``. Both directions take
single or lane-stacked variables (a leading lane axis on every leaf);
the layout transforms act on the trailing axes. Round trips are exact.

TransformerLM (:func:`lm_variables_to_state`): ``tok_embed``/``pos_embed``
``embedding`` -> ``{tok,pos}_embed.weight``; ``block{i}/{ln1,ln2}/{scale,
bias}`` -> ``blocks.{i}.{ln1,ln2}.{weight,bias}``; the ``qkv``/``proj``
kernels (no bias) and ``mlp_up``/``mlp_down`` kernel and bias ->
``blocks.{i}.<name>.weight`` ``[out, in]`` (and ``.bias``); ``ln_f`` and
``head`` alike. The port's state is ``{"params": {...}}``. The MoE
TransformerLM's blocks hold ``block{i}/moe`` in place of the MLP: its
``router`` is a Dense (kernel transposed, with bias) ->
``blocks.{i}.moe.router.{weight,bias}``, and ``wi [E, C, H]`` / ``wo [E,
H, C]`` are einsum parameters -> ``blocks.{i}.moe.{wi,wo}`` untransposed.

The LSTM LMs (:func:`rnn_variables_to_state`): flax names each LSTM
``OptimizedLSTMCell_{j}`` (in order), which maps to ``lstm{j+1}``: the
input kernels ``ii/if/ig/io`` ``[in, H]`` concatenated in that order and
transposed -> ``weight_ih [4H, in]``, the hidden kernels ``hi/hf/hg/ho``
-> ``weight_hh [4H, H]`` and their biases -> ``bias_hh [4H]``; an
``embedding`` -> ``<name>.weight``, a Dense -> ``<name>.weight`` ``[out,
in]`` and ``.bias``.

The DARTS networks, DeepLab and the FedGKT pair go through the CV
carrier too: DARTS' ``arch`` collection (``alphas_normal``,
``alphas_reduce``) is carried as its own top-level key, its ops'
norms carry statistics and no scale or bias, and the GKT ResNets'
shortcuts (the port's ``downsample.{0,1}``) are renamed by
:func:`gkt_variables_to_state`.

LR, the CNNs, the vertical-FL party models (``DenseModel``,
``LocalModel``), SplitNN's halves (``lead=1`` for the client halves,
stacked on a client axis) and the CV zoo -- ResNetGN, MobileNet,
MobileNetV3, EfficientNet and VGG (:func:`cv_variables_to_state`): every
port submodule carries flax's name (``linear``, ``hidden_0``,
``Dense_1``, ``conv1``, ``fc2``, ``layer1_block0.downsample_conv``,
``block3.dw``, ``bneck4.se.fc1``, ``block2_1.se_reduce``, ``conv7``,
``head``), so one rule maps a
nested flax tree of any depth: a 4-D ``kernel`` HWIO -> OIHW
(a depthwise ``[kh, kw, 1, C]`` becomes ``[C, 1, kh, kw]``), a 2-D
``kernel`` transposed, ``scale`` -> ``weight``, ``bias`` as it is, and
``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``.

A whole node state under the reference's names, BatchNorm statistics
included (:func:`reference_state`), frames the gossip rounds' wire.

Server optimizer state (:func:`server_state_from_optax`): the JAX
package's optax chain state (``TraceState``, ``ScaleByAdamState`` or
``ScaleByRssState`` first) -> the port's ``{"trace"}``, ``{"count",
"mu", "nu"}`` or ``{"sum_of_squares"}`` (``algorithms/fedopt.py``),
each moment carried by the model's carrier above; and back.
"""

from __future__ import annotations

import numpy as np
import torch


def _hwio_to_oihw(w):
    w = np.asarray(w)
    lead = tuple(range(w.ndim - 4))
    return np.transpose(w, lead + tuple(d + len(lead) for d in (3, 2, 0, 1)))


def _oihw_to_hwio(w):
    w = np.asarray(w)
    lead = tuple(range(w.ndim - 4))
    return np.transpose(w, lead + tuple(d + len(lead) for d in (2, 3, 1, 0)))


def _swap_last2(w):
    """The last two axes swapped: a tensor (on any device) stays one,
    anything else becomes an array."""
    if isinstance(w, torch.Tensor):
        return w.transpose(-1, -2)
    return np.swapaxes(np.asarray(w), -1, -2)


def _modules(depth):
    """``(flax path, torch prefix, kind)`` for every layer of the net."""
    n = (depth - 2) // 6
    out = [(("conv1",), "conv1", "conv"), (("bn1",), "bn1", "bn")]
    for s in (1, 2, 3):
        for b in range(n):
            blk, tp = f"layer{s}_block{b}", f"layer{s}.{b}"
            out += [((blk, "conv1"), f"{tp}.conv1", "conv"),
                    ((blk, "bn1"), f"{tp}.bn1", "bn"),
                    ((blk, "conv2"), f"{tp}.conv2", "conv"),
                    ((blk, "bn2"), f"{tp}.bn2", "bn"),
                    ((blk, "downsample_conv"), f"{tp}.downsample.0", "conv"),
                    ((blk, "downsample_bn"), f"{tp}.downsample.1", "bn")]
    out.append((("fc",), "fc", "dense"))
    return out


def _get(tree, path):
    for k in path:
        if k not in tree:
            return None
        tree = tree[k]
    return tree


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def variables_to_state(variables, depth, device="cpu"):
    """JAX CifarResNet variables (numpy or jax arrays, single or
    lane-stacked) -> fp32 port state on ``device``."""
    params, stats = variables["params"], variables["batch_stats"]
    p, bs = {}, {}
    for path, tp, kind in _modules(depth):
        mp = _get(params, path)
        if mp is None:  # blocks without a downsample shortcut
            continue
        if kind == "conv":
            p[f"{tp}.weight"] = _hwio_to_oihw(mp["kernel"])
        elif kind == "dense":
            p[f"{tp}.weight"] = _swap_last2(mp["kernel"])
            p[f"{tp}.bias"] = np.asarray(mp["bias"])
        else:
            ms = _get(stats, path)
            p[f"{tp}.weight"] = np.asarray(mp["scale"])
            p[f"{tp}.bias"] = np.asarray(mp["bias"])
            bs[f"{tp}.running_mean"] = np.asarray(ms["mean"])
            bs[f"{tp}.running_var"] = np.asarray(ms["var"])
    conv = lambda a: torch.as_tensor(
        np.array(a, np.float32, order="C"), device=device)
    return {"params": {k: conv(v) for k, v in p.items()},
            "batch_stats": {k: conv(v) for k, v in bs.items()}}


def state_to_variables(state, depth):
    """Inverse of :func:`variables_to_state`: port state -> JAX
    CifarResNet variables as nested numpy dicts."""
    p = {k: v.detach().cpu().numpy() for k, v in state["params"].items()}
    bs = {k: v.detach().cpu().numpy()
          for k, v in state["batch_stats"].items()}
    params, stats = {}, {}
    for path, tp, kind in _modules(depth):
        if f"{tp}.weight" not in p:
            continue
        if kind == "conv":
            _put(params, path, {"kernel": _oihw_to_hwio(p[f"{tp}.weight"])})
        elif kind == "dense":
            _put(params, path, {"kernel": _swap_last2(p[f"{tp}.weight"]),
                                "bias": p[f"{tp}.bias"]})
        else:
            _put(params, path, {"scale": p[f"{tp}.weight"],
                                "bias": p[f"{tp}.bias"]})
            _put(stats, path, {"mean": bs[f"{tp}.running_mean"],
                               "var": bs[f"{tp}.running_var"]})
    return {"params": params, "batch_stats": stats}


def _lm_modules(n_layers, moe=False):
    """``(flax path, torch name or prefix, kind)`` for every layer of a
    TransformerLM (``moe``: of an MoE TransformerLM)."""
    out = [(("tok_embed",), "tok_embed", "embed"),
           (("pos_embed",), "pos_embed", "embed")]
    for i in range(n_layers):
        blk, tp = f"block{i}", f"blocks.{i}"
        out += [((blk, "ln1"), f"{tp}.ln1", "ln"),
                ((blk, "qkv"), f"{tp}.qkv", "dense"),
                ((blk, "proj"), f"{tp}.proj", "dense"),
                ((blk, "ln2"), f"{tp}.ln2", "ln")]
        if moe:
            out += [((blk, "moe", "router"), f"{tp}.moe.router", "dense"),
                    ((blk, "moe", "wi"), f"{tp}.moe.wi", "raw"),
                    ((blk, "moe", "wo"), f"{tp}.moe.wo", "raw")]
        else:
            out += [((blk, "mlp_up"), f"{tp}.mlp_up", "dense"),
                    ((blk, "mlp_down"), f"{tp}.mlp_down", "dense")]
    return out + [(("ln_f",), "ln_f", "ln"), (("head",), "head", "dense")]


def lm_variables_to_state(variables, device="cpu"):
    """JAX TransformerLM variables (numpy or jax arrays, single or
    client-stacked) -> fp32 port state ``{"params": ...}`` on ``device``."""
    params = variables["params"]
    n_layers = sum(1 for k in params if k.startswith("block"))
    moe = n_layers > 0 and "moe" in params["block0"]
    p = {}
    for path, tp, kind in _lm_modules(n_layers, moe):
        mp = _get(params, path)
        if kind == "raw":
            p[tp] = np.asarray(mp)
        elif kind == "embed":
            p[f"{tp}.weight"] = np.asarray(mp["embedding"])
        elif kind == "ln":
            p[f"{tp}.weight"] = np.asarray(mp["scale"])
            p[f"{tp}.bias"] = np.asarray(mp["bias"])
        else:
            p[f"{tp}.weight"] = _swap_last2(mp["kernel"])
            if "bias" in mp:
                p[f"{tp}.bias"] = np.asarray(mp["bias"])
    return {"params": {k: torch.as_tensor(np.array(v, np.float32, order="C"),
                                          device=device)
                       for k, v in p.items()}}


def lm_state_to_variables(state):
    """Inverse of :func:`lm_variables_to_state`: port state -> JAX
    TransformerLM variables as nested numpy dicts."""
    p = {k: v.detach().cpu().numpy() for k, v in state["params"].items()}
    n_layers = len({k.split(".")[1] for k in p if k.startswith("blocks.")})
    moe = "blocks.0.moe.wi" in p
    params = {}
    for path, tp, kind in _lm_modules(n_layers, moe):
        if kind == "raw":
            _put(params, path, p[tp])
        elif kind == "embed":
            _put(params, path, {"embedding": p[f"{tp}.weight"]})
        elif kind == "ln":
            _put(params, path, {"scale": p[f"{tp}.weight"],
                                "bias": p[f"{tp}.bias"]})
        else:
            leaf = {"kernel": _swap_last2(p[f"{tp}.weight"])}
            if f"{tp}.bias" in p:
                leaf["bias"] = p[f"{tp}.bias"]
            _put(params, path, leaf)
    return {"params": params}


def _leaves(tree, prefix=()):
    """``(path, leaf)`` for every leaf of a nested dict, in its order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


#: flax leaf -> the port's parameter suffix, and the statistics
_CV_PARAM = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_CV_STAT = {"mean": "running_mean", "var": "running_var"}


def cv_variables_to_state(variables, lead=0, device="cpu"):
    """JAX variables of a CV-zoo model (numpy or jax arrays; ``lead``
    leading axes on every leaf, such as a client axis) -> fp32 port
    state ``{"params", "batch_stats"}`` on ``device`` (``batch_stats``
    empty for a model without BatchNorm)."""
    p, bs = {}, {}
    for path, v in _leaves(variables.get("params", {})):
        v = np.asarray(v)
        if path[-1] == "kernel":
            v = _hwio_to_oihw(v) if v.ndim - lead == 4 else _swap_last2(v)
        p[".".join(path[:-1] + (_CV_PARAM[path[-1]],))] = v
    for path, v in _leaves(variables.get("batch_stats", {})):
        bs[".".join(path[:-1] + (_CV_STAT[path[-1]],))] = np.asarray(v)
    conv = lambda a: torch.as_tensor(
        np.array(a, np.float32, order="C"), device=device)
    out = {"params": {k: conv(v) for k, v in p.items()},
           "batch_stats": {k: conv(v) for k, v in bs.items()}}
    if "arch" in variables:
        out["arch"] = {k: conv(v) for k, v in variables["arch"].items()}
    return out


def cv_state_to_variables(state, lead=0):
    """Inverse of :func:`cv_variables_to_state`: port state -> JAX
    variables as nested numpy dicts (no ``batch_stats`` for a model
    without BatchNorm)."""
    params, stats = {}, {}
    for key, v in state["params"].items():
        v = v.detach().cpu().numpy()
        path = tuple(key.split("."))
        nd = v.ndim - lead
        if path[-1] == "bias":
            leaf = "bias"
        elif nd == 4:
            leaf, v = "kernel", _oihw_to_hwio(v)
        elif nd == 2:
            leaf, v = "kernel", _swap_last2(v)
        else:
            leaf = "scale"
        _put(params, path[:-1] + (leaf,), v)
    names = {v: k for k, v in _CV_STAT.items()}
    for key, v in state.get("batch_stats", {}).items():
        path = tuple(key.split("."))
        _put(stats, path[:-1] + (names[path[-1]],), v.detach().cpu().numpy())
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    if "arch" in state:
        out["arch"] = {k: v.detach().cpu().numpy()
                       for k, v in state["arch"].items()}
    return out


#: the reference ResNet block's shortcut names -> the port's
_GKT_SHORTCUT = {"downsample_conv": "downsample.0",
                 "downsample_bn": "downsample.1"}


def _rename(state, table):
    def key(k):
        for a, b in table.items():
            k = k.replace(f".{a}.", f".{b}.")
        return k
    return {c: {key(k): v for k, v in tree.items()}
            for c, tree in state.items()}


def gkt_variables_to_state(variables, lead=0, device="cpu"):
    """JAX variables of a FedGKT client or server ResNet (``lead``
    leading axes, such as the API's client axis) -> fp32 port state: the
    CV carrier with the blocks' shortcuts renamed to the port's
    ``downsample.{0,1}``."""
    return _rename(cv_variables_to_state(variables, lead, device),
                   _GKT_SHORTCUT)


def gkt_state_to_variables(state, lead=0):
    """Inverse of :func:`gkt_variables_to_state`."""
    back = {v: k for k, v in _GKT_SHORTCUT.items()}
    return cv_state_to_variables(_rename(state, back), lead)


_GATES = ("i", "f", "g", "o")
_CELL = "OptimizedLSTMCell_"


def rnn_variables_to_state(variables, device="cpu"):
    """JAX ``RNNOriginalFedAvg``/``RNNStackOverflow`` variables (single
    or client-stacked) -> fp32 port state ``{"params": ...}``, the gate
    leaves fused by :func:`gate_join`."""
    return {"params": {k: torch.as_tensor(np.array(v, np.float32, order="C"),
                                          device=device)
                       for k, v in gate_join(variables["params"]).items()}}


def rnn_state_to_variables(state):
    """Inverse of :func:`rnn_variables_to_state`: numpy leaves split by
    :func:`gate_split`."""
    return {"params": gate_split({k: v.detach().cpu().numpy()
                                  for k, v in state["params"].items()})}


def module_state(model):
    """The port state of an ``nn.Module`` (its parameters and its
    running BatchNorm statistics), detached."""
    sd = model.state_dict()
    names = {n for n, _ in model.named_parameters()}
    return {"params": {k: sd[k].detach().clone() for k in sd if k in names},
            "batch_stats": {k: sd[k].detach().clone() for k in sd
                            if k.endswith(("running_mean", "running_var"))}}


#: the port's server-state fields of each optax state in a server
#: optimizer's chain (``algorithms/fedopt.py``): param-shaped trees and
#: the step count
_TREE_FIELDS = ("trace", "mu", "nu", "sum_of_squares")


def server_state_from_optax(opt_state, params_to_state):
    """The JAX package's server optimizer state -> the port's server
    state. ``opt_state`` is the ``optax.chain`` state with numpy leaves
    (its first element a ``TraceState``, ``ScaleByAdamState`` or
    ``ScaleByRssState``); ``params_to_state`` maps JAX variables ``{"params":
    tree}`` to port state ``{"params": {name: tensor}}`` (one of the
    carriers above, with its model's arguments bound)."""
    out = {}
    for name, value in opt_state[0]._asdict().items():
        if name == "count":
            out["count"] = torch.as_tensor(np.asarray(value, np.int32))
        elif name in _TREE_FIELDS:
            out[name] = params_to_state({"params": value})["params"]
        else:
            raise ValueError(f"unknown optimizer state field {name!r}")
    return out


def server_state_to_optax(state, state_to_params, template):
    """Inverse of :func:`server_state_from_optax`: the port's server
    state in the form of ``template`` (a reference state of the same
    optimizer, whose types are reused); ``state_to_params`` maps port
    state to JAX variables."""
    fields = {}
    for name in template[0]._fields:
        if name == "count":
            fields[name] = state["count"].detach().cpu().numpy()
        else:
            fields[name] = state_to_params({"params": state[name]})["params"]
    return (type(template[0])(**fields),) + tuple(template[1:])


#: (kind, port suffix) -> the reference's leaf name in a layer
_LEAF = {("conv", "weight"): "kernel", ("dense", "weight"): "kernel",
         ("dense", "bias"): "bias", ("bn", "weight"): "scale",
         ("bn", "bias"): "bias", ("ln", "weight"): "scale",
         ("ln", "bias"): "bias", ("embed", "weight"): "embedding"}


def _cv_leaf(module, suffix):
    """The flax leaf of a CV-zoo (or LR/CNN) port parameter: ``bias``, or
    ``scale`` for a norm layer's weight (the zoo names every norm layer
    ``bn...`` or ``..._bn``), else ``kernel``."""
    if suffix == "bias":
        return "bias"
    last = module.rsplit(".", 1)[-1]
    return "scale" if last.startswith(("bn", "BatchNorm")) or last.endswith(
        "_bn") else "kernel"


def reference_names(names):
    """Port parameter names -> ``{port name: the reference's key path}``
    for the ResNets, the (MoE) TransformerLMs, LR, the CNNs and the CV
    zoo, whose leaves map one to one (the layouts differ: conv kernels
    HWIO against OIHW, dense kernels ``[in, out]`` against ``[out,
    in]``); None for a tree that does not map so (the LSTMs split and
    join leaves: :func:`gate_split`)."""
    names = set(names)
    if "tok_embed.weight" in names:
        n_layers = len({k.split(".")[1] for k in names
                        if k.startswith("blocks.")})
        modules = _lm_modules(n_layers, "blocks.0.moe.wi" in names)
    elif "conv1.weight" in names and "layer1.0.conv1.weight" in names:
        n = len({k.split(".")[1] for k in names if k.startswith("layer1.")})
        modules = _modules(6 * n + 2)
    elif all(k.endswith((".weight", ".bias")) for k in names) and not any(
            k.startswith("lstm") for k in names):
        # LR, the CNNs and the CV zoo: flax's names, nested by the dots
        return {k: tuple(k.rsplit(".", 1)[0].split("."))
                + (_cv_leaf(*k.rsplit(".", 1)),) for k in names}
    else:
        return None
    out = {}
    for path, tp, kind in modules:
        if kind == "raw":
            if tp in names:
                out[tp] = path
            continue
        for suffix in ("weight", "bias"):
            leaf = _LEAF.get((kind, suffix))
            if leaf is not None and f"{tp}.{suffix}" in names:
                out[f"{tp}.{suffix}"] = path + (leaf,)
    return out if set(out) == names else None


def _contig(x):
    return (x.contiguous() if isinstance(x, torch.Tensor)
            else np.ascontiguousarray(x))


def _cat(xs):
    return torch.cat(xs, dim=-1) if isinstance(xs[0], torch.Tensor) else (
        np.concatenate(xs, axis=-1))


def gate_split(params):
    """An LSTM model's port ``{name: leaf}`` dict -> the reference's tree:
    each fused leaf split into flax's gate leaves under
    ``OptimizedLSTMCell_{j}/{ii..io,hi..ho}/{kernel,bias}`` in flax's
    layout (kernels ``[in, H]``), embeddings under ``<name>/embedding``
    and Dense kernels transposed to ``[in, out]`` -- what the reference
    compresses and frames. Leaves may be tensors (on any device) or
    arrays and may lead with more axes (a client axis); the gate leaves
    are contiguous copies. Any tree without LSTM leaves comes back as it
    is."""
    if not any(k.startswith("lstm") for k in params):
        return params
    out = {}
    for key, v in params.items():
        name, kind = key.rsplit(".", 1)
        if name.startswith("lstm"):
            cell = out.setdefault(f"{_CELL}{int(name[4:]) - 1}", {})
            h = v.shape[-1] // 4 if kind == "bias_hh" else v.shape[-2] // 4
            src = "i" if kind == "weight_ih" else "h"
            for j, g in enumerate(_GATES):
                if kind == "bias_hh":
                    cell.setdefault(f"h{g}", {})["bias"] = _contig(
                        v[..., j * h:(j + 1) * h])
                else:
                    cell.setdefault(f"{src}{g}", {})["kernel"] = _contig(
                        _swap_last2(v[..., j * h:(j + 1) * h, :]))
        elif kind == "weight" and name.endswith("embeddings"):
            out[name] = {"embedding": v}
        elif kind == "weight":
            out.setdefault(name, {})["kernel"] = _contig(_swap_last2(v))
        else:
            out.setdefault(name, {})["bias"] = v
    return out


def gate_join(tree):
    """Inverse of :func:`gate_split`: the reference's LSTM tree -> the
    port's fused ``{name: leaf}`` dict (a flat port dict comes back as it
    is)."""
    if not any(k.startswith(_CELL) for k in tree):
        return tree
    out = {}
    for name, leaf in tree.items():
        if name.startswith(_CELL):
            tp = f"lstm{int(name[len(_CELL):]) + 1}"
            cat = lambda src, part: _cat([leaf[f"{src}{g}"][part]
                                          for g in _GATES])
            out[f"{tp}.weight_ih"] = _contig(_swap_last2(cat("i", "kernel")))
            out[f"{tp}.weight_hh"] = _contig(_swap_last2(cat("h", "kernel")))
            out[f"{tp}.bias_hh"] = cat("h", "bias")
        elif "embedding" in leaf:
            out[f"{name}.weight"] = leaf["embedding"]
        else:
            out[f"{name}.weight"] = _contig(_swap_last2(leaf["kernel"]))
            out[f"{name}.bias"] = leaf["bias"]
    return out


def reference_tree(params):
    """A port ``{name: leaf}`` dict under the reference's nested names:
    re-keyed (:func:`reference_names`), its leaves untouched, where the
    names map one to one; the LSTMs' gate slices (:func:`gate_split`);
    the dict itself for any other tree."""
    if any(k.startswith("lstm") for k in params):
        return gate_split(params)
    paths = reference_names(params)
    if paths is None:
        return params
    out = {}
    for name, leaf in params.items():
        _put(out, paths[name], leaf)
    return out


def reference_state(state):
    """A port state (``{"params"}`` and any ``batch_stats``) under the
    reference's names: the params through :func:`reference_tree`, and
    each running statistic at its norm layer's path as ``mean`` or
    ``var``, where the params' names map one to one (as the reference
    frames a whole node state on the wire)."""
    out = {"params": reference_tree(state["params"])}
    stats = state.get("batch_stats")
    if stats:
        paths = reference_names(state["params"])
        names = {v: k for k, v in _CV_STAT.items()}
        bs = {}
        for key, leaf in stats.items():
            layer, kind = key.rsplit(".", 1)
            path = (paths[f"{layer}.weight"][:-1] if paths is not None
                    else tuple(layer.split(".")))
            _put(bs, path + (names[kind],), leaf)
        out["batch_stats"] = bs
    return out


__all__ = ["variables_to_state", "state_to_variables",
           "lm_variables_to_state", "lm_state_to_variables",
           "cv_variables_to_state", "cv_state_to_variables",
           "gkt_variables_to_state", "gkt_state_to_variables",
           "rnn_variables_to_state", "rnn_state_to_variables",
           "module_state", "server_state_from_optax",
           "server_state_to_optax", "reference_names", "reference_tree",
           "reference_state",
           "gate_split", "gate_join"]
