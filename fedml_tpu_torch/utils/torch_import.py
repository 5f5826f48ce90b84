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

LR and the CNNs (:func:`zoo_variables_to_state`): every layer sits at
the top of ``params`` (``linear``; ``conv1``, ``conv2``, ``fc1``,
``fc2``) and maps to ``<name>.weight`` / ``<name>.bias``. The port's CNNs
flatten in flax's (H, W, C) order, so ``fc1`` needs no permutation.

The LSTM LMs (:func:`rnn_variables_to_state`): flax names each LSTM
``OptimizedLSTMCell_{j}`` (in order), which maps to ``lstm{j+1}``: the
input kernels ``ii/if/ig/io`` ``[in, H]`` concatenated in that order and
transposed -> ``weight_ih [4H, in]``, the hidden kernels ``hi/hf/hg/ho``
-> ``weight_hh [4H, H]`` and their biases -> ``bias_hh [4H]``; an
``embedding`` -> ``<name>.weight``, a Dense -> ``<name>.weight`` ``[out,
in]`` and ``.bias``.

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


def zoo_variables_to_state(variables, convs=(), device="cpu"):
    """JAX variables of a model whose layers sit at the top of ``params``
    (LR, the CNNs; single or lane-stacked) -> fp32 port state
    ``{"params": ...}``: kernels of the layers named in ``convs`` HWIO ->
    OIHW, the other kernels ``[in, out] -> [out, in]``, biases as they
    are."""
    p = {}
    for name, leaf in variables["params"].items():
        k = leaf["kernel"]
        p[f"{name}.weight"] = (_hwio_to_oihw(k) if name in convs
                               else _swap_last2(k))
        if "bias" in leaf:
            p[f"{name}.bias"] = np.asarray(leaf["bias"])
    return {"params": {k: torch.as_tensor(np.array(v, np.float32, order="C"),
                                          device=device)
                       for k, v in p.items()}}


def zoo_state_to_variables(state, convs=()):
    """Inverse of :func:`zoo_variables_to_state`."""
    params = {}
    for key, v in state["params"].items():
        name, kind = key.rsplit(".", 1)
        v = v.detach().cpu().numpy()
        leaf = params.setdefault(name, {})
        if kind == "bias":
            leaf["bias"] = v
        else:
            leaf["kernel"] = (_oihw_to_hwio(v) if name in convs
                              else _swap_last2(v))
    return {"params": params}


_GATES = ("i", "f", "g", "o")
_CELL = "OptimizedLSTMCell_"


def rnn_variables_to_state(variables, device="cpu"):
    """JAX ``RNNOriginalFedAvg``/``RNNStackOverflow`` variables (single
    or client-stacked) -> fp32 port state ``{"params": ...}``."""
    p = {}
    for name, leaf in variables["params"].items():
        if name.startswith(_CELL):
            tp = f"lstm{int(name[len(_CELL):]) + 1}"
            cat = lambda kind, part: np.concatenate(
                [np.asarray(leaf[f"{kind}{g}"][part]) for g in _GATES],
                axis=-1)
            p[f"{tp}.weight_ih"] = _swap_last2(cat("i", "kernel"))
            p[f"{tp}.weight_hh"] = _swap_last2(cat("h", "kernel"))
            p[f"{tp}.bias_hh"] = cat("h", "bias")
        elif "embedding" in leaf:
            p[f"{name}.weight"] = np.asarray(leaf["embedding"])
        else:
            p[f"{name}.weight"] = _swap_last2(leaf["kernel"])
            p[f"{name}.bias"] = np.asarray(leaf["bias"])
    return {"params": {k: torch.as_tensor(np.array(v, np.float32, order="C"),
                                          device=device)
                       for k, v in p.items()}}


def rnn_state_to_variables(state):
    """Inverse of :func:`rnn_variables_to_state`."""
    params = {}
    for key, v in state["params"].items():
        name, kind = key.rsplit(".", 1)
        v = v.detach().cpu().numpy()
        if name.startswith("lstm"):
            cell = params.setdefault(f"{_CELL}{int(name[4:]) - 1}", {})
            if kind == "bias_hh":
                for g, part in zip(_GATES, np.split(v, 4, axis=-1)):
                    cell.setdefault(f"h{g}", {})["bias"] = part
            else:
                src = "i" if kind == "weight_ih" else "h"
                for g, part in zip(_GATES, np.split(_swap_last2(v), 4,
                                                    axis=-1)):
                    cell.setdefault(f"{src}{g}", {})["kernel"] = part
        elif kind == "weight" and name.endswith("embeddings"):
            params[name] = {"embedding": v}
        elif kind == "weight":
            params.setdefault(name, {})["kernel"] = _swap_last2(v)
        else:
            params.setdefault(name, {})["bias"] = v
    return {"params": params}


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


def reference_names(names):
    """Port parameter names -> ``{port name: the reference's key path}``
    for the ResNets, the (MoE) TransformerLMs, LR and the CNNs, whose
    leaves map one to one (the layouts differ: conv kernels HWIO against
    OIHW, dense kernels ``[in, out]`` against ``[out, in]``); None for a
    tree that does not map so (the LSTMs split and join leaves)."""
    names = set(names)
    if "tok_embed.weight" in names:
        n_layers = len({k.split(".")[1] for k in names
                        if k.startswith("blocks.")})
        modules = _lm_modules(n_layers, "blocks.0.moe.wi" in names)
    elif "conv1.weight" in names and "layer1.0.conv1.weight" in names:
        n = len({k.split(".")[1] for k in names if k.startswith("layer1.")})
        modules = _modules(6 * n + 2)
    elif all(k.count(".") == 1 and k.endswith((".weight", ".bias"))
             for k in names) and not any(k.startswith("lstm")
                                         for k in names):
        modules = [((k.split(".")[0],), k.split(".")[0], "dense")
                   for k in names]
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


def reference_tree(params):
    """A port ``{name: leaf}`` dict re-keyed under the reference's nested
    names (:func:`reference_names`), its leaves untouched; the dict
    itself where the names do not map one to one."""
    paths = reference_names(params)
    if paths is None:
        return params
    out = {}
    for name, leaf in params.items():
        _put(out, paths[name], leaf)
    return out


__all__ = ["variables_to_state", "state_to_variables",
           "lm_variables_to_state", "lm_state_to_variables",
           "zoo_variables_to_state", "zoo_state_to_variables",
           "rnn_variables_to_state", "rnn_state_to_variables",
           "module_state", "server_state_from_optax",
           "server_state_to_optax", "reference_names", "reference_tree"]
