"""The port's weight carrier: the JAX package's CifarResNet variables
<-> the port's state (counterpart of ``fedml_tpu/utils/torch_import.py``).

JAX side: ``{"params": ..., "batch_stats": ...}`` nested dicts of numpy
arrays with flax names (``layer{s}_block{b}/{conv1,bn1,...}``), conv
kernels HWIO, dense kernels ``[in, out]``. Port side: ``{"params":
{name: tensor}, "batch_stats": {name: tensor}}`` with torch state_dict
names (``layer{s}.{b}.conv1.weight``, ``layer{s}.{b}.downsample.{0,1}``),
conv weights OIHW, linear weights ``[out, in]``. Both directions take
single or lane-stacked variables (a leading lane axis on every leaf);
the layout transforms act on the trailing axes. Round trips are exact.
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


def module_state(model):
    """The port state of an ``nn.Module`` (its parameters and its
    running BatchNorm statistics), detached."""
    sd = model.state_dict()
    names = {n for n, _ in model.named_parameters()}
    return {"params": {k: sd[k].detach().clone() for k in sd if k in names},
            "batch_stats": {k: sd[k].detach().clone() for k in sd
                            if k.endswith(("running_mean", "running_var"))}}


__all__ = ["variables_to_state", "state_to_variables", "module_state"]
