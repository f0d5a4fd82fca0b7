"""Carry a flax parameter tree of ofasys_tpu into the port's modules.

``params`` is the tree as nested dicts of numpy arrays
(``jax.device_get(params)``). Module paths match one to one; leaf names map
as follows:

  * Dense ``kernel`` (in, out)     -> ``weight`` (out, in), transposed
  * LayerNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``
  * Embed ``embedding``            -> ``weight``
  * any other leaf (``bias``, ``c_attn``, ``rel_pos_table``,
    ``type_embedding``, ...)       -> the parameter of the same name

Every parameter of the net must be filled and every leaf of the tree used;
anything else raises. ``export_params`` goes the other way, for the net's
parameters or for any tensors named like them (their gradients).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def _walk(tree: Dict[str, Any], path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def load_jax_params(net: nn.Module, params: Dict[str, Any]) -> nn.Module:
    """Copy ``params`` into ``net`` in place (dtype and device of the net's
    parameters kept); returns ``net``."""
    if "params" in params and isinstance(params["params"], dict) and len(params) == 1:
        params = params["params"]
    own = dict(net.named_parameters())
    seen = set()
    with torch.no_grad():
        for path, value in _walk(params):
            leaf = path[-1]
            name = ".".join(path[:-1] + (_RENAME.get(leaf, leaf),))
            if name not in own:
                raise KeyError(f"flax param {'/'.join(path)} has no counterpart ({name}) in the net")
            arr = np.asarray(value)
            if leaf == "kernel":
                arr = arr.T
            p = own[name]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{'/'.join(path)}: shape {arr.shape} vs {name} {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)).to(p.dtype))
            seen.add(name)
    missing = sorted(set(own) - seen)
    if missing:
        raise KeyError(f"net parameters missing from the flax tree: {missing}")
    return net


def export_params(net: nn.Module, tensors: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """The flax-shaped tree (nested dicts of fp32 numpy arrays) of the
    net's parameters, or of ``tensors``, a dict from parameter name to a
    tensor of the parameter's shape (``{n: p.grad for n, p in
    net.named_parameters()}``); the inverse of :func:`load_jax_params`."""
    tree: Dict[str, Any] = {}
    for name, p in net.named_parameters():
        value = p if tensors is None else tensors[name]
        path, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        module = net.get_submodule(path) if path else net
        arr = value.detach().float().cpu().numpy()
        if leaf == "weight" and isinstance(module, nn.Linear):
            leaf, arr = "kernel", arr.T
        elif leaf == "weight" and isinstance(module, nn.LayerNorm):
            leaf = "scale"
        elif leaf == "weight" and isinstance(module, nn.Embedding):
            leaf = "embedding"
        node = tree
        for k in path.split(".") if path else ():
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree
