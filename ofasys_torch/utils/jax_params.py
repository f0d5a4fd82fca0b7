"""Carry a flax parameter tree of ofasys_tpu into the port's modules.

``params`` is the tree as nested dicts of numpy arrays
(``jax.device_get(params)``). Module paths match one to one; leaf names map
as follows:

  * Dense ``kernel`` (in, out)     -> ``weight`` (out, in), transposed
  * LayerNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``
  * Embed ``embedding``            -> ``weight``
  * PatchEmbed ``kernel`` (p, p, C, E), the ResNet's convolution
    ``kernel`` (kh, kw, Cin, Cout) and its FrozenBatchNorm ``scale`` ->
    the parameter of the same name, as it is (the modules keep flax's
    names and layouts; a leaf whose flax name the net has is never
    renamed or transposed)
  * any other leaf (``bias``, ``c_attn``, ``rel_pos_table``,
    ``type_embedding``, ...)       -> the parameter of the same name

Int8 serving variables, ``{"params": <pruned>, "qkern": {...}}`` as
``ofasys_tpu.ops.quant.quantize_for_serving`` returns them, are taken too:
each ``qkern/<module>/{q, scale}`` goes into that module's int8 buffers
(ops/quant.py; the module is made int8 first if it is not yet): a Dense's
``q`` (in, out) transposed to (out, in), the embedding's (E, V) attend table
transposed to (V, E).

Every parameter of the net must be filled and every leaf of the tree used;
anything else raises. ``export_params`` goes the other way, for the net's
parameters or for any tensors named like them (their gradients).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ofasys_torch.ops.quant import is_quantized, quantize_module

_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def _walk(tree: Dict[str, Any], path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def _load_qkern(net: nn.Module, qkern: Dict[str, Any]):
    """Each ``<module path>/{q, scale}`` of ``qkern`` into that module's int8
    buffers, on the net's device; ``q`` transposed to (out, in)."""
    groups: Dict[Tuple[str, ...], Dict[str, Any]] = {}
    for path, value in _walk(qkern):
        groups.setdefault(path[:-1], {})[path[-1]] = value
    for path, leaves in groups.items():
        if set(leaves) != {"q", "scale"}:
            raise KeyError(f"qkern/{'/'.join(path)} must hold exactly q and scale, got {sorted(leaves)}")
        module = net.get_submodule(".".join(path))
        if not isinstance(module, (nn.Linear, nn.Embedding)):
            raise KeyError(f"qkern/{'/'.join(path)} names no Dense or embedding of the net")
        q = torch.from_numpy(np.ascontiguousarray(np.asarray(leaves["q"], dtype=np.int8).T))
        scale = torch.from_numpy(np.asarray(leaves["scale"], dtype=np.float32).copy())
        rows, cols = (module.out_features, module.in_features) if isinstance(module, nn.Linear) \
            else tuple(module.weight.shape)
        if tuple(q.shape) != (rows, cols) or tuple(scale.shape) != (rows,):
            raise ValueError(f"qkern/{'/'.join(path)}: q {tuple(q.shape)} / scale "
                             f"{tuple(scale.shape)} vs ({rows}, {cols})")
        device = module.bias.device if isinstance(module, nn.Linear) else module.weight.device
        quantize_module(module, q.to(device), scale.to(device))


def load_jax_params(net: nn.Module, params: Dict[str, Any]) -> nn.Module:
    """Copy ``params`` (a param tree, ``{"params": tree}`` or int8 serving
    variables ``{"params": tree, "qkern": ...}``) into ``net`` in place
    (dtype and device of the net's parameters kept); returns ``net``."""
    if isinstance(params.get("params"), dict) and set(params) <= {"params", "qkern"}:
        if "qkern" in params:
            _load_qkern(net, params["qkern"])
        params = params["params"]
    own = dict(net.named_parameters())
    seen = set()
    with torch.no_grad():
        for path, value in _walk(params):
            leaf = path[-1]
            arr = np.asarray(value)
            name = ".".join(path)
            if name not in own:         # else a parameter under flax's own name, as it is
                name = ".".join(path[:-1] + (_RENAME.get(leaf, leaf),))
                if name not in own:
                    raise KeyError(f"flax param {'/'.join(path)} has no counterpart ({name}) in the net")
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


def _set(tree: Dict[str, Any], path: str, leaf: str, arr: np.ndarray):
    node = tree
    for k in path.split(".") if path else ():
        node = node.setdefault(k, {})
    node[leaf] = np.ascontiguousarray(arr)


def export_params(net: nn.Module, tensors: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """The flax-shaped tree (nested dicts of fp32 numpy arrays) of the
    net's parameters, or of ``tensors``, a dict from parameter name to a
    tensor of the parameter's shape (``{n: p.grad for n, p in
    net.named_parameters()}``); the inverse of :func:`load_jax_params`. For
    a net with int8 modules and no ``tensors``, the serving variables
    ``{"params": tree, "qkern": {<module>: {"q", "scale"}}}``."""
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
        _set(tree, path, leaf, arr)
    quantized = [(n, m) for n, m in net.named_modules() if is_quantized(m)]
    if tensors is not None or not quantized:
        return tree
    qkern: Dict[str, Any] = {}
    for path, module in quantized:
        _set(qkern, path, "q", module.q.cpu().numpy().T)
        _set(qkern, path, "scale", module.scale.cpu().numpy())
    return {"params": tree, "qkern": qkern}
