"""Non-finite detection and localization (counterpart of
ofasys_tpu/engine/nan_detector.py).

  * check_tree(tree)       — every non-finite leaf by its flax path (run on
                             parameters or gradients after a bad loss)
  * debug_forward(model)   — reruns a forward with a finiteness check on
                             every module's output (forward hooks), in the
                             order the modules finish
  * debug_nans()           — ``torch.autograd.detect_anomaly`` for the scope,
                             standing in for ofasys_tpu's ``jax_debug_nans``:
                             a backward that makes a NaN raises at its op
"""

from __future__ import annotations

import contextlib
import logging
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ofasys_torch.utils.jax_params import flax_path
from ofasys_torch.utils.pytree import slots_to_device

logger = logging.getLogger("ofasys_torch.nan")


def _leaves(tree: Any, net: Optional[nn.Module]) -> Iterator[Tuple[str, Any]]:
    """(flax path, array) of every leaf: with ``net``, ``tree`` maps the
    net's parameter names to tensors (its parameters or gradients);
    without, it is a nested dict (a flax tree) whose keys are joined by
    '/'."""
    if net is not None:
        for name, t in tree.items():
            yield flax_path(net, name), t
        return

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from walk(v, path + (str(k),))
            else:
                yield "/".join(path + (str(k),)), v

    yield from walk(tree, ())


def check_tree(tree: Any, name: str = "tree", net: Optional[nn.Module] = None) -> List[str]:
    """Return (and log) the flax paths of the non-finite leaves of a flax
    tree, or of ``{parameter name: tensor}`` of ``net`` (``dict(
    net.named_parameters())``, or the gradients), in the order
    ofasys_tpu's ``check_tree`` gives them for the same tree (sorted keys
    at every level)."""
    bad: List[Tuple[Tuple[str, ...], str]] = []
    for path, leaf in _leaves(tree, net):
        if leaf is None:
            continue
        if isinstance(leaf, torch.Tensor):
            if not leaf.is_floating_point():
                continue
            arr = leaf.detach().float().cpu().numpy()
        else:
            arr = np.asarray(leaf)
            if arr.dtype.kind != "f":
                continue
        if not np.isfinite(arr).all():
            bad.append((tuple(path.split("/")), path))
            logger.error("%s: non-finite at %s (nan=%d inf=%d shape=%s)", name, path,
                         int(np.isnan(arr).sum()), int(np.isinf(arr).sum()), arr.shape)
    if not bad:
        logger.info("%s: all finite", name)
    return [p for _, p in sorted(bad)]


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Anomaly detection for the scope: a backward op that returns NaN
    raises, with the forward's traceback."""
    with torch.autograd.detect_anomaly(check_nan=True) if enable else contextlib.nullcontext():
        yield


def _outputs(out) -> Iterator[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (list, tuple)):
        for o in out:
            yield from _outputs(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _outputs(o)
    elif hasattr(out, "__dataclass_fields__"):
        for k in out.__dataclass_fields__:
            yield from _outputs(getattr(out, k))


@torch.no_grad()
def debug_forward(model, slots, **kwargs) -> List[str]:
    """Run ``model.net(slots, **kwargs)`` (the slots moved to the net's
    device) with a finiteness check on every
    module's floating outputs; returns the paths ('/'-joined module names)
    of the modules whose output is non-finite, in the order they finished,
    so the first is the innermost module where a non-finite value
    appeared."""
    net = model.net if hasattr(model, "net") else model
    slots = slots_to_device(slots, next(net.parameters()).device)
    bad: List[str] = []
    handles = []

    def hook(path):
        def fn(_module, _inputs, out):
            for t in _outputs(out):
                if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                    bad.append(path)
                    return
        return fn

    for name, module in net.named_modules():
        if name:
            handles.append(module.register_forward_hook(hook(name.replace(".", "/"))))
    try:
        net(slots, **kwargs)
    finally:
        for h in handles:
            h.remove()
    if bad:
        logger.error("first non-finite intermediates: %s", bad[:5])
    return bad
