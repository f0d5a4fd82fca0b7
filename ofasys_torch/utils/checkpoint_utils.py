"""Checkpoint save/load (counterpart of ofasys_tpu/utils/checkpoint_utils.py).

A checkpoint ``<save_dir>/<name>`` is one ``torch.save`` file of the
training state with every tensor under its flax path, as ofasys_tpu's orbax
tree holds it:

    {"step": int,
     "params": {<flax tree>},                      # utils/jax_params.export_params
     "opt_state": {"count": int, "mu": {<flax tree>}, "nu": {...}},
     "ema_params": {<flax tree>}}                  # with ema.store_ema only

(the optimizer's moments are laid out like the parameters they belong to:
a moment of a parameter's shape is transposed as its parameter is;
Adafactor's factored moments are kept as they are). Beside it,
``<name>.meta.json`` is ofasys_tpu's JSON sidecar (configs, dictionary,
iterator positions, meters). ``checkpoint_last`` and ``checkpoint_best``
are symlinks with copied sidecars; update, epoch and best checkpoints
rotate as in ofasys_tpu.

``async_save``: the state is copied to host memory before
``save_checkpoint`` returns (the caller may update its tensors at once)
and written on a background thread; ``wait_for_async_saves`` joins it.

Sharded checkpoints (a world of several ranks, parallel/): ``<name>`` is a
directory with one ``shard_<rank>.pt`` a rank that wrote pieces (each
piece written once, by the first of its replicas): for every parameter,
optimizer moment and EMA leaf the rank holds, its global shape, the box of
it this rank holds (torch coordinates) and whether the flax leaf is its
transpose. No rank gathers the state: ``load_sharded_state`` fills each
rank's pieces on any other layout from the overlapping pieces (read through
memory maps), and ``load_checkpoint`` of the directory assembles the whole
tree for one process (``OFASys.from_pretrained``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ofasys_torch.utils.jax_params import export_params, stack_layers, unstack_layers

_inflight: Optional[threading.Thread] = None
_inflight_error: List[BaseException] = []


def wait_for_async_saves():
    """Block until the in-flight async checkpoint write has committed;
    re-raise its error, if it failed."""
    global _inflight
    if _inflight is not None:
        _inflight.join()
        _inflight = None
    if _inflight_error:
        err = _inflight_error.pop()
        raise RuntimeError("an async checkpoint write failed") from err


# ------------------------------------------------------------- state trees

def _module_of(net: nn.Module, name: str):
    path = name.rsplit(".", 1)[0] if "." in name else ""
    return net.get_submodule(path) if path else net


def flax_tree(net: nn.Module, tensors: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """The flax-shaped tree of CPU fp32 tensors of the net's parameters, or
    of ``tensors`` named like them (a moment of another shape is kept as it
    is, under its parameter's path)."""
    own = dict(net.named_parameters())
    if tensors is None:
        tree = export_params(net, stacked=False)
    else:
        same = {n: t for n, t in tensors.items() if tuple(t.shape) == tuple(own[n].shape)}
        tree = export_params(net, {n: same.get(n, own[n]) for n in own}, stacked=False) if same else {}
        for n, t in tensors.items():
            if n in same:
                continue
            path, leaf = n.rsplit(".", 1) if "." in n else ("", n)
            node = tree
            for k in path.split(".") if path else ():
                node = node.setdefault(k, {})
            node[_flax_leaf(net, n)] = t.detach().float().cpu().numpy()
    return _to_tensors(stack_layers(tree) if getattr(getattr(net, "cfg", None), "scan_layers", False)
                       else tree)


def _flax_leaf(net: nn.Module, name: str) -> str:
    leaf = name.rsplit(".", 1)[-1]
    module = _module_of(net, name)
    if leaf == "weight" and isinstance(module, nn.Linear):
        return "kernel"
    if leaf == "weight" and isinstance(module, nn.LayerNorm):
        return "scale"
    if leaf == "weight" and isinstance(module, nn.Embedding):
        return "embedding"
    return leaf


def _to_tensors(tree):
    if isinstance(tree, dict):
        return {k: _to_tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def from_flax_tree(net: nn.Module, tree: Dict[str, Any]) -> List[torch.Tensor]:
    """The inverse of :func:`flax_tree`: CPU tensors in the net's parameter
    order (a Linear kernel of its parameter's shape transposed back); the
    tree in either layer layout."""
    tree = unstack_layers(tree)
    out = []
    for name, p in net.named_parameters():
        path = name.rsplit(".", 1)[0] if "." in name else ""
        node = tree
        for k in path.split(".") if path else ():
            node = node[k]
        value = node[_flax_leaf(net, name)]
        t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))
        linear = name.endswith("weight") and isinstance(_module_of(net, name), nn.Linear)
        if linear and t.dim() == 2 and tuple(t.shape) == tuple(p.shape)[::-1]:
            t = t.t()
        out.append(t.contiguous())
    return out


def train_state_dict(net: nn.Module, state, with_optimizer: bool = True) -> Dict[str, Any]:
    """The checkpoint tree of a TrainState (engine/train_step.py) on the host."""
    names = [n for n, _ in net.named_parameters()]
    out: Dict[str, Any] = {"step": int(state.step), "params": flax_tree(net)}
    if with_optimizer:
        opt: Dict[str, Any] = {}
        for k, v in state.opt_state.items():
            opt[k] = flax_tree(net, dict(zip(names, v))) if isinstance(v, list) else v
        out["opt_state"] = opt
    if state.ema_params is not None:
        out["ema_params"] = flax_tree(net, dict(zip(names, state.ema_params)))
    return out


@torch.no_grad()
def load_train_state(net: nn.Module, state, tree: Dict[str, Any], params_only: bool = False):
    """Copy a checkpoint tree into a TrainState in place (the net's own
    parameters, the optimizer state, the EMA and the step), on their
    devices. ``params_only`` restores the parameters and the EMA alone."""
    for p, t in zip(state.params, from_flax_tree(net, tree["params"])):
        p.copy_(t.to(p.dtype))
    if state.ema_params is not None and tree.get("ema_params") is not None:
        for e, t in zip(state.ema_params, from_flax_tree(net, tree["ema_params"])):
            e.copy_(t.to(e.dtype))
    if params_only:
        return state
    state.step = int(tree["step"])
    new = {}
    for k, v in state.opt_state.items():
        saved = tree["opt_state"][k]
        if isinstance(v, list):
            new[k] = [t.to(device=x.device, dtype=x.dtype).reshape(x.shape)
                      for x, t in zip(v, from_flax_tree(net, saved))]
        else:
            new[k] = int(saved) if isinstance(v, int) else saved
    state.opt_state = new
    return state


def _host_copy(tree):
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone() if tree.device.type != "cpu" else tree.detach().clone()
    return tree


# ---------------------------------------------------------------- save/load

def _write(state: Dict[str, Any], path: str):
    tmp = path + ".tmp"
    _remove(tmp)
    torch.save(state, tmp)
    os.replace(tmp, path)


def _write_async(state: Dict[str, Any], path: str):
    try:
        _write(state, path)
    except BaseException as e:  # re-raised by wait_for_async_saves
        _inflight_error.append(e)


def save_checkpoint(
    save_dir: str,
    name: str,
    state: Dict[str, Any],            # a checkpoint tree (train_state_dict)
    meta: Optional[Dict[str, Any]] = None,
    keep_last: int = -1,
    is_best: bool = False,
    async_save: bool = False,
    keep_best: int = -1,            # rotate checkpoint_best_<tag> mirrors
    best_tag: int = 0,
    keep_epochs: int = -1,          # rotate checkpoint_e<N> epoch saves
    mirror_last: bool = True,       # maintain the checkpoint_last mirror
    keep_pattern: int = -1,         # never prune updates divisible by this
):
    global _inflight
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(save_dir), name)
    wait_for_async_saves()   # one in-flight save at a time
    host = _host_copy(state)
    # path may be a symlink left by _mirror (e.g. the final explicit
    # checkpoint_last save after interval saves)
    _remove(path)
    if async_save:
        _inflight = threading.Thread(target=_write_async, args=(host, path), daemon=True)
        _inflight.start()
    else:
        _write(host, path)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)
    last = os.path.join(save_dir, "checkpoint_last")
    if name != "checkpoint_last" and mirror_last:
        _mirror(path, last)
    if is_best:
        _mirror(path, os.path.join(save_dir, "checkpoint_best"))
        if keep_best > 0:
            _mirror(path, os.path.join(save_dir, f"checkpoint_best_{best_tag}"))
            _prune(save_dir, keep_best, pattern=r"^checkpoint_best_(\d+)$")
    # under async_save the just-written checkpoint may not be on disk yet:
    # count it explicitly so rotation keeps exactly N including it
    if keep_last > 0:
        _prune(save_dir, keep_last, extra=name, keep_multiple=keep_pattern)
    if keep_epochs > 0:
        _prune(save_dir, keep_epochs, pattern=r"^checkpoint_e(\d+)$", extra=name)


def _remove(path: str):
    if os.path.islink(path) or os.path.isfile(path):
        os.remove(path)
    elif os.path.isdir(path):
        shutil.rmtree(path)


def _mirror(src: str, dst: str):
    _remove(dst)
    os.symlink(os.path.abspath(src), dst)
    meta = src + ".meta.json"
    if os.path.exists(meta):
        shutil.copy(meta, dst + ".meta.json")


def _prune(save_dir: str, keep: int, pattern: str = r"^checkpoint_(\d+)_(\d+)$",
           extra: Optional[str] = None, keep_multiple: int = -1):
    pat = re.compile(pattern)
    names = set(os.listdir(save_dir))
    if extra is not None:
        names.add(extra)
    cands = []
    for n in names:
        m = pat.match(n)
        if m:
            cands.append((int(m.group(m.lastindex)), n))
    cands.sort(reverse=True)
    if keep_multiple > 0:
        # updates divisible by the pattern survive rotation
        cands = [(t, n) for t, n in cands if t % keep_multiple != 0]
    for _, n in cands[keep:]:
        p = os.path.join(save_dir, n)
        _remove(p)
        if os.path.exists(p + ".meta.json"):
            os.remove(p + ".meta.json")


def _resolve(path: str) -> str:
    path = os.path.abspath(path)
    if os.path.islink(path):
        path = os.readlink(path)
    return path


def load_checkpoint(path: str):
    """Returns (state, meta): the checkpoint tree (CPU tensors) and its
    sidecar (None when absent). A sharded checkpoint is assembled whole."""
    wait_for_async_saves()   # same-process save-then-load sees committed data
    path = _resolve(path)
    if os.path.isdir(path):
        return assemble_sharded(path), read_meta(path)
    state = torch.load(path, map_location="cpu", weights_only=True)
    return state, read_meta(path)


def load_ema_from_checkpoint(path: str):
    """The EMA shadow weights of a checkpoint as a params tree, and its
    sidecar. Raises if the run trained without ``ema.store_ema``."""
    state, meta = load_checkpoint(path)
    ema = state.get("ema_params") if isinstance(state, dict) else None
    if ema is None:
        raise ValueError(f"checkpoint {path} has no EMA shadow (train with ema.store_ema=True)")
    return ema, meta


def latest_checkpoint(save_dir: str) -> Optional[str]:
    last = os.path.join(save_dir, "checkpoint_last")
    return last if os.path.exists(last) else None


def read_meta(path: str) -> Optional[Dict[str, Any]]:
    """Read only the JSON sidecar."""
    meta_path = _resolve(path) + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return None


# ------------------------------------------------------- checkpoint surgery

def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def _like(arr: np.ndarray, leaf):
    return torch.from_numpy(arr) if isinstance(leaf, torch.Tensor) else arr


def remap_vocab_rows(state: Any, saved_symbols: List[str], new_dict, seed: int = 0) -> Any:
    """Vocab remap on resume: when the dictionary changed between save and
    resume (a new task grew the vocab), re-scatter every
    ``embed_tokens/embedding``-shaped leaf from the old row order to the
    new. Old tokens keep their rows bit for bit; new tokens get
    normal(0, E^-0.5) rows in params/EMA and zero rows in optimizer
    moments; dropped tokens are discarded. numpy's draws, as ofasys_tpu's."""
    new_V = len(new_dict)
    old_rows, new_rows = [], []
    for old_idx, sym in enumerate(saved_symbols):
        ni = new_dict.indices.get(sym)
        if ni is not None:
            old_rows.append(old_idx)
            new_rows.append(ni)
    old_rows = np.asarray(old_rows, np.int64)
    new_rows = np.asarray(new_rows, np.int64)

    def remap(path, leaf):
        p = "/".join(path)
        if not p.endswith("embed_tokens/embedding") or getattr(leaf, "ndim", 0) != 2:
            return leaf
        if leaf.shape[0] == new_V:
            return leaf
        E = leaf.shape[1]
        arr = np.asarray(leaf)
        if "params" in path or "ema_params" in path:
            rng = np.random.default_rng(seed)
            out = (rng.standard_normal((new_V, E)) * E ** -0.5).astype(arr.dtype)
        else:  # optimizer moments: fresh rows start at zero
            out = np.zeros((new_V, E), arr.dtype)
        out[new_rows] = arr[old_rows]
        return _like(out, leaf)

    return _map_with_path(remap, state)


def resize_vocab_rows(state: Any, V: int) -> Any:
    """Zero-filled copy of ``state`` with every embed_tokens/embedding-shaped
    leaf resized to V rows."""

    def resize(path, leaf):
        if not "/".join(path).endswith("embed_tokens/embedding") or getattr(leaf, "ndim", 0) != 2:
            return leaf
        return _like(np.zeros((V, leaf.shape[1]), np.asarray(leaf).dtype), leaf)

    return _map_with_path(resize, state)


def prune_state_dict(state: Any, keep: Optional[List[str]] = None,
                     drop: Optional[List[str]] = None) -> Any:
    """Drop param subtrees by path substring (``drop``), or keep only the
    leaves whose path holds one of ``keep``; empty subtrees go too."""

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                p = f"{prefix}/{k}" if prefix else str(k)
                if drop and any(d in p for d in drop):
                    continue
                if keep and not isinstance(v, dict) and not any(s in p for s in keep):
                    continue
                w = walk(v, p)
                if w is not None and (not isinstance(w, dict) or w):
                    out[k] = w
            return out
        return tree

    return walk(state)


def upgrade_state_meta(meta: Dict[str, Any]) -> Dict[str, Any]:
    """Normalize older sidecar layouts in place so resume code only sees the
    current schema."""
    if meta is None:
        return meta
    # v0 sidecars stored the dictionary under "dictionary"
    if "global_dict" not in meta and "dictionary" in meta:
        meta["global_dict"] = meta.pop("dictionary")
    # iterator states were once a flat list ordered like tasks
    its = meta.get("iterator_states")
    if isinstance(its, list):
        meta["iterator_states"] = {str(i): s for i, s in enumerate(its)}
    return meta


# ------------------------------------------------------------ sharded state

def _shard_files(path: str) -> List[str]:
    return sorted(os.path.join(path, f) for f in os.listdir(path)
                  if f.startswith("shard_") and f.endswith(".pt"))


def sharded_pieces(state, layout, with_optimizer: bool = True) -> Dict[str, Any]:
    """This rank's pieces of a TrainState over ``layout``
    (parallel/sharding.Layout): {key: {"shape", "box", "transposed", "data"}}
    with key ``params/<flax path>``, ``opt_state/<name>/<flax path>`` or
    ``ema_params/<flax path>``, and the scalars (step, optimizer counters)
    under ``_scalars`` on the first rank."""
    out: Dict[str, Any] = {}

    def put(key, leaf, t, sliced):
        if not layout.writer(leaf, sliced):
            return
        local = [b.stop - b.start for b in leaf.box]
        if sliced and leaf.opt_dim is not None:
            local[leaf.opt_dim] //= layout.mesh.size(leaf.opt_axis)
        if tuple(t.shape) != tuple(local):
            shape, box = tuple(t.shape), tuple(slice(0, d) for d in t.shape)   # a factored moment
        else:
            shape, box = leaf.shape, layout.box_of(leaf, sliced)
        out[key] = {"shape": tuple(shape), "box": [(b.start, b.stop) for b in box],
                    "transposed": leaf.transposed and len(shape) == 2,
                    "data": t.detach().cpu().clone()}

    for i, leaf in enumerate(layout.leaves):
        put(f"params/{leaf.path}", leaf, state.params[i], leaf.held)
        if state.ema_params is not None:
            put(f"ema_params/{leaf.path}", leaf, state.ema_params[i], leaf.held)
        if with_optimizer:
            for k, v in state.opt_state.items():
                if isinstance(v, list):
                    put(f"opt_state/{k}/{leaf.path}", leaf, v[i], True)
    if layout.mesh.rank == 0:
        out["_scalars"] = {"step": int(state.step),
                           "opt_state": {k: v for k, v in state.opt_state.items() if not isinstance(v, list)}}
    return out


def save_sharded(save_dir: str, name: str, pieces: Dict[str, Any], rank: int,
                 meta: Optional[Dict[str, Any]] = None, barrier=None, mirror_last: bool = True):
    """Write this rank's ``pieces`` under ``<save_dir>/<name>/``; the first
    rank writes the sidecar and the ``checkpoint_last`` mirror after every
    rank has written (``barrier``)."""
    path = os.path.join(os.path.abspath(save_dir), name)
    if rank == 0 and os.path.exists(path) and not os.path.isdir(path):
        _remove(path)
    if barrier is not None:
        barrier()
    os.makedirs(path, exist_ok=True)
    if pieces:
        _write(pieces, os.path.join(path, f"shard_{rank:05d}.pt"))
    if barrier is not None:
        barrier()
    if rank == 0:
        if meta is not None:
            with open(path + ".meta.json", "w") as f:
                json.dump(meta, f)
        if name != "checkpoint_last" and mirror_last:
            _mirror(path, os.path.join(save_dir, "checkpoint_last"))


def _to_flax(t: torch.Tensor, transposed: bool) -> torch.Tensor:
    return t.t().contiguous() if transposed else t


def assemble_sharded(path: str) -> Dict[str, Any]:
    """The whole checkpoint tree of a sharded checkpoint (loop layout)."""
    full: Dict[str, torch.Tensor] = {}
    transposed: Dict[str, bool] = {}
    scalars: Dict[str, Any] = {}
    for f in _shard_files(path):
        shard = torch.load(f, map_location="cpu", weights_only=True, mmap=True)
        scalars.update(shard.pop("_scalars", {}))
        for key, piece in shard.items():
            if key not in full:
                full[key] = torch.zeros(piece["shape"], dtype=piece["data"].dtype)
                transposed[key] = piece["transposed"]
            full[key][tuple(slice(a, b) for a, b in piece["box"])] = piece["data"]
    tree: Dict[str, Any] = {"step": scalars.get("step", 0)}
    opt = dict(scalars.get("opt_state", {}))
    for key, t in full.items():
        parts = key.split("/")
        if parts[0] == "opt_state":
            node = opt.setdefault(parts[1], {})
            rest = parts[2:]
        else:
            node = tree.setdefault(parts[0], {})
            rest = parts[1:]
        for k in rest[:-1]:
            node = node.setdefault(k, {})
        node[rest[-1]] = _to_flax(t, transposed[key])
    if opt:
        tree["opt_state"] = opt
    return tree


def _get(tree: Dict[str, Any], path: str):
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


@torch.no_grad()
def load_sharded_state(path: str, state, layout, params_only: bool = False):
    """Fill this rank's pieces of a TrainState (over ``layout``) from a
    checkpoint of any layout: a sharded directory (only the overlapping
    parts of its pieces are read) or a one-file checkpoint."""
    path = _resolve(path)
    wanted: List[tuple] = []   # (key, leaf, target tensor, sliced)
    for i, leaf in enumerate(layout.leaves):
        wanted.append((f"params/{leaf.path}", leaf, state.params[i], leaf.held))
        if state.ema_params is not None:
            wanted.append((f"ema_params/{leaf.path}", leaf, state.ema_params[i], leaf.held))
        if not params_only:
            for k, v in state.opt_state.items():
                if isinstance(v, list):
                    wanted.append((f"opt_state/{k}/{leaf.path}", leaf, v[i], True))
    if os.path.isdir(path):
        filled = set()
        scalars = {}
        for f in _shard_files(path):
            shard = torch.load(f, map_location="cpu", weights_only=True, mmap=True)
            scalars.update(shard.pop("_scalars", {}))
            for key, leaf, target, sliced in wanted:
                piece = shard.get(key)
                if piece is None:
                    continue
                if tuple(piece["shape"]) != tuple(leaf.shape) and sliced:
                    target.copy_(piece["data"].to(target.dtype))       # a factored moment
                    filled.add(key)
                    continue
                box = layout.box_of(leaf, sliced)
                src, dst = [], []
                for (a, b), want in zip(piece["box"], box):
                    lo, hi = max(a, want.start), min(b, want.stop)
                    if lo >= hi:
                        break
                    src.append(slice(lo - a, hi - a))
                    dst.append(slice(lo - want.start, hi - want.start))
                else:
                    target[tuple(dst)] = piece["data"][tuple(src)].to(target.dtype)
                    filled.add(key)
        if ({"params/" + lf.path for lf in layout.leaves} - filled):
            raise KeyError(f"{path}: parameters missing from the sharded checkpoint")
        if not params_only:
            state.step = int(scalars.get("step", 0))
            for k, v in scalars.get("opt_state", {}).items():
                state.opt_state[k] = v
        return state
    tree, _ = load_checkpoint(path)
    for part in ("params", "ema_params", "opt_state"):
        if isinstance(tree.get(part), dict):
            tree[part] = ({k: unstack_layers(v) if isinstance(v, dict) else v for k, v in tree[part].items()}
                          if part == "opt_state" else unstack_layers(tree[part]))
    for key, leaf, target, sliced in wanted:
        parts = key.split("/")
        try:
            t = _get(tree, "/".join(parts))
        except (KeyError, TypeError):
            if parts[0] == "params":
                raise
            continue
        t = torch.as_tensor(t)
        if leaf.transposed and t.dim() == 2 and tuple(t.shape) == tuple(leaf.shape)[::-1]:
            t = t.t()
        if tuple(t.shape) == tuple(leaf.shape):
            t = t[layout.box_of(leaf, sliced)]
        target.copy_(t.to(target.dtype))
    if not params_only:
        state.step = int(tree["step"])
        for k, v in tree.get("opt_state", {}).items():
            if not isinstance(v, dict):
                state.opt_state[k] = int(v) if isinstance(state.opt_state.get(k), int) else v
    return state
