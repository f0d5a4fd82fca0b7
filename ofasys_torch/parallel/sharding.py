"""Parameter placement over the mesh (counterpart of
ofasys_tpu/parallel/sharding.py).

ofasys_tpu places every leaf by the first regex of ``DEFAULT_RULES`` that
matches its flax path and lets GSPMD partition the program. The port keeps
the rule table and its rank trimming and "does not divide -> replicated"
rule (:func:`tree_shardings`, :func:`shard_tree`), and runs the placement
itself:

  * :func:`shard_model` cuts the net's modules to this rank's shards:
    tensor parallelism in Megatron's layout (q/k/v, fc1 and the experts'
    fc1 column-parallel over the heads and FFN columns, so the attention
    kernels run on the local heads; out_proj and fc2 row-parallel, summed
    over the tensor group; the FFN's mid LayerNorm over its split
    columns; the token embedding vocab-parallel, as the rules place it,
    where its rows divide), and the MoE experts over the expert axis. The
    position projections and the relative tables stay whole on every rank
    (their bias is cut to the local heads where it is read).
  * :class:`Layout` holds what the optimizer owns on this rank: the
    parameters of its pipeline stage, and under ``fsdp`` (or ``zero1`` over
    ``data``) a 1/n slice of each leaf along the dimension the rule table
    shards over ``fsdp`` (dim 0 of the flax leaf for zero1), where it
    divides. The optimizer steps the slices and their moments.
  * fsdp: each rank holds only its slices of those parameters. A layer of
    the stacks gathers its own when it runs, forward and recompute alike
    (:class:`_GatherSlice`, a pre- and a post-hook on the layer), and lets
    them go when it returns; the other sliced parameters (embeddings,
    adaptors, the stacks' final norms) are gathered for the length of a
    step or an evaluation (:meth:`Layout.unsharded`). The backward of a
    gather reduce-scatters the piece's gradient to the slice, summed over
    the fsdp group. What a layer's backward reads of its parameters is
    kept as its activations are: the compute-dtype copies that its
    products saved, none under remat.
  * zero1: every rank holds the whole parameters; their gradients are
    summed over ``data``, the optimizer steps its slices and the slices are
    all-gathered back into the parameters after each update.
"""

from __future__ import annotations

import contextlib
import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ofasys_torch.parallel import distributed as PD
from ofasys_torch.parallel.mesh import MESH_AXES, Mesh

Spec = Tuple[Any, ...]

# (path regex, spec). First match wins; default = replicated.
DEFAULT_RULES: List[Tuple[str, Spec]] = [
    # attention projections: (E_in, E_out)
    (r"(q_proj|k_proj|v_proj)/kernel$", ("fsdp", "tensor")),
    (r"(q_proj|k_proj|v_proj)/bias$", ("tensor",)),
    (r"out_proj/kernel$", ("tensor", "fsdp")),
    (r"out_proj/bias$", ()),
    # FFN
    (r"(fc1|experts_fc1_\d+)/kernel$", ("fsdp", "tensor")),
    (r"(fc1|experts_fc1_\d+)/bias$", ("tensor",)),
    (r"(fc2|experts_fc2_\d+)/kernel$", ("tensor", "fsdp")),
    (r"(fc2|experts_fc2_\d+)/bias$", ()),
    # shared token embedding (V, E)
    (r"embed_tokens/embedding$", ("tensor", "fsdp")),
    # learned positions / type embeddings: small, shard E over fsdp only
    (r"embed_positions/embedding$", (None, "fsdp")),
    (r"embed_image_positions/embedding$", (None, "fsdp")),
    # abs-pos bias projections behave like attention projections
    (r"(pos_q_linear|pos_k_linear|cross_pos_q_linear|cross_pos_k_linear)/kernel$", ("fsdp", "tensor")),
    (r"(pos_q_linear|pos_k_linear|cross_pos_q_linear|cross_pos_k_linear)/bias$", ("tensor",)),
    # relative-position tables (n_tables, buckets, heads): heads on tensor
    (r"rel_pos_table$", (None, None, "tensor")),
    # per-head scaling
    (r"c_attn$", ("tensor",)),
    # MoE expert weights (E, D, H)/(E, H, D): experts over 'expert'
    (r"moe_ffn/moe_w[12]$", ("expert",)),
    # int8 serving kernels: <name>/q (in, out) as the kernel, <name>/scale
    # per output channel
    (r"(q_proj|k_proj|v_proj|fc1|experts_fc1_\d+|pos_q_linear|pos_k_linear|cross_pos_q_linear|cross_pos_k_linear)/q$",
     ("fsdp", "tensor")),
    (r"(q_proj|k_proj|v_proj|fc1|experts_fc1_\d+|pos_q_linear|pos_k_linear|cross_pos_q_linear|cross_pos_k_linear)/scale$",
     ("tensor",)),
    (r"(out_proj|fc2|experts_fc2_\d+)/q$", ("tensor", "fsdp")),
    (r"(out_proj|fc2|experts_fc2_\d+)/scale$", ("fsdp",)),
    # int8 tied-logits table is stored pre-transposed (E, V)
    (r"embed_tokens/q$", ("fsdp", "tensor")),
    (r"embed_tokens/scale$", ("tensor",)),
    # layernorms, w_resid, type embeddings: replicated
    (r".*", ()),
]


def spec_for_path(path: str, rules=None) -> Spec:
    for pattern, spec in rules or DEFAULT_RULES:
        if re.search(pattern, path):
            return tuple(spec)
    return ()


def _fit_spec(spec: Spec, ndim: int) -> Spec:
    """Trim/pad a spec to the leaf's rank (scalars -> fully replicated)."""
    entries = list(spec)[:ndim]
    return tuple(entries + [None] * (ndim - len(entries)))


def leaf_spec(path: str, shape: Sequence[int], mesh: Mesh, rules=None) -> Spec:
    """The placement of one leaf of the flax tree: the rule's spec, shifted
    right by the pipe axis under ``layers_scan``, fitted to the leaf's rank,
    with every axis whose size does not divide its dimension dropped."""
    ndim = len(shape)
    spec = spec_for_path(path, rules)
    if "layers_scan" in path and ndim > 0:
        spec = ("pipe",) + tuple(spec)
    spec = _fit_spec(spec, ndim)
    out = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n = math.prod(mesh.size(a) for a in axes)
        out.append(ax if dim % n == 0 else None)
    return tuple(out)


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def _set(tree, path, value):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def tree_shardings(tree: Dict[str, Any], mesh: Mesh, rules=None) -> Dict[str, Any]:
    """The spec of every leaf of a flax-shaped tree (nested dicts of arrays)."""
    out: Dict[str, Any] = {}
    for path, leaf in _walk(tree):
        _set(out, path, leaf_spec("/".join(path), tuple(getattr(leaf, "shape", ())), mesh, rules))
    return out


def local_box(shape: Sequence[int], spec: Spec, mesh: Mesh) -> Tuple[slice, ...]:
    """This rank's slice of a leaf placed by ``spec``."""
    box = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            box.append(slice(0, dim))
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n, i = 1, 0
        for a in axes:
            n, i = n * mesh.size(a), i * mesh.size(a) + mesh.index(a)
        per = dim // n
        box.append(slice(i * per, (i + 1) * per))
    return tuple(box)


def shard_tree(tree: Dict[str, Any], mesh: Mesh, rules=None) -> Dict[str, Any]:
    """This rank's pieces of every leaf of a host tree, by the rule table."""
    out: Dict[str, Any] = {}
    for path, leaf in _walk(tree):
        spec = leaf_spec("/".join(path), tuple(leaf.shape), mesh, rules)
        _set(out, path, leaf[local_box(leaf.shape, spec, mesh)])
    return out


# ------------------------------------------------------------------ the net

def set_mesh(net: nn.Module, mesh: Optional[Mesh]):
    """Give every module of ``net`` that reads a mesh (attention, MoE, the
    stacks) this one."""
    from ofasys_torch.model.transformer import (MoEFeedForward, MultiheadAttention, TransformerDecoder,
                                                TransformerEncoder)

    for m in net.modules():
        if isinstance(m, (MultiheadAttention, MoEFeedForward, TransformerEncoder, TransformerDecoder)):
            m.mesh = mesh
    net.mesh = mesh


def _cut(module: nn.Module, name: str, dim: int, i: int, n: int):
    """Replace the parameter or buffer ``name`` by its i-th of n slices along ``dim``."""
    t = getattr(module, name)
    per = t.shape[dim] // n
    piece = t.detach().narrow(dim, i * per, per).clone()
    if isinstance(t, nn.Parameter):
        setattr(module, name, nn.Parameter(piece, requires_grad=t.requires_grad))
    else:
        module.register_buffer(name, piece)


def _record(shards: Dict[str, Tuple[int, str, int]], prefix: str, module: nn.Module, name: str,
            dim: int, axis: str):
    shards[f"{prefix}.{name}" if prefix else name] = (dim, axis, getattr(module, name).shape[dim])


def shard_model(net: nn.Module, mesh: Mesh) -> Dict[str, Tuple[int, str, int]]:
    """Cut ``net``'s modules to this rank's tensor- and expert-parallel
    shards in place and set the mesh on it; returns, for every parameter or
    buffer that was cut, (torch dim, mesh axis, global size of that dim),
    also kept as ``net.shards``."""
    from ofasys_torch.model.transformer import Embed, FeedForward, MoEFeedForward, MultiheadAttention
    from ofasys_torch.ops.quant import is_quantized

    set_mesh(net, mesh)
    shards: Dict[str, Tuple[int, str, int]] = {}
    tp, ti = mesh.size("tensor"), mesh.index("tensor")
    ep, ei = mesh.size("expert"), mesh.index("expert")
    g = mesh.group("tensor")
    for prefix, m in list(net.named_modules()):
        if tp > 1 and isinstance(m, MultiheadAttention):
            H = m.num_heads
            if H % tp:
                raise ValueError(f"{prefix}: {H} heads do not divide over tensor = {tp}")
            for proj in ("q_proj", "k_proj", "v_proj"):
                lin = getattr(m, proj)
                for leaf in (("q", "scale") if is_quantized(lin) else ("weight",)) + ("bias",):
                    _record(shards, f"{prefix}.{proj}", lin, leaf, 0, "tensor")
                    _cut(lin, leaf, 0, ti, tp)
            lin = m.out_proj
            leaf = "q" if is_quantized(lin) else "weight"
            _record(shards, f"{prefix}.out_proj", lin, leaf, 1, "tensor")
            _cut(lin, leaf, 1, ti, tp)
            lin.row_group = g
            if hasattr(m, "c_attn"):
                _record(shards, prefix, m, "c_attn", 0, "tensor")
                _cut(m, "c_attn", 0, ti, tp)
            m.num_heads = H // tp
            m.head_offset = ti * (H // tp)
            m.tp_group = g
        elif tp > 1 and isinstance(m, FeedForward):
            for fc1, fc2 in [(n, n.replace("fc1", "fc2")) for n, _ in m.named_children() if "fc1" in n]:
                a, b, ln = getattr(m, fc1), getattr(m, fc2), getattr(m, fc2 + "_ln")
                if a.out_features % tp:
                    raise ValueError(f"{prefix}.{fc1}: {a.out_features} columns do not divide over "
                                     f"tensor = {tp}")
                for leaf in (("q", "scale") if is_quantized(a) else ("weight",)) + ("bias",):
                    _record(shards, f"{prefix}.{fc1}", a, leaf, 0, "tensor")
                    _cut(a, leaf, 0, ti, tp)
                leaf = "q" if is_quantized(b) else "weight"
                _record(shards, f"{prefix}.{fc2}", b, leaf, 1, "tensor")
                _cut(b, leaf, 1, ti, tp)
                b.row_group = g
                if ln is not None:
                    for leaf in ("weight", "bias"):
                        _record(shards, f"{prefix}.{fc2}_ln", ln, leaf, 0, "tensor")
                        _cut(ln, leaf, 0, ti, tp)
            m.tp_group = g
        elif tp > 1 and isinstance(m, Embed) and m.weight.shape[0] % tp == 0:
            # vocab-parallel: this rank's rows of the table (and of its int8
            # attend table); a vocabulary that does not divide stays whole
            V = m.weight.shape[0]
            for leaf in ("weight",) + (("q", "scale") if is_quantized(m) else ()):
                _record(shards, prefix, m, leaf, 0, "tensor")
                _cut(m, leaf, 0, ti, tp)
            m.tp_group = g
            m.vocab_start = ti * (V // tp)
        elif ep > 1 and isinstance(m, MoEFeedForward):
            E = m.cfg.moe_experts
            if E % ep:
                raise ValueError(f"{prefix}: {E} experts do not divide over expert = {ep}")
            for leaf in ("moe_w1", "moe_w2"):
                _record(shards, prefix, m, leaf, 0, "expert")
                _cut(m, leaf, 0, ei, ep)
            m.local_experts = True
    net.shards = shards
    return shards


# ------------------------------------------------------------ the optimizer

class Leaf:
    """One parameter as this rank holds it: its name and flax path, its
    global shape and this rank's box (torch coordinates), ``shards`` the
    number of distinct pieces of it over the mesh, and the optimizer's
    slice of the local piece (``opt_axis`` and ``opt_dim``, None when the
    optimizer steps the whole piece)."""

    def __init__(self, name: str, path: str, transposed: bool, shape, box, shards: int,
                 model_axes: Tuple[str, ...]):
        self.name, self.path, self.transposed = name, path, transposed
        self.shape, self.box, self.shards = tuple(shape), tuple(box), shards
        self.model_axes = model_axes
        self.opt_axis: Optional[str] = None
        self.opt_dim: Optional[int] = None

    @property
    def held(self) -> bool:
        """Whether the parameter itself holds only the optimizer's slice (fsdp)."""
        return self.opt_axis == "fsdp"


class Layout:
    """What the optimizer of this rank owns (module docstring): ``leaves``
    (one :class:`Leaf` a parameter of this stage, in the net's order) and
    ``params`` (those parameters)."""

    def __init__(self, net: nn.Module, mesh: Mesh, zero1: bool = False, rules=None):
        from ofasys_torch.parallel.pipeline import stage_params
        from ofasys_torch.utils.jax_params import _flax_leaf

        self.net, self.mesh = net, mesh
        shards = getattr(net, "shards", {})
        names = [n for n, _ in net.named_parameters()]
        cfg = getattr(net, "cfg", None)
        own = [True] * len(names)
        pipe = mesh.size("pipe") > 1 and cfg is not None and cfg.pipeline_stages > 1
        if pipe:
            enc = stage_params(names, cfg.encoder.layers, "encoder.", mesh)
            dec = stage_params(names, cfg.decoder.layers, "decoder.", mesh)
            own = [a and b for a, b in zip(enc, dec)]
        self.opt_axis = "fsdp" if mesh.size("fsdp") > 1 else ("data" if zero1 and mesh.size("data") > 1 else None)
        params = dict(net.named_parameters())
        self.leaves: List[Leaf] = []
        self.params: List[nn.Parameter] = []
        # fsdp: the held parameters outside the layers, (module, name, dim, group)
        self._root: List[Tuple[nn.Module, str, int, Any]] = []
        for name, keep in zip(names, own):
            if not keep:
                continue
            p = params[name]
            module_path, flax_leaf = _flax_leaf(net, name)
            path = "/".join(module_path.split(".") + [flax_leaf]) if module_path else flax_leaf
            transposed = flax_leaf == "kernel" and p.dim() == 2
            shape, box = list(p.shape), [slice(0, d) for d in p.shape]
            n_shards, axes = 1, []
            if name in shards:
                dim, axis, size = shards[name]
                n = mesh.size(axis)
                shape[dim] = size
                per = size // n
                box[dim] = slice(mesh.index(axis) * per, (mesh.index(axis) + 1) * per)
                n_shards *= n
                axes.append(axis)
            if pipe and (name.startswith("encoder.layers_") or name.startswith("decoder.layers_")):
                n_shards *= mesh.size("pipe")
                axes.append("pipe")
            leaf = Leaf(name, path, transposed, shape, box, n_shards, tuple(axes))
            if self.opt_axis is not None:
                flax_shape = shape[::-1] if transposed else shape
                if self.opt_axis == "fsdp":
                    spec = _fit_spec(spec_for_path(path, rules), len(flax_shape))
                    fdims = [d for d, ax in enumerate(spec)
                             if ax == "fsdp" or (isinstance(ax, tuple) and "fsdp" in ax)]
                else:
                    fdims = [0] if flax_shape else []
                for fd in fdims:
                    td = (len(shape) - 1 - fd) if transposed else fd
                    if p.shape[td] % mesh.size(self.opt_axis) == 0:
                        leaf.opt_axis, leaf.opt_dim = self.opt_axis, td
                        leaf.shards *= mesh.size(self.opt_axis)
                        break
            self.leaves.append(leaf)
            self.params.append(p)
        if any(lf.held for lf in self.leaves):
            self._hold_slices()

    def _hold_slices(self):
        """fsdp: cut each sliced parameter to its slice and hook the layers
        that gather theirs (module docstring)."""
        from ofasys_torch.model.transformer import TransformerDecoderLayer, TransformerEncoderLayer

        net, group = self.net, self.mesh.group("fsdp")
        if getattr(net, "fsdp_held", None):
            raise ValueError("the net's parameters are already cut to fsdp slices")
        held = {lf.name: lf for lf in self.leaves if lf.held}
        by_id = {id(p): lf.name for lf, p in zip(self.leaves, self.params) if lf.held}
        # every module that holds a sliced parameter (a shared one has several)
        owners: Dict[str, List[Tuple[nn.Module, str]]] = {}
        for mod in net.modules():
            for pname, p in mod._parameters.items():
                if id(p) in by_id:
                    owners.setdefault(by_id[id(p)], []).append((mod, pname))
        with torch.no_grad():
            for lf, p in zip(self.leaves, self.params):
                if lf.held:
                    p.data = self.opt_slice(lf, p.data).clone()
        net.fsdp_held = {name: lf.opt_dim for name, lf in held.items()}
        units = [(n + ".", m) for n, m in net.named_modules()
                 if isinstance(m, (TransformerEncoderLayer, TransformerDecoderLayer))]
        per_unit: Dict[int, Tuple[nn.Module, list]] = {}
        for name, lf in held.items():
            entries = [(mod, pname, lf.opt_dim, group) for mod, pname in owners[name]]
            unit = next((m for prefix, m in units if name.startswith(prefix)), None)
            if unit is None:
                self._root += entries
            else:
                per_unit.setdefault(id(unit), (unit, []))[1].extend(entries)
        for unit, entries in per_unit.values():
            stack: List[list] = []
            unit.register_forward_pre_hook(lambda m, args, e=entries, st=stack: st.append(_swap_in(e)))
            unit.register_forward_hook(lambda m, args, out, st=stack: _swap_out(st.pop()), always_call=True)

    @contextlib.contextmanager
    def unsharded(self):
        """fsdp: the whole local pieces of the sliced parameters outside the
        layers, for the length of a gradient step or an evaluation (the
        layers gather theirs as they run). A no-op without fsdp."""
        swapped = _swap_in(self._root)
        try:
            yield
        finally:
            _swap_out(swapped)

    def param_bytes(self) -> int:
        """The bytes of the parameters this rank holds (its slices under fsdp)."""
        return sum(p.numel() * p.element_size() for p in self.net.parameters())

    @property
    def data_shard(self) -> int:
        """This rank's index over the batch axes (data x fsdp)."""
        return self.mesh.index("data") * self.mesh.size("fsdp") + self.mesh.index("fsdp")

    def opt_slice(self, leaf: Leaf, t: torch.Tensor) -> torch.Tensor:
        """The optimizer's slice of the local piece ``t`` (a view)."""
        if leaf.opt_dim is None:
            return t
        n, i = self.mesh.size(leaf.opt_axis), self.mesh.index(leaf.opt_axis)
        per = t.shape[leaf.opt_dim] // n
        return t.narrow(leaf.opt_dim, i * per, per)

    def views(self, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """What the optimizer steps of each parameter: its slice (the
        parameter itself where it holds only that)."""
        return [p if lf.held else self.opt_slice(lf, p) for lf, p in zip(self.leaves, params)]

    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Sum the gradients of this rank's rows over data x fsdp; the
        optimizer's slice of each sliced leaf (a held leaf's gradient comes
        out of the backward as its slice, already summed over fsdp)."""
        mesh = self.mesh
        gd, gf = mesh.group("data"), mesh.group("fsdp")
        if gd is not None and grads:
            flat = torch._utils._flatten_dense_tensors([g.contiguous() for g in grads])
            PD.all_reduce(flat, gd)
            grads = list(torch._utils._unflatten_dense_tensors(flat, grads))
        out = []
        for lf, g in zip(self.leaves, grads):
            if lf.held:
                out.append(g)
                continue
            if gf is not None:
                g = PD.all_reduce(g.contiguous(), gf)
            out.append(self.opt_slice(lf, g).contiguous())
        return out

    def reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """A per-rank count (sample size, logged sums) summed over data x fsdp."""
        t = torch.as_tensor(t, device=self.mesh.device)
        t = t.clone() if t.dtype.is_floating_point else t.to(torch.float32)
        for ax in ("data", "fsdp"):
            PD.all_reduce(t, self.mesh.group(ax))
        return t

    def global_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """sqrt of the sum of squares over every distinct piece of the
        gradient: each rank weighs its pieces by shards / world, and one
        all-reduce over the world sums them."""
        world = self.mesh.world
        sq = torch.zeros((), dtype=torch.float32, device=self.mesh.device)
        for lf, g in zip(self.leaves, grads):
            gf = g.float()
            sq = sq + torch.sum(gf * gf) * (lf.shards / world)
        if self.mesh.backend is not None:
            torch.distributed.all_reduce(sq)
        return torch.sqrt(sq)

    @torch.no_grad()
    def gather_params(self, params: Sequence[torch.Tensor]):
        """After an update: the optimizer slices back into every rank's
        whole parameters (zero1; fsdp holds only the slices)."""
        for lf, p in zip(self.leaves, params):
            if lf.opt_dim is None or lf.held:
                continue
            full = PD.all_gather(self.opt_slice(lf, p.data), lf.opt_dim, self.mesh.group(lf.opt_axis))
            p.data.copy_(full)

    @torch.no_grad()
    def full_grads(self, grads: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Every parameter's whole gradient from this rank's reduced pieces
        (``reduce_grads``), on every rank: the optimizer slices gathered,
        then the model shards (:func:`gather_params`; zeros stand for the
        other stages' layers). For checks; training never gathers."""
        own = {}
        for lf, g in zip(self.leaves, grads):
            if lf.opt_dim is not None:
                g = PD.all_gather(g.contiguous(), lf.opt_dim, self.mesh.group(lf.opt_axis))
            own[lf.name] = g
        tensors = {n: own.get(n, torch.zeros_like(p)) for n, p in self.net.named_parameters()}
        return gather_params(self.net, self.mesh, tensors)

    def writer(self, leaf: Leaf, sliced: bool) -> bool:
        """Whether this rank writes ``leaf``'s piece (its optimizer slice when
        ``sliced``) to a sharded checkpoint: the first of its replicas."""
        axes = set(leaf.model_axes)
        if sliced and leaf.opt_axis is not None:
            axes.add(leaf.opt_axis)
        return all(self.mesh.index(a) == 0 for a in MESH_AXES if a not in axes)

    def box_of(self, leaf: Leaf, sliced: bool) -> Tuple[slice, ...]:
        """The global box of the local piece (or of its optimizer slice)."""
        box = list(leaf.box)
        if sliced and leaf.opt_dim is not None:
            d = leaf.opt_dim
            n, i = self.mesh.size(leaf.opt_axis), self.mesh.index(leaf.opt_axis)
            per = (box[d].stop - box[d].start) // n
            box[d] = slice(box[d].start + i * per, box[d].start + (i + 1) * per)
        return tuple(box)


@torch.no_grad()
def gather_params(net: nn.Module, mesh: Mesh, tensors: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Dict[str, torch.Tensor]:
    """Every parameter of ``net`` (or ``tensors`` named like them, whole
    local pieces) whole, on every rank: the fsdp slices and the tensor and
    expert shards all-gathered, a pipelined layer's parameters broadcast
    from their stage. For tests and exports; training never gathers."""
    shards = getattr(net, "shards", {})
    held = getattr(net, "fsdp_held", {}) if tensors is None else {}
    cfg = getattr(net, "cfg", None)
    pipe = mesh.size("pipe") > 1 and cfg is not None and cfg.pipeline_stages > 1
    out = {}
    for name, p in net.named_parameters():
        t = (p if tensors is None else tensors[name]).detach()
        if name in held:
            t = PD.all_gather(t.contiguous(), held[name], mesh.group("fsdp"))
        if name in shards:
            dim, axis, _ = shards[name]
            t = PD.all_gather(t.contiguous(), dim, mesh.group(axis))
        for stack, n_layers in (("encoder.", getattr(cfg, "encoder", None)),
                                ("decoder.", getattr(cfg, "decoder", None))):
            if pipe and name.startswith(stack + "layers_"):
                i = int(name[len(stack) + len("layers_"):].split(".", 1)[0])
                per = n_layers.layers // mesh.size("pipe")
                t = PD.broadcast(t.contiguous().clone(), mesh.global_rank(pipe=i // per), mesh.group("pipe"))
        out[name] = t
    return out


class _GatherSlice(torch.autograd.Function):
    """An fsdp slice -> its whole local piece (all-gather over the fsdp
    group); the backward reduce-scatters the piece's gradient back to the
    slice, summed over the group."""

    @staticmethod
    def forward(ctx, p, dim, group):
        ctx.dim, ctx.group = dim, group
        return PD.all_gather(p, dim, group)

    @staticmethod
    def backward(ctx, g):
        return PD.reduce_scatter(g, ctx.dim, ctx.group), None, None


def _swap_in(owned) -> list:
    """Put the gathered whole piece of each (module, name, dim, group) that
    still holds its slice in the slice's place; returns what was swapped."""
    swapped = []
    for mod, pname, dim, group in owned:
        p = mod._parameters[pname]
        if isinstance(p, nn.Parameter):
            mod._parameters[pname] = _GatherSlice.apply(p, dim, group)
            swapped.append((mod, pname, p))
    return swapped


def _swap_out(swapped: list):
    for mod, pname, p in swapped:
        mod._parameters[pname] = p
