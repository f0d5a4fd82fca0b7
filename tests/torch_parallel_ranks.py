"""What the port's ranks run in the parallel parity tests
(tests/test_torch_{parallel,moe_ring,pipeline,scan_remat}.py).

The ranks are spawned processes (``ofasys_torch.parallel.distributed.World``)
that import this module by name: it imports torch, numpy and the port, and
neither jax nor ofasys_tpu. Every function here runs on each rank and
returns a picklable result (numpy arrays, floats); a world of one runs the
same functions in the test process.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ofasys_torch import GeneralistModel, ModalityType
from ofasys_torch.configure.configs import OptimizationConfig, ParallelConfig
from ofasys_torch.engine.criterion import (LabelSmoothedCrossEntropyCriterion,
                                           LabelSmoothedCrossEntropyCriterionConfig)
from ofasys_torch.engine.optim import build_optimizer
from ofasys_torch.parallel import (Layout, build_mesh, make_sharded_train_step, put_batch, shard_model,
                                   shard_train_state)
from ofasys_torch.parallel import distributed as PD
from ofasys_torch.parallel.sharding import gather_params
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.utils.jax_params import export_params, load_jax_params
from ofasys_torch.utils.pytree import SlotBatch


def dictionary() -> Dictionary:
    d = Dictionary()
    for i in range(60):
        d.add_symbol(f"<text>_{i}")
    d.pad_to_multiple_(8)
    return d


def copy_arrays(B: int = 8, T: int = 8, seed: int = 0):
    """(toks, prev, target) int32 of the JAX tests' copy batch."""
    d = dictionary()
    rng = np.random.default_rng(seed)
    toks = rng.integers(d.nspecial, d.nspecial + 50, size=(B, T - 1)).astype(np.int32)
    prev = np.concatenate([np.full((B, 1), d.bos(), np.int32), toks], axis=1)
    target = np.concatenate([toks, np.full((B, 1), d.eos(), np.int32)], axis=1)
    return toks, prev, target


def sample(toks, prev, target) -> Dict[str, Any]:
    """The port's host sample of those arrays."""
    return {"net_input": {"slots": [SlotBatch(ModalityType.TEXT, True, {"inputs": toks}, "src"),
                                    SlotBatch(ModalityType.TEXT, False, {"inputs": prev}, "tgt")]},
            "target": target}


def build(cfg_kw: Dict[str, Any], mesh=None, layers: int = 2, dtype=torch.float32) -> GeneralistModel:
    m = GeneralistModel(arch="tiny")
    m.cfg.encoder.layers = m.cfg.decoder.layers = layers
    for k, v in cfg_kw.items():
        setattr(m.cfg, k, v)
    m.initialize(dictionary(), active_adaptors=("text",), dtype=dtype, device="cpu", mesh=mesh)
    return m


def init_tree(cfg_kw: Dict[str, Any], layers: int = 2):
    """The flax tree of the tiny model's seeded init under ``cfg_kw`` (the
    stacked layout under ``scan_layers``)."""
    return export_params(build(cfg_kw, layers=layers).net)


def _mesh(pcfg: Optional[Dict[str, int]]):
    return build_mesh(ParallelConfig(**pcfg) if pcfg else None, device="cpu")


def sharded_steps(tree, pcfg: Optional[Dict[str, int]], cfg_kw: Dict[str, Any], arrays,
                  opt_kw: Optional[Dict[str, Any]] = None, n_steps: int = 1, zero1: bool = False,
                  seed: int = 7, layers: int = 2):
    """``n_steps`` updates of the tiny model from ``tree`` on the global
    batch ``arrays`` under ``pcfg`` (None: one process). Returns, on the
    first rank, the losses and the updated parameter tree (whole); None
    elsewhere."""
    mesh = _mesh(pcfg)
    m = build(cfg_kw, mesh=mesh, layers=layers)
    load_jax_params(m.net, tree)
    shard_model(m.net, mesh)
    d = m.global_dict
    crit = LabelSmoothedCrossEntropyCriterion(
        LabelSmoothedCrossEntropyCriterionConfig(label_smoothing=0.1), pad_id=d.pad())
    opt = build_optimizer(OptimizationConfig(**(opt_kw or dict(
        lr=(1e-2,), optimizer="sgd", lr_scheduler="fixed", clip_norm=0.0))), total_num_update=10)
    layout = Layout(m.net, mesh, zero1=zero1)
    state = shard_train_state(layout, opt)
    step = make_sharded_train_step(m, crit, opt, layout)
    batch = put_batch(sample(*arrays), mesh)
    losses = []
    for _ in range(n_steps):
        state, metrics = step(state, batch, seed)
        losses.append(float(metrics["loss"]))
    full = gather_params(m.net, mesh)
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    return {"losses": losses, "params": export_params(m.net, full, stacked=False),
            "staged": dict(PD.STAGED_OPS), "param_bytes": layout.param_bytes()}


def _rank0(value):
    return value if not dist.is_initialized() or dist.get_rank() == 0 else None


def mesh_shape(pcfg):
    m = _mesh(pcfg)
    return {"shape": m.shape, "coords": m.coords, "backend": m.backend}


# ------------------------------------------------------------------ MoE

def moe_sharded(x, rw, w1, w2, pcfg, cf, g):
    """moe_ffn_sharded on full host inputs (each rank keeps its experts):
    (out, aux, grads of x, rw, w1, w2 whole) on the first rank."""
    from ofasys_torch.parallel.moe import moe_ffn_sharded

    mesh = _mesh(pcfg)
    ep, ei = mesh.size("expert"), mesh.index("expert")
    per = w1.shape[0] // ep
    x, rw = torch.tensor(x, requires_grad=True), torch.tensor(rw, requires_grad=True)
    w1l = torch.tensor(w1[ei * per:(ei + 1) * per], requires_grad=True)
    w2l = torch.tensor(w2[ei * per:(ei + 1) * per], requires_grad=True)
    out, aux = moe_ffn_sharded(x, rw, w1l, w2l, mesh, capacity_factor=cf)
    gx, grw, g1, g2 = torch.autograd.grad((out * torch.as_tensor(g)).sum() + aux, [x, rw, w1l, w2l])
    g1 = PD.all_gather(g1, 0, mesh.group("expert"))
    g2 = PD.all_gather(g2, 0, mesh.group("expert"))
    return _rank0({"out": out.detach().numpy(), "aux": float(aux), "gx": gx.numpy(), "grw": grw.numpy(),
                   "g1": g1.numpy(), "g2": g2.numpy()})


# ------------------------------------------------------------------ ring

def ring(q, k, v, pcfg, scale, use_flash, causal=False, bias=None, mask=None, g=None):
    """ring_attention over the sequence axis on this rank's rows of the full
    host inputs; the output (and with ``g`` the gradients of sum(out * g)
    for q, k, v and the bias) gathered whole on the first rank."""
    from ofasys_torch.parallel.ring_attention import ring_attention

    mesh = _mesh(pcfg)
    grp = mesh.group("sequence")
    ts = [torch.tensor(a, requires_grad=g is not None) for a in (q, k, v)]
    loc = [PD.scatter(t, 1, grp) for t in ts]
    b = None
    if bias is not None:
        bt = torch.tensor(bias, requires_grad=g is not None)
        ts.append(bt)
        b = PD.scatter(bt, 2, grp)
    m = None if mask is None else torch.as_tensor(mask)
    out = ring_attention(*loc, mesh, scale=scale, use_flash=use_flash, causal=causal, bias=b, mask=m)
    full = PD.gather(out, 1, grp)
    res = {"out": full.detach().numpy()}
    if g is not None:
        grads = torch.autograd.grad((full * torch.as_tensor(g)).sum(), ts)
        res["grads"] = [x.numpy() for x in grads]
    return _rank0(res)


# ------------------------------------------------------------- the hub

def hub_tokens(pcfg, dtype: str, int8: bool, recs, gen: Dict[str, Any]):
    """Tokens and scores of the tiny hub (seeded init, tables, biases and
    kernels perturbed from a seed: a plain init decodes every source to the
    same tokens), quantized first when ``int8``, sharded over ``pcfg``
    (None: one rank), with the search's selections (chip_smoke's
    ``_selection_log``: each step's kept candidates and their margins)."""
    from ofasys_torch import OFASys
    from ofasys_torch.preprocessor.general import GeneralPreprocess

    d = dictionary()
    gp = GeneralPreprocess(d, active=["text"])
    d.pad_to_multiple_(8)          # as the trainer pads: the table splits over the tensor ranks
    m = GeneralistModel(arch="tiny")
    m.cfg.encoder.layers = m.cfg.decoder.layers = 2
    m.cfg.dropout = 0.0
    m.initialize(d, active_adaptors=("text",), dtype=getattr(torch, dtype), device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in m.net.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("rel_pos_table", "bias", "type_embedding"):
                p.add_(0.3 * torch.randn(p.shape, generator=g))
            elif leaf == "weight" and p.dim() == 2 and "embed" not in name:
                p.mul_(2.0)
    hub = OFASys(m, None, d, gp, device="cpu")
    if int8:
        hub.quantize()
    if pcfg is not None:
        hub.shard(ParallelConfig(**pcfg))
    import chip_smoke

    res = []
    log_ = chip_smoke._selection_log(hub, "[TEXT:src] -> [TEXT:tgt]", recs, gen, unconstrained=True,
                                     result=res)
    return _rank0({"answers": [(np.asarray(o.tokens).tolist(), float(o.score)) for o in res[0]],
                   "log": log_})


# --------------------------------------------------------- checkpoints

def checkpoint_steps(tree, pcfg, arrays, root: str, name: Optional[str], restore: Optional[str],
                     n_steps: int, seed: int = 7):
    """Adam updates of the tiny model under ``pcfg``: restored from
    ``restore`` (a sharded or one-file checkpoint) when given, then
    ``n_steps`` updates, then saved as the sharded checkpoint ``name``
    under ``root``. Returns the losses on the first rank."""
    from ofasys_torch.configure import to_dict
    from ofasys_torch.utils import checkpoint_utils

    mesh = _mesh(pcfg)
    m = build({"dropout": 0.0}, mesh=mesh)
    load_jax_params(m.net, tree)
    shard_model(m.net, mesh)
    crit = LabelSmoothedCrossEntropyCriterion(
        LabelSmoothedCrossEntropyCriterionConfig(label_smoothing=0.1), pad_id=m.global_dict.pad())
    opt = build_optimizer(OptimizationConfig(lr=(1e-3,), optimizer="adam", lr_scheduler="fixed",
                                             clip_norm=1.0), total_num_update=10)
    layout = Layout(m.net, mesh)
    state = shard_train_state(layout, opt)
    if restore is not None:
        checkpoint_utils.load_sharded_state(os.path.join(root, restore), state, layout)
    step = make_sharded_train_step(m, crit, opt, layout)
    batch = put_batch(sample(*arrays), mesh)
    losses = []
    for _ in range(n_steps):
        state, metrics = step(state, batch, seed)
        losses.append(float(metrics["loss"]))
    if name is not None:
        meta = {"num_updates": state.step, "model_cfg": to_dict(m.cfg), "active_adaptors": ["text"],
                "global_dict": m.global_dict.state_dict()}
        pieces = checkpoint_utils.sharded_pieces(state, layout)
        checkpoint_utils.save_sharded(root, name, pieces, mesh.rank, meta,
                                      barrier=dist.barrier if dist.is_initialized() else None)
    return _rank0({"losses": losses, "step": state.step,
                   "params": export_params(m.net, gather_params(m.net, mesh), stacked=False)})


# ------------------------------------------------------------ pipeline

def pipeline_toy(w, b, x, mask, scale, pcfg, n_micro):
    """parallel.pipeline_stack on the toy stack of ofasys_tpu's test: the
    output and the gradients of sum(y ** 2) for w, b (whole) and x."""
    from ofasys_torch.parallel import pipeline_stack

    mesh = _mesh(pcfg)
    L = w.shape[0]
    wt = [torch.tensor(w[i], requires_grad=True) for i in range(L)]
    bt = [torch.tensor(b[i], requires_grad=True) for i in range(L)]
    xt = torch.tensor(x, requires_grad=True)
    mt = torch.as_tensor(mask)
    st = torch.as_tensor(scale)

    def layer_apply(gi, m, x_mb, mm, bcast):
        return torch.tanh(x_mb @ wt[gi] + bt[gi]) * mm[:, :, None] * bcast + x_mb

    y = pipeline_stack(mesh, layer_apply, L, lambda gi: [wt[gi], bt[gi]], xt, micro_args=mt,
                       bcast_args=st, n_micro=n_micro)
    gw = torch.autograd.grad((y ** 2).sum(), wt + bt + [xt], allow_unused=True)
    S = mesh.size("pipe")
    per = L // S
    own = range(mesh.index("pipe") * per, (mesh.index("pipe") + 1) * per)
    full = []
    for i, gi in enumerate(gw[:2 * L]):
        layer = i % L
        t = gi if (gi is not None and layer in own) else torch.zeros_like((wt + bt)[i])
        full.append(PD.all_reduce(t.clone(), mesh.group("pipe")).numpy())
    return _rank0({"y": y.detach().numpy(), "gw": np.stack(full[:L]), "gb": np.stack(full[L:]),
                   "gx": gw[-1].numpy()})


def pipeline_model_grads(tree, pcfg, arrays, layers: int = 4):
    """The tiny model (``layers`` + ``layers``, stacked layout) pipelined
    over ``pcfg``: its logits and the gradient tree of the mean token NLL."""
    mesh = _mesh(pcfg)
    m = build({"dropout": 0.0, "scan_layers": True, "pipeline_stages": mesh.size("pipe")},
              mesh=mesh, layers=layers)
    load_jax_params(m.net, tree)
    s = put_batch(sample(*arrays), mesh)
    logits, _ = m.apply_train(s["net_input"]["slots"], deterministic=True)
    lp = torch.log_softmax(logits.float(), dim=-1)
    loss = -torch.gather(lp, -1, s["target"][..., None]).mean()
    names = [n for n, _ in m.net.named_parameters()]
    grads = torch.autograd.grad(loss, list(m.net.parameters()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(m.net.named_parameters(), grads)}
    S = mesh.size("pipe")
    if S > 1:
        from ofasys_torch.parallel.pipeline import stage_params

        own = [a and b for a, b in zip(stage_params(names, layers, "encoder.", mesh),
                                       stage_params(names, layers, "decoder.", mesh))]
        for n, o in zip(names, own):
            if not o:
                grads[n] = torch.zeros_like(grads[n])
            if n.startswith(("encoder.layers_", "decoder.layers_")):
                grads[n] = PD.all_reduce(grads[n].clone(), mesh.group("pipe"))
    return _rank0({"logits": logits.detach().numpy(), "loss": float(loss),
                   "grads": export_params(m.net, grads, stacked=False)})


def text_records(n: int = 32, seed: int = 0):
    """The copy records of ofasys_tpu's pipeline fit test."""
    words = ["red", "blue", "green", "bird", "dog", "cat", "sky", "tree"]
    rng = np.random.default_rng(seed)
    return [{"src": " ".join(words[j] for j in rng.integers(0, len(words), 4)),
             "tgt": " ".join(words[j] for j in rng.integers(0, len(words), 3))} for _ in range(n)]


def fit(save_dir: Optional[str], pcfg, max_update: int, batch_size: int = 8, valid: bool = False):
    """Trainer.fit of the tiny model on the copy records under ``pcfg``:
    the final parameters (whole), the step, the mean logged loss, the
    trainer's mesh shape and the bytes of the parameters the rank holds,
    from every rank; with ``valid`` also the metrics of Trainer.validate on
    other copy records after the fit."""
    from ofasys_torch import Task, Trainer, TrainerConfig
    from ofasys_torch.configure import ConfigStore

    t = Task(name="pipe_copy", instruction="[TEXT:src] -> [TEXT:tgt]")
    t.cfg.dataset.batch_size = batch_size
    t.cfg.dataset.num_workers = 0
    t.add_dataset(text_records(), "train")
    if valid:
        t.add_dataset(text_records(n=8, seed=1), "valid")
    m = GeneralistModel(arch="tiny")
    m.cfg.dropout = 0.0
    cfg = TrainerConfig()
    cfg.common.dtype = "float32"
    cfg.optimization.lr = (5e-3,)
    cfg.parallel = ParallelConfig(**pcfg)
    if save_dir is None:
        cfg.checkpoint.no_save = True
    else:
        cfg.checkpoint.save_dir = save_dir
        cfg.checkpoint.no_epoch_checkpoints = True
    tr = Trainer(cfg, device="cpu")
    try:
        state = tr.fit(m, [t], max_update=max_update)
        full = gather_params(m.net, tr.mesh)
        return {"params": export_params(m.net, full, stacked=False), "step": state.step,
                "loss": float(tr.meters["pipe_copy:loss"].avg), "shape": tr.mesh.shape,
                "stacked": (m.cfg.pipeline_stages, m.cfg.scan_layers),
                "param_bytes": sum(p.numel() * p.element_size() for p in m.net.parameters()),
                "valid": tr.validate(t) if valid else None}
    finally:
        ConfigStore().reset()
