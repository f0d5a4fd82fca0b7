"""A training cell: the port's summed train step
(``engine/train_step.make_train_step``, as ``Trainer`` calls it) with the
port's label-smoothed cross entropy and AdamW, over a ring of batches made
from the seed and staged on the device in set-up.

Traffic parameters (``portbench/traffic/<name>.json``, ``kind`` "train"):
``template`` and ``adaptors``; ``source_tokens`` [lo, hi] (the encoder's
length: bos, the template's text, the article, eos) and ``target_tokens``
[lo, hi] (the summary, before its eos); ``pad_multiple`` (every batch is
padded to its longest source rounded up to it, and targets to it);
``samples_per_update``; ``ring`` (distinct batches, grouped by length);
``dropout``, ``attention_dropout``, ``label_smoothing`` and ``optimizer``;
``warmup_passes`` (passes over the ring after the checked steps);
``traced_updates`` (profiled in a ``--trace 1`` run, after the window);
``checked_steps`` and ``reference_chunk`` (samples a
reference pass holds); ``limits``.

Every seed gets the same lengths (evenly spaced over the ranges, the same
samples in the same batches); the seed picks the ids, the order of the ring
and the dropout.
"""

from __future__ import annotations

import gc
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import build, flops, harness
from portbench.reference.ofa import AdamW as RefAdamW
from portbench.reference.ofa import Reference, byte_prompt, label_smoothed_loss, no_tf32


def _literals(template: str):
    """The template's literal text before and after its source slot."""
    before, after = template.split("->")[0].split("[TEXT:src]")
    return before, after


class Ring:
    """The ring's batches: each sample's ids on the host, and each batch
    collated by the port's preprocessors and moved to the device."""

    def __init__(self, traffic: Dict, cfg: Dict, seed: int, d, gp, device):
        from ofasys_torch.preprocessor.instruction import Instruction
        from ofasys_torch.utils.pytree import sample_to_device

        text_start = gp.name2pre["text"].text_start
        before, after = _literals(traffic["template"])
        self.prompt = (byte_prompt(text_start, before), byte_prompt(text_start, after))
        overhead = 2 + len(self.prompt[0]) + len(self.prompt[1])
        N, R = traffic["samples_per_update"], traffic["ring"]
        total = N * R
        (slo, shi), (tlo, thi) = traffic["source_tokens"], traffic["target_tokens"]
        src_len = [slo + (j * (shi - slo)) // max(total - 1, 1) for j in range(total)]
        tgt_len = [tlo + (j * 37) % (thi - tlo + 1) for j in range(total)]
        rng = np.random.default_rng([int(seed), 17])
        vocab = (text_start, text_start + cfg["vocab_text"])
        ist = Instruction(traffic["template"], split="train")
        self.pad, self.bos, self.eos = d.pad(), d.bos(), d.eos()
        self.multiple = traffic["pad_multiple"]
        self.host: List[List[tuple]] = []
        self.device: List[Dict] = []
        for r in rng.permutation(R):
            rows = [(rng.integers(*vocab, src_len[j] - overhead).astype(np.int32),
                     rng.integers(*vocab, tgt_len[j]).astype(np.int32)) for j in range(r * N, (r + 1) * N)]
            self.host.append(rows)
            batch = gp.collate([gp(ist.format(src=s, tgt=t)) for s, t in rows])
            self.device.append(sample_to_device(batch, device))
        self.tokens = [sum(overhead + len(s) + len(t) + 1 for s, t in rows) for rows in self.host]

    def shapes(self, k: int):
        """(batch, padded source, padded target) of batch k."""
        b = self.device[k]
        src = next(s for s in b["net_input"]["slots"] if s.is_src).value["inputs"]
        return src.shape[0], src.shape[1], b["target"].shape[1]

    def real(self, k: int):
        """(source, target) real lengths of batch k's samples, the decoder's
        bos or eos included."""
        o = 2 + len(self.prompt[0]) + len(self.prompt[1])
        return [(o + len(s), len(t) + 1) for s, t in self.host[k]]

    def reference_arrays(self, k: int, device):
        """Batch k as the reference builds it: the padded source ids, the
        decoder's inputs (bos, summary) and targets (summary, eos)."""
        rows = self.host[k]
        srcs = [[self.bos] + self.prompt[0] + s.tolist() + self.prompt[1] + [self.eos] for s, _ in rows]
        m = self.multiple
        Ts = -(-max(map(len, srcs)) // m) * m
        Tt = -(-max(len(t) + 1 for _, t in rows) // m) * m

        def pad(seqs, T):
            return torch.tensor([q + [self.pad] * (T - len(q)) for q in seqs], device=device)

        prev = pad([[self.bos] + t.tolist() for _, t in rows], Tt)
        target = pad([t.tolist() + [self.eos] for _, t in rows], Tt)
        return pad(srcs, Ts), prev, target


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator the port's train step gives one update's dropout
    (``engine/train_step.dropout_generator`` at task 0, microbatch 0)."""
    state = np.random.SeedSequence([seed, step, 0, 0]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed((int(state[0]) << 31 | int(state[1])) & ((1 << 63) - 1))


def _leaf_gaps(names, got: Dict, ref: Dict, only=None):
    """The worst leaf, as (gap, name): |got norm - ref norm| over the larger
    of the ref norm and the median leaf's ref norm."""
    med = float(np.median([ref[n] for n in names]))
    return max((abs(got[n] - ref[n]) / max(ref[n], med), n) for n in names if only is None or n in only)


def run(cfg: Dict, traffic: Dict, seed: int, seconds: float, trace: bool, device, phases,
        log: Callable[[str], None], hook: Optional[Callable] = None) -> Dict:
    """One run of a training cell. ``hook(model, criterion, optimizer)``
    (tests and controls only) may change the model or the optimizer and
    returns the criterion the step uses."""
    from ofasys_torch.engine.criterion import (LabelSmoothedCrossEntropyCriterion,
                                               LabelSmoothedCrossEntropyCriterionConfig)
    from ofasys_torch.engine.optim import AdamW
    from ofasys_torch.engine.train_step import TrainState, make_train_step

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    d, gp = build.dictionary(cfg, ["text"])
    tcfg = gp.name2pre["text"].cfg
    tcfg.max_src_length = traffic["source_tokens"][1]
    tcfg.max_tgt_length = traffic["target_tokens"][1] + 1
    tcfg.pad_to_multiple = traffic["pad_multiple"]
    model = build.build_model(cfg, d, traffic["adaptors"], device, seed, traffic["dropout"],
                              traffic["attention_dropout"])
    shapes = build.shapes_of(model.net)
    names = [n for n, _ in shapes]
    crit = LabelSmoothedCrossEntropyCriterion(
        LabelSmoothedCrossEntropyCriterionConfig(label_smoothing=traffic["label_smoothing"]), pad_id=d.pad())
    o = traffic["optimizer"]
    lr = float(o["lr"])
    opt = AdamW(lambda step: lr, b1=o["betas"][0], b2=o["betas"][1], eps=o["eps"],
                weight_decay=o["weight_decay"], clip_norm=o["clip_norm"])
    if hook is not None:
        crit = hook(model, crit, opt)
    state = TrainState.create(model.net, opt)
    step = make_train_step(model, crit, opt)
    ring = Ring(traffic, cfg, seed, d, gp, device)
    R = len(ring.device)
    phases.mark("weights and batches")

    # the checked steps: the window's own call on the ring's first batches
    losses, g1, change = [], {}, {}
    for k in range(traffic["checked_steps"]):
        state, logs = step(state, ring.device[k], seed)
        losses.append(float(logs["loss"]) / float(logs["sample_size"]))
        if k == 0:
            g1 = {n: float((m / (1.0 - o["betas"][0])).norm()) for n, m in zip(names, state.opt_state["mu"])}
    w0 = build.weight_tensors(shapes, seed, device)
    change = {n: float((p.detach() - w0[n]).norm()) for n, p in zip(names, state.params)}
    del w0
    for p in range(traffic["warmup_passes"]):
        for k in range(R):
            state, _ = step(state, ring.device[(traffic["checked_steps"] + k) % R], seed)
    sync()
    phases.mark("checked steps and warm-up")
    peak_setup = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # the window: whole passes over the ring, so that every window holds the same mix
    first = traffic["checked_steps"] + traffic["warmup_passes"] * R
    window_losses, done = [], []
    t0 = time.perf_counter()
    setup_s = t0 - phases.t0
    u = 0
    while time.perf_counter() < t0 + seconds or u % R:
        k = (first + u) % R
        state, logs = step(state, ring.device[k], seed)
        window_losses.append(logs["loss"])
        done.append(k)
        u += 1
    sync()
    t1 = time.perf_counter()
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    window_s = t1 - t0

    # a --trace 1 run profiles the next updates once the window has closed,
    # so that the profiler's cost stays out of the window
    profiled, tw = [], None
    if trace:
        prof = harness.profile(device)
        prof.start()
        with torch.profiler.record_function("portbench_open"):
            pass
        for j in range(traffic["traced_updates"]):
            k = (first + u + j) % R
            state, _ = step(state, ring.device[k], seed)
            B, Ts, Tt = ring.shapes(k)
            profiled.append(dict(batch=B, src=Ts, tgt=Tt))
        sync()
        with torch.profiler.record_function("portbench_close"):
            pass
        prof.stop()
        tw = harness.trace_window(prof, tempfile.gettempdir())
    tokens = sum(ring.tokens[k] for k in done)
    bad = int((~torch.isfinite(torch.stack(window_losses))).sum())
    flops_window = sum(flops.train_update_flops(cfg, len(d), ring.real(k)) for k in done)
    log(f"window {window_s:.3f} s: {len(done)} updates, {tokens} tokens, loss "
        f"{float(window_losses[-1]) / float(logs['sample_size']):.4f}")
    ctx = dict(kind="train", on_card=on_card, cfg=cfg, traffic=traffic, window_s=window_s, flops=flops_window,
               trace=tw, profiled=profiled, window_peak_bytes=window_peak)
    e2e = {"train_tokens_per_s": tokens / window_s, "setup_s": setup_s}

    # the program's state goes before the reference runs
    del state, step, model, crit, opt, logs, window_losses
    ring.device = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    compared = check(cfg, traffic, shapes, seed, device, d.pad(), ring, losses, g1, change, log)
    return dict(correct=all(c["value"] <= c["limit"] for c in compared.values()) and bad == 0,
                attempted=len(done), failed=bad, e2e=e2e, ctx=ctx,
                peak=max(peak_setup, window_peak), compared=compared)


def check(cfg, traffic, shapes, seed, device, pad, ring, losses, g1, change, log) -> Dict:
    """The float32 reference follows the checked steps from the same
    weights and batches, with the same dropout masks. Compared: the first
    step's loss (every step's is logged; the later ones move with how the
    compute dtype rounds the first updates, PERF.md), the first gradient as
    the optimizer gets it (after clipping) and the parameters' change after
    the last step, both by the worst leaf. Leaves whose reference gradient
    is under a thousandth of the median leaf's (a key's bias under softmax)
    are left out of the change."""
    no_tf32()
    names = [n for n, _ in shapes]
    w0 = build.weight_tensors(shapes, seed, device)
    params = {n: w.clone().requires_grad_(True) for n, w in w0.items()}
    rate = traffic["dropout"]
    keep_prob = 1.0 - rate
    keep_scale = float(torch.tensor(keep_prob, dtype=getattr(torch, cfg["compute_dtype"])))
    ref = Reference(params, cfg, pad, keep_scale=keep_scale)
    o = traffic["optimizer"]
    adam = RefAdamW(o["lr"], o["betas"][0], o["betas"][1], o["eps"], o["weight_decay"], o["clip_norm"])
    E, Ld, Le = cfg["encoder_embed_dim"], cfg["decoder_layers"], cfg["encoder_layers"]
    chunk = traffic["reference_chunk"]
    ref_losses, ref_g1 = [], {}
    for k in range(traffic["checked_steps"]):
        src, prev, target = ring.reference_arrays(k, device)
        B = src.shape[0]
        g = dropout_generator(seed, k, device)
        shapes_drawn = ([(B, src.shape[1], E)] * (1 + 2 * Le) + [(B, prev.shape[1], E)] * (1 + 3 * Ld)
                        if rate > 0 else [])
        masks = [torch.rand(s, generator=g, device=device) < keep_prob for s in shapes_drawn]
        total, count = 0.0, 0
        for c in range(0, B, chunk):
            it = iter([m[c:c + chunk] for m in masks]) if masks else None
            enc = ref.encode(src[c:c + chunk], None, it)
            logits = ref.decode(prev[c:c + chunk], enc, it)
            loss, n = label_smoothed_loss(logits, target[c:c + chunk], pad, traffic["label_smoothing"])
            loss.backward()
            total += float(loss.detach())
            count += int(n)
            del enc, logits, loss
        del masks
        grads = {n: params[n].grad / count for n in names}
        norm = adam.step(params, grads)
        if k == 0:
            scale = min(1.0, o["clip_norm"] / float(norm)) if o["clip_norm"] > 0 else 1.0
            ref_g1 = {n: float(grads[n].norm()) * scale for n in names}
        for p in params.values():
            p.grad = None
        ref_losses.append(total / count)
    ref_change = {n: float((params[n].detach() - w0[n]).norm()) for n in names}
    del params, w0, ref, adam
    med = float(np.median(list(ref_g1.values())))
    moving = {n for n in names if ref_g1[n] >= 1e-3 * med}
    grad_gap, grad_leaf = _leaf_gaps(names, g1, ref_g1)
    change_gap, change_leaf = _leaf_gaps(names, change, ref_change, moving)
    log(f"losses program {losses} reference {ref_losses}; {len(names) - len(moving)} leaves "
        f"with a gradient under 1e-3 of the median left out of the change; worst leaves: "
        f"gradient {grad_leaf}, change {change_leaf}")
    lim = traffic["limits"]
    return {
        "loss1_rel": {"value": abs(losses[0] - ref_losses[0]) / abs(ref_losses[0]), "limit": lim["loss1_rel"]},
        "grad_leaf_gap": {"value": grad_gap, "limit": lim["grad_leaf_gap"]},
        "change_leaf_gap": {"value": change_gap, "limit": lim["change_leaf_gap"]},
    }
