"""A serving cell: a closed loop of clients on the port's
``InferenceServer``, whose dispatches go through ``OFASys.inference`` to the
generator, the model and the kernels.

Traffic parameters (``portbench/traffic/<name>.json``, ``kind`` "serve"):
``template`` and ``adaptors``; ``image_size`` (seeded RGB images, one a
request) and ``text_words`` ([lo, hi] seeded BPE ids of the request's text
slot, or null); ``clients`` (requests in flight), ``max_batch`` and
``max_wait_ms`` of the server; ``generation`` (the options every request
sends); ``pool`` (distinct requests made in set-up, sent in a seeded order);
``warmup_dispatches``; ``traced_dispatches`` (profiled in a ``--trace 1``
run, after the window); ``checked_requests`` (compared with the reference after the window)
and ``limits`` (the compared numbers' limits, set as ``PERF.md`` says).

Every seed gets the same set of text lengths; the seed picks the pixels,
the ids and the order.
"""

from __future__ import annotations

import gc
import itertools
import re
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import build, flops, harness
from portbench.reference.ofa import Reference, byte_prompt, gather_logprobs, no_tf32

DRAIN_S = 120.0
# requests the reference runs at once
REF_BATCH = 16


def _pieces(template: str):
    """The source side of a template as (kind, text-or-column) parts: the
    literal text between slots, and each slot's column."""
    src = template.split("->")[0]
    parts = []
    for lit, mod, col in re.findall(r"([^\[]*)(?:\[(\w+):(\w+)[^\]]*\])?", src):
        if lit.strip():
            parts.append(("literal", lit))
        if mod:
            parts.append((mod, col))
    return parts


class Requests:
    """The cell's distinct requests, made from the seed, and each one's
    source ids as the reference builds them."""

    def __init__(self, traffic: Dict, cfg: Dict, seed: int, text_start: int, bos: int, eos: int):
        rng = np.random.default_rng([int(seed), 11])
        n = traffic["pool"]
        self.image_size = traffic["image_size"]
        self.images = (rng.integers(0, 256, (n, self.image_size, self.image_size, 3), dtype=np.uint8)
                       if self.image_size else None)
        words = traffic.get("text_words")
        self.texts = None
        if words:
            lo, hi = words
            lengths = rng.permutation([lo + j % (hi - lo + 1) for j in range(n)])
            self.texts = [rng.integers(text_start, text_start + cfg["vocab_text"], k).astype(np.int32)
                          for k in lengths]
        self.order = rng.permutation(n)
        self.parts = _pieces(traffic["template"])
        self.text_start, self.bos, self.eos = text_start, bos, eos

    def record(self, i: int) -> Dict:
        j = int(self.order[i % len(self.order)])
        rec = {}
        for kind, col in self.parts:
            if kind == "IMAGE":
                rec[col] = self.images[j]
            elif kind == "TEXT":
                rec[col] = self.texts[j]
        return rec

    def src_ids(self, i: int) -> List[int]:
        """bos, the literal text's bytes and the text slot's ids, eos."""
        j = int(self.order[i % len(self.order)])
        ids = [self.bos]
        for kind, col in self.parts:
            if kind == "literal":
                ids += byte_prompt(self.text_start, col)
            elif kind == "TEXT":
                ids += self.texts[j].tolist()
        return ids + [self.eos]

    def image(self, i: int) -> Optional[np.ndarray]:
        return None if self.images is None else self.images[int(self.order[i % len(self.order)])]

    def src_len(self, i: int) -> int:
        return self.rec_src_len(self.record(i))

    def rec_src_len(self, rec: Dict) -> int:
        """The encoder's length for a record: the image's grid, bos, the
        literal text's bytes, the text slot's ids, eos."""
        n = (self.image_size // 16) ** 2 if self.image_size else 0
        for kind, col in self.parts:
            n += len(byte_prompt(0, col)) if kind == "literal" else len(rec[col]) if kind == "TEXT" else 0
        return n + 2


class ClosedLoop:
    """``clients`` requests in flight: each completion (on the server's
    dispatcher thread) records the request and submits the next."""

    def __init__(self, server, template: str, gen: Dict, reqs: Requests, clients: int):
        self.server, self.template, self.gen, self.reqs = server, template, gen, reqs
        self.clients = clients
        self.counter = itertools.count()
        self.done: List[tuple] = []             # (index, t_submit, t_done, output or exception)
        self.in_flight = 0
        self.lock = threading.Lock()
        self.stopping = False
        self.last_done = 0.0

    def start(self):
        for _ in range(self.clients):
            self._submit()

    def _submit(self):
        if self.stopping:
            return
        i = next(self.counter)
        with self.lock:
            self.in_flight += 1
        t = time.perf_counter()
        fut = self.server.submit(self.template, self.reqs.record(i), **self.gen)
        fut.add_done_callback(lambda f, i=i, t=t: self._finish(i, t, f))

    def _finish(self, i, t, fut):
        now = time.perf_counter()
        exc = fut.exception()
        self.done.append((i, t, now, exc if exc is not None else fut.result()))
        self.last_done = now
        with self.lock:
            self.in_flight -= 1
        self._submit()

    def stop_and_drain(self, timeout: float) -> int:
        """Stop submitting and wait for the requests in flight; returns how
        many never came back."""
        self.stopping = True
        end = time.perf_counter() + timeout
        while self.in_flight > 0 and time.perf_counter() < end:
            time.sleep(0.01)
        return self.in_flight


class Dispatches:
    """Wraps ``hub.inference`` (the server's one call into the hub): the
    start of every dispatch, and once ``arm`` is called a profile of the
    next ``n`` dispatches, started and stopped on the dispatcher thread
    between two marks."""

    def __init__(self, hub, device, src_len: Callable, eos: int, n: int):
        self.orig = hub.inference
        self.device, self.n = device, n
        self.src_len, self.eos = src_len, eos
        self.starts: List[float] = []
        self.armed = False
        self.prof = None
        self.profiled: List[Dict] = []
        self.traced = threading.Event()
        hub.inference = self

    def arm(self) -> None:
        self.armed = True

    def __call__(self, instruction, data, **kw):
        self.starts.append(time.perf_counter())
        traced = self.armed and len(self.profiled) < self.n
        if traced and self.prof is None:
            self.prof = harness.profile(self.device)
            self.prof.start()
            with torch.profiler.record_function("portbench_open"):
                pass
        out = self.orig(instruction, data, **kw)
        if traced:
            recs = data if isinstance(data, list) else [data]
            outs = out if isinstance(out, list) else [out]
            unique = {id(r): o for r, o in zip(recs, outs)}
            self.profiled.append(dict(batch=len(recs), src=max(self.src_len(r) for r in recs),
                                      tokens=sum(n_out(o, self.eos) for o in unique.values())))
            if len(self.profiled) == self.n:
                if torch.device(self.device).type == "cuda":
                    torch.cuda.synchronize()
                with torch.profiler.record_function("portbench_close"):
                    pass
                self.prof.stop()
                self.traced.set()
        return out

    def boundary_after(self, t: float, loop: "ClosedLoop", timeout: float = DRAIN_S) -> float:
        """The end of the first dispatch that completes a request at or
        after ``t``: the last completion before the next dispatch starts
        (the dispatcher sets a dispatch's results, then starts the next)."""
        end = time.perf_counter() + timeout
        while loop.last_done < t and time.perf_counter() < end:
            time.sleep(0.001)
        k = len(self.starts)
        while len(self.starts) <= k and time.perf_counter() < end:
            time.sleep(0.001)
        nxt = self.starts[k] if len(self.starts) > k else float("inf")
        return max(r[2] for r in list(loop.done) if r[2] < nxt)


def n_out(out, eos: int) -> int:
    """Output tokens of a returned hypothesis, its final EOS not counted."""
    toks = np.asarray(out.tokens).reshape(-1)
    return int(len(toks) - (1 if len(toks) and int(toks[-1]) == eos else 0))


def run(cfg: Dict, traffic: Dict, seed: int, seconds: float, trace: bool, device, phases,
        log: Callable[[str], None], hub_hook: Optional[Callable] = None) -> Dict:
    """One run of a serving cell. ``hub_hook`` (tests and controls only)
    changes the hub before the loop starts."""
    from ofasys_torch import OFASys
    from ofasys_torch.serve import InferenceServer

    on_card = torch.device(device).type == "cuda"
    active = ["text"] + (["image"] if traffic["image_size"] else []) + \
        (["box"] if "[BOX:" in traffic["template"] else [])
    d, gp = build.dictionary(cfg, active)
    if traffic["image_size"]:
        gp.name2pre["image"].cfg.patch_image_size = traffic["image_size"]
    model = build.build_model(cfg, d, traffic["adaptors"], device, seed)
    shapes = build.shapes_of(model.net)
    hub = OFASys(model, None, d, gp, device=device)
    if hub_hook is not None:
        hub_hook(hub)
    text_start = gp.name2pre["text"].text_start
    reqs = Requests(traffic, cfg, seed, text_start, d.bos(), d.eos())
    phases.mark("weights and requests")

    gen = dict(traffic["generation"])
    max_len = gen["max_len_b"]
    eos = d.eos()
    server = InferenceServer(hub, max_batch=traffic["max_batch"], max_wait_ms=traffic["max_wait_ms"],
                             device=device)
    warm = traffic["warmup_dispatches"]
    disp = Dispatches(hub, device, reqs.rec_src_len, eos, traffic["traced_dispatches"])
    loop = ClosedLoop(server, traffic["template"], gen, reqs, traffic["clients"])
    loop.start()
    while len(disp.starts) < warm:
        time.sleep(0.005)
    # the window runs from the end of the last warm-up dispatch to the end
    # of the first dispatch that completes after --seconds: whole dispatches
    t0 = disp.boundary_after(disp.starts[-1], loop)
    phases.mark("warm-up")
    stats0 = server.stats()
    peak_setup = torch.cuda.max_memory_allocated() if on_card else 0
    setup_s = t0 - phases.t0
    t1 = disp.boundary_after(t0 + seconds, loop)
    stats1 = server.stats()
    if trace:
        # the profiled dispatches come after the window, so that the
        # profiler's cost stays out of it
        disp.arm()
        disp.traced.wait(DRAIN_S)
    lost = loop.stop_and_drain(DRAIN_S)
    server.close()
    peak = max(peak_setup, torch.cuda.max_memory_allocated()) if on_card else 0

    window = [r for r in loop.done if t0 < r[2] <= t1]
    ok = [r for r in window if not isinstance(r[3], BaseException)]
    failed = len(window) - len(ok) + lost
    lat_ms = sorted((r[2] - r[1]) * 1e3 for r in ok)
    out_tokens = sum(n_out(r[3], eos) for r in ok)
    window_s = t1 - t0
    beams = gen.get("beam_size", 1)
    vocab = len(d)
    flops_window = sum(flops.serve_dispatch_flops(cfg, vocab, 1, traffic["image_size"], reqs.src_len(r[0]),
                                                  beams, len(np.asarray(r[3].tokens).reshape(-1)))
                       for r in ok)
    e2e = {"serve_tokens_per_s": out_tokens / window_s,
           "serve_p95_ms": _p95(lat_ms) if lat_ms else None,
           "setup_s": setup_s}
    log(f"window {window_s:.3f} s: {len(ok)} requests, {out_tokens} tokens, {failed} failed, "
        f"{stats1['batches'] - stats0['batches']} dispatches, p50 {lat_ms[len(lat_ms) // 2] if lat_ms else 0:.1f} ms")
    tw = harness.trace_window(disp.prof, tempfile.gettempdir()) if disp.traced.is_set() else None
    ctx = dict(kind="serve", on_card=on_card, cfg=cfg, traffic=traffic, window_s=window_s, stats0=stats0,
               stats1=stats1, flops=flops_window, trace=tw, profiled=disp.profiled)

    # the program's state goes before the reference runs
    hub.inference = disp.orig
    del server, loop.server, disp, hub, model, gp
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    compared = check(cfg, traffic, shapes, seed, device, d.pad(), eos, max_len, reqs, ok, log)
    return dict(correct=all(c["value"] <= c["limit"] for c in compared.values()) and failed == 0 and bool(ok),
                attempted=len(window) + lost, failed=failed, e2e=e2e, ctx=ctx, peak=peak, compared=compared)


def _p95(sorted_ms: List[float]) -> float:
    """The 95th percentile by linear interpolation between order statistics."""
    return float(np.percentile(np.asarray(sorted_ms), 95))


def check(cfg, traffic, shapes, seed, device, pad, eos, max_len, reqs, ok, log) -> Dict:
    """A sample of the window's requests drawn from the seed, the longest
    among them, each served hypothesis scored by the float32 reference: the
    gap between the program's sum of its tokens' log-probabilities (its
    score times the length; a final EOS the generator forced at the length
    limit scores 0 there and is left out here too) and the reference's.

    The gaps split in two. Their mean over the sample (``gap_mean``, nats,
    taken absolute) is what every request shares: with random weights the
    requests' decoder states lie close together, so the rounding of the
    compute dtype moves them alike, by an amount the seed draws; a token
    altered where it is produced moves it by nats. Their spread about that
    mean (``gap_sd``, nats, the population standard deviation) is each
    request's own error, steady from seed to seed, which a lower precision
    widens. ``traffic["limits"]`` names the numbers compared; the gaps
    themselves and their root mean square are logged."""
    limits = traffic["limits"]
    if not ok:
        return {k: {"value": float("inf"), "limit": v} for k, v in limits.items()}
    rng = np.random.default_rng([int(seed), 13])
    longest = max(range(len(ok)), key=lambda k: len(np.asarray(ok[k][3].tokens).reshape(-1)))
    rest = [k for k in rng.permutation(len(ok)) if k != longest]
    pick = [longest] + rest[:max(0, traffic["checked_requests"] - 1)]
    pick.sort(key=lambda k: reqs.src_len(ok[k][0]))
    no_tf32()
    W = build.weight_tensors(shapes, seed, device)
    ref = Reference(W, cfg, pad)
    gaps = []
    with torch.no_grad():
        for c in range(0, len(pick), REF_BATCH):
            rows = [ok[k] for k in pick[c:c + REF_BATCH]]
            toks = [[int(t) for t in np.asarray(r[3].tokens).reshape(-1)] for r in rows]
            srcs = [reqs.src_ids(r[0]) for r in rows]
            Ts, Tt = max(map(len, srcs)), max(map(len, toks))
            src = torch.tensor([q + [pad] * (Ts - len(q)) for q in srcs], device=device)
            prev = torch.tensor([[reqs.bos] + t[:-1] + [pad] * (Tt - len(t)) for t in toks], device=device)
            imgs = None if reqs.image(rows[0][0]) is None else \
                torch.as_tensor(np.stack([reqs.image(r[0]) for r in rows]), device=device)
            logits = ref.decode(prev, ref.encode(src, imgs))
            for b, (r, t) in enumerate(zip(rows, toks)):
                n = len(t) - (1 if len(t) == max_len + 1 and t[-1] == eos else 0)
                gaps.append(float(r[3].score) * len(t) - float(gather_logprobs(logits[b, :len(t)], t)[:n].sum()))
    del W, ref
    g = np.asarray(gaps)
    numbers = {"gap_mean": float(abs(g.mean())), "gap_sd": float(g.std())}
    log("gaps " + " ".join(f"{x:.4f}" for x in g))
    log(f"checked {len(g)} requests against the float32 reference: gap max |{np.abs(g).max():.6f}|, "
        f"mean {g.mean():.6f}, sd {g.std():.6f}, rms {np.sqrt((g * g).mean()):.6f} nats")
    return {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
