"""Process groups, the collectives the parallel paths use, and a local
world of spawned ranks (counterpart of ofasys_tpu/parallel/distributed.py).

``distributed_init`` starts the default process group from the environment
(ofasys_tpu's variables, or torchrun's):

  OFASYS_COORDINATOR / MASTER_ADDR[:MASTER_PORT]   host:port of rank 0
  OFASYS_NUM_PROCESSES / WORLD_SIZE                 number of ranks
  OFASYS_PROCESS_ID / RANK                          this rank

and is a no-op in a world of one. The backend is NCCL where every rank of
a node has a CUDA device of its own (the node's ranks, torchrun's
``LOCAL_WORLD_SIZE``, at most its cards), gloo otherwise (NCCL refuses two
ranks on one device, so several ranks on one card run over gloo).

The collectives are plain functions over a mesh axis's group; each is the
identity where the group is None (a world of one without a process group).
gloo takes CUDA tensors for the collectives (``GLOO_CUDA_OPS``: a probe of
each op in its own two-rank world on one H100, torch 2.11+cu128) but not
for point-to-point sends and receives, which end the process; for those
(``ppermute``, ``send``, ``recv``) a CUDA tensor on a gloo group goes
through the host: copied to the CPU, sent or received there, the result
copied back. That choice is made from the group's backend and the op's
name (``staged``), and each staged op is recorded in ``STAGED_OPS`` so that
a caller can print it.

The autograd regions join replicated and sharded computation, as Megatron's
f and g operators do:

  enter(x)            identity forward, all-reduce backward (replicated x
                      feeds computation that differs by rank)
  exit(x)             all-reduce forward, identity backward (partial sums
                      become a replicated value)
  scatter(x, dim)     this rank's slice forward, all-gather backward
  gather(x, dim)      all-gather forward, this rank's slice backward
  all_to_all(x)       its own inverse, forward and backward

The ring's and the pipeline's point-to-point hand-offs (``ppermute``,
``send``, ``recv``) run inside autograd functions of their own
(parallel/ring_attention.py, parallel/pipeline.py), which order them alike
on every rank.
"""

from __future__ import annotations

import logging
import os
import queue
import shutil
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger("ofasys_torch.distributed")

# the ops gloo takes on CUDA tensors; ppermute, send and recv are not among them
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast", "all_gather", "reduce_scatter", "all_to_all"})
# (op, backend) pairs that went through the host, with their counts
STAGED_OPS: Dict[str, int] = {}


def _backend_of(group) -> str:
    return dist.get_backend(group)


def staged(op: str, t: torch.Tensor, group) -> bool:
    """Whether ``op`` on ``t`` over ``group`` goes through the host: a CUDA
    tensor on a gloo group, for an op outside ``GLOO_CUDA_OPS``."""
    return t.is_cuda and _backend_of(group) == "gloo" and op not in GLOO_CUDA_OPS


def _note(op: str):
    STAGED_OPS[op] = STAGED_OPS.get(op, 0) + 1


def distributed_init(backend: Optional[str] = None) -> Tuple[int, int]:
    """Start the default process group when the environment names a world
    of more than one rank; returns (rank, world). Safe to call repeatedly."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coord = os.environ.get("OFASYS_COORDINATOR")
    world = os.environ.get("OFASYS_NUM_PROCESSES") or os.environ.get("WORLD_SIZE")
    rank = os.environ.get("OFASYS_PROCESS_ID") or os.environ.get("RANK")
    if not world or int(world) <= 1:
        return 0, 1
    world, rank = int(world), int(rank or 0)
    if coord is None:
        addr = os.environ.get("MASTER_ADDR")
        if addr is None:
            raise ValueError("a world of several ranks needs OFASYS_COORDINATOR or MASTER_ADDR")
        coord = f"{addr}:{os.environ.get('MASTER_PORT', '29500')}"
    if backend is None:
        # NCCL where every rank of this node has a card of its own: the
        # node's ranks (torchrun's LOCAL_WORLD_SIZE; else the world, one node)
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        backend = "nccl" if torch.cuda.is_available() and local <= torch.cuda.device_count() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coord}", rank=rank, world_size=world)
    logger.info("torch.distributed initialized: rank %d/%d via %s (%s)", rank, world, coord, backend)
    return rank, world


# ---------------------------------------------------------------- collectives

def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum (or ``op``) of ``t`` over ``group``, in place; returns ``t``."""
    if group is None:
        return t
    dist.all_reduce(t, op=op, group=group)
    return t


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of the world rank ``src`` on every rank of ``group``, in place."""
    if group is None:
        return t
    dist.broadcast(t, src=src, group=group)
    return t


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group-rank order."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of the ranks' ``t``."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} does not divide by {n}")
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Chunk i of dim 0 goes to group rank i; the result's chunk j came
    from group rank j (``all_to_all_single`` with equal splits)."""
    if group is None:
        return t
    src = t.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out


def ppermute(t: torch.Tensor, perm: Sequence[Tuple[int, int]], group) -> torch.Tensor:
    """``jax.lax.ppermute`` over a group: group rank ``i`` sends ``t`` to
    ``j`` for each (i, j) of ``perm`` and receives from the rank whose pair
    names it (zeros where none does)."""
    if group is None:
        return t
    me = dist.get_group_rank(group, dist.get_rank())
    dst = [j for i, j in perm if i == me]
    src = [i for i, j in perm if j == me]
    host = staged("ppermute", t, group)
    if host:
        _note("ppermute")
    buf = t.contiguous().cpu() if host else t.contiguous()
    out = torch.zeros_like(buf)
    ops = [dist.P2POp(dist.isend, buf, dist.get_global_rank(group, j), group) for j in dst]
    ops += [dist.P2POp(dist.irecv, out, dist.get_global_rank(group, i), group) for i in src]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(t.device)


def send(t: torch.Tensor, dst: int, group) -> List[Any]:
    """Send ``t`` to group rank ``dst``; returns the pending requests (and
    the buffer they read) for the caller to wait on."""
    host = staged("send", t, group)
    if host:
        _note("send")
    buf = t.detach().contiguous().cpu() if host else t.detach().contiguous()
    return [dist.isend(buf, dist.get_global_rank(group, dst), group=group), buf]


def recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    """A tensor shaped like ``like`` from group rank ``src``."""
    host = staged("recv", like, group)
    if host:
        _note("recv")
    buf = torch.empty(like.shape, dtype=like.dtype, device="cpu" if host else like.device)
    dist.recv(buf, dist.get_global_rank(group, src), group=group)
    return buf.to(like.device)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_group_rank(group, dist.get_rank())


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


# ------------------------------------------------------------- autograd regions

class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n, i = group_size(group), group_rank(group)
        if x.shape[dim] % n:
            raise ValueError(f"scatter: dim {dim} of {tuple(x.shape)} does not divide by {n}")
        per = x.shape[dim] // n
        return x.narrow(dim, i * per, per).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        n, i = group_size(ctx.group), group_rank(ctx.group)
        per = g.shape[ctx.dim] // n
        return g.narrow(ctx.dim, i * per, per).contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


def enter(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _Enter.apply(x, group)


def exit(x: torch.Tensor, group) -> torch.Tensor:  # noqa: A001 (Megatron's g)
    return x if group is None else _Exit.apply(x, group)


def scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _Scatter.apply(x, dim, group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _Gather.apply(x, dim, group)


def diff_all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllToAll.apply(x, group)


# ------------------------------------------------------------ a local world

def _rank_main(rank: int, world: int, init: str, backend: str, threads: int, tasks, results):
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)
    try:
        while True:
            item = tasks.get()
            if item is None:
                break
            fn, args, kwargs = item
            try:
                results.put((rank, True, fn(*args, **kwargs)))
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    """``n`` ranks spawned once (the ``spawn`` start method, a ``file://``
    rendezvous in a private directory, so that concurrent worlds never share
    a port) that run functions on request:

        with World(2) as w:
            results = w.run(fn, *args)     # fn(*args) on every rank, by rank

    ``fn`` must be importable by name in the children. Every rank sets
    ``threads`` intra-op threads."""

    def __init__(self, n: int, backend: str = "gloo", threads: int = 1,
                 timeout: float = 600.0):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.n, self.timeout = n, timeout
        self._dir = tempfile.mkdtemp(prefix="ofasys_world_")
        init = "file://" + os.path.join(self._dir, "rendezvous")
        self._tasks = [ctx.Queue() for _ in range(n)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, n, init, backend, threads, self._tasks[r],
                                         self._results))
                       for r in range(n)]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, *args, **kwargs) -> List[Any]:
        self.submit(fn, *args, **kwargs)
        return self.collect()

    def submit(self, fn: Callable, *args, **kwargs):
        """Hand every rank ``fn(*args, **kwargs)`` and return at once;
        ``collect`` waits for the results."""
        for q in self._tasks:
            q.put((fn, args, kwargs))

    def collect(self) -> List[Any]:
        """The results of the last ``submit``, by rank."""
        out: List[Any] = [None] * self.n
        errors = []
        for _ in range(self.n):
            try:
                rank, ok, value = self._results.get(timeout=self.timeout)
            except queue.Empty:
                self.close(force=True)
                raise TimeoutError(f"world of {self.n}: no result within {self.timeout} s") from None
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                # a failing rank can leave the others waiting in a collective
                # (and a rank that died takes no more work)
                dead = {r: p.exitcode for r, p in enumerate(self._procs) if p.exitcode is not None}
                self.close(force=True)
                raise RuntimeError("\n".join(errors) + (f"\nranks that exited: {dead}" if dead else ""))
        return out

    def close(self, force: bool = False):
        for p, q in zip(self._procs, self._tasks):
            if p.is_alive() and not force:
                q.put(None)
        for p in self._procs:
            p.join(timeout=0 if force else 30)
            if p.is_alive():
                p.terminate()
                p.join()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc):
        self.close()

