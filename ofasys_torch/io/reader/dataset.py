"""Epoch/batch iteration over readers (counterpart of
ofasys_tpu/io/reader/dataset.py).

Host-side and numpy-only, with ofasys_tpu's batches: the same epoch
permutation (``default_rng(seed + epoch)``), contiguous rank shards, a
fixed batch size (the ragged last batch dropped, or padded by repeating
its last sample with ``n_valid`` recorded), ``update_freq`` microbatches
stacked on a leading axis, and a background prefetch thread.

Resume. ``state_dict`` holds the epoch and the batches consumed in it.
``process_fn`` may draw from random generators (the task's template
choice, span masking, augmentation); given ``sample_rng`` (a pair of
functions that get and set that random state), the iterator also records,
with every batch it hands out, the position in the epoch and the random
state after the batch's samples, so a reloaded iterator continues exactly
where the saved one stopped. Without ``sample_rng`` a reloaded iterator
replays the epoch's samples up to its position, as ofasys_tpu does (it
skips ``iterations_in_epoch * update_freq`` microbatches; ofasys_tpu skips
``iterations_in_epoch`` of them, which under ``update_freq > 1`` repeats
batches: ROADMAP Queue C).
"""

from __future__ import annotations

import dataclasses
import queue
import re
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ofasys_torch.io.reader.base_reader import BaseReader

# (get, set) of the random state that process_fn draws from
SampleRng = Tuple[Callable[[], Any], Callable[[Any], None]]
_EPOCH_END = object()


def parse_dataset_paths(path: str) -> List[List[str]]:
    """The path DSL: ``|||`` separates per-epoch groups; ``name[1-3].tsv``
    expands to name1..name3."""
    groups = []
    for group in path.split("|||"):
        files: List[str] = []
        for part in group.split(","):
            part = part.strip()
            if not part:
                continue
            m = re.search(r"\[(\d+)-(\d+)\]", part)
            if m:
                lo, hi = int(m.group(1)), int(m.group(2))
                files.extend(part[:m.start()] + str(i) + part[m.end():] for i in range(lo, hi + 1))
            else:
                files.append(part)
        if files:
            groups.append(files)
    return groups


def tree_stack(items: List[Any]) -> Any:
    """Stack a list of like-structured batches leaf by leaf on a new leading
    axis (dicts, lists, tuples, SlotBatch-like dataclasses whose ``value``
    holds the arrays; None stays None)."""
    first = items[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: tree_stack([it[k] for it in items]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_stack(list(xs)) for xs in zip(*items))
    if dataclasses.is_dataclass(first) and hasattr(first, "value"):
        return dataclasses.replace(first, value=tree_stack([it.value for it in items]))
    return np.stack([np.asarray(x) for x in items], axis=0)


def tree_index(tree: Any, i: int) -> Any:
    """Microbatch ``i`` of a :func:`tree_stack`-ed batch."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_index(v, i) for v in tree)
    if dataclasses.is_dataclass(tree) and hasattr(tree, "value"):
        return dataclasses.replace(tree, value=tree_index(tree.value, i))
    return tree[i]


class EpochBatchIterator:
    def __init__(
        self,
        reader: BaseReader,
        process_fn: Callable[[Dict[str, Any], int], Any],
        collate_fn: Callable[[List[Any]], Dict[str, Any]],
        batch_size: int = 8,
        update_freq: int = 1,
        shuffle: bool = True,
        seed: int = 1,
        rank: int = 0,
        world_size: int = 1,
        drop_last: bool = True,
        prefetch: int = 2,
        epoch: int = 1,
        sample_rng: Optional[SampleRng] = None,
    ):
        self.reader = reader
        self.process_fn = process_fn
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.update_freq = update_freq
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = epoch
        self.sample_rng = sample_rng
        self.iterations_in_epoch = 0
        # (position in the epoch, random state) after the last batch handed
        # out; set by load_state_dict for the next epoch iteration to start at
        self._mark: Optional[Dict[str, Any]] = None
        self._resume: Optional[Dict[str, Any]] = None
        self._cur: Optional[Iterator] = None

    # ----------------------------------------------------------- iteration
    def _epoch_indices(self) -> np.ndarray:
        self.reader.open()
        self.reader.reset(self.epoch)
        n = len(self.reader)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(n)
        # contiguous rank shard
        per = n // self.world_size
        return order[self.rank * per:(self.rank + 1) * per] if self.world_size > 1 else order

    def _snapshot(self, position: int) -> Optional[Dict[str, Any]]:
        if self.sample_rng is None:
            return None
        return {"position": position, "rng": self.sample_rng[0]()}

    def _iter_batches(self):
        """Yields (batch, mark) pairs, then (_EPOCH_END, mark)."""
        idxs = self._epoch_indices()
        bsz = self.batch_size
        resume, self._resume = self._resume, None
        start, skipped_batches = 0, self.iterations_in_epoch * self.update_freq
        if resume is not None:
            start, skipped_batches = int(resume["position"]), 0
            self.sample_rng[1](resume["rng"])
        samples: List[Any] = []
        batch_count = 0
        micro: List[Tuple[Dict[str, Any], Any]] = []
        for pos in range(start, len(idxs)):
            i = idxs[pos]
            rec = self.reader.read(int(i))
            out = self.process_fn(rec, int(i))
            if out is None:
                continue
            samples.append(out)
            if len(samples) == bsz:
                batch_count += 1
                if batch_count > skipped_batches:
                    micro.append((self.collate_fn(samples), self._snapshot(pos + 1)))
                    if len(micro) == self.update_freq:
                        yield self._stack_micro([m for m, _ in micro]), micro[-1][1]
                        micro = []
                samples = []
        if samples and not self.drop_last:
            n_valid = len(samples)
            while len(samples) < bsz:
                samples.append(samples[-1])
            batch = self.collate_fn(samples)
            batch["n_valid"] = n_valid
            batch_count += 1
            if batch_count > skipped_batches:
                micro.append((batch, self._snapshot(len(idxs))))
        # flush an incomplete accumulation group as single-step batches
        for m, mark in micro:
            yield self._stack_micro([m]), mark
        yield _EPOCH_END, self._snapshot(0)

    def _stack_micro(self, micro: List[Dict[str, Any]]):
        if self.update_freq == 1 or len(micro) == 1:
            return micro[0]
        return tree_stack(micro)

    def next_epoch_itr(self, shuffle: Optional[bool] = None):
        if shuffle is not None:
            self.shuffle = shuffle
        it = self._iter_batches()
        if self.prefetch > 0:
            it = _prefetch_iter(it, self.prefetch)
        self._cur = self._counting(it)
        return self._cur

    def _counting(self, it):
        for batch, mark in it:
            if batch is _EPOCH_END:
                break
            self.iterations_in_epoch += 1
            self._mark = mark
            yield batch
        else:
            return
        self.iterations_in_epoch = 0
        self.epoch += 1
        self._mark = mark

    def end_of_epoch(self) -> bool:
        return self.iterations_in_epoch == 0

    def __iter__(self):
        return self.next_epoch_itr()

    # --------------------------------------------------------------- state
    def state_dict(self) -> Dict[str, Any]:
        state = {"epoch": self.epoch, "iterations_in_epoch": self.iterations_in_epoch}
        if self._mark is not None:
            state.update(self._mark)
        return state

    def load_state_dict(self, state: Dict[str, Any]):
        self.epoch = state.get("epoch", 1)
        self.iterations_in_epoch = state.get("iterations_in_epoch", 0)
        self._mark = None
        self._resume = None
        if self.sample_rng is not None and "rng" in state:
            self._mark = {"position": state["position"], "rng": state["rng"]}
            self._resume = dict(self._mark)


def _prefetch_iter(it: Iterator, depth: int) -> Iterator:
    """Run ``it`` on a daemon thread, ``depth`` items ahead; closing the
    returned generator stops the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # propagate into the consumer
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()
