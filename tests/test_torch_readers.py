"""ofasys_torch's readers and batch iterator (io/reader/) against
ofasys_tpu's: the line index file byte for byte, every reader's records,
and EpochBatchIterator's batches bit for bit over 2 epochs (ranks 0 and 1
of 2, drop_last on and off, update_freq 2, the prefetch thread, a
state_dict taken mid-epoch and reloaded). With ``sample_rng`` the port's
iterator also resumes a process_fn that draws random numbers exactly,
across an epoch boundary and under update_freq 2.
"""

import os

import jax
import numpy as np
import pytest

from ofasys_tpu.io.reader import dataset as jds
from ofasys_tpu.io.reader import file_reader as jfr
from ofasys_tpu.io.reader import readers as jr
from ofasys_torch.io.reader import dataset as tds
from ofasys_torch.io.reader import file_reader as tfr
from ofasys_torch.io.reader import readers as tr
from ofasys_torch.utils import file_utils


@pytest.fixture
def tsv(tmp_path, monkeypatch):
    monkeypatch.setenv("OFA_CACHE_HOME", str(tmp_path / "cache"))
    rng = np.random.default_rng(0)
    path = tmp_path / "data.tsv"
    with open(path, "w", encoding="utf-8") as f:
        for i in range(23):
            f.write(f"{i}\tsrc {rng.integers(1000)} é\ttgt {i * 7}\n")
    return str(path)


def test_line_index_file_is_ofasys_tpus(tsv, tmp_path):
    for name, text in (("data", None), ("no_newline", "a\nb\nlast"), ("empty", ""), ("blank", "\n\n")):
        path = tsv if text is None else str(tmp_path / f"{name}.txt")
        if text is not None:
            with open(path, "w") as f:
                f.write(text)
        jfr._build_index_numpy(path, str(tmp_path / f"{name}.j.idx"))
        tfr._build_index_numpy(path, str(tmp_path / f"{name}.t.idx"))
        with open(tmp_path / f"{name}.j.idx", "rb") as a, open(tmp_path / f"{name}.t.idx", "rb") as b:
            assert a.read() == b.read(), name
        np.testing.assert_array_equal(tfr.build_line_index(path), jfr.build_line_index(path, use_native=False))
    # the port's index cache is its own directory, under OFA_CACHE_HOME
    assert os.listdir(tmp_path / "cache")


def _records(reader):
    reader.open()
    return [reader.read(i) for i in range(len(reader))]


def test_readers_match_ofasys_tpu(tsv, tmp_path):
    recs = [{"a": i, "b": str(i * 3)} for i in range(11)]
    pairs = [
        (jr.TsvReader(tsv), tr.TsvReader(tsv)),
        (jr.TsvReader(tsv, selected_cols="2:tgt,0:id"), tr.TsvReader(tsv, selected_cols="2:tgt,0:id")),
        (jr.TsvReader(tsv, selected_cols="id,src"), tr.TsvReader("file://" + tsv, selected_cols="id,src")),
        (jr.ListReader(recs), tr.ListReader(recs)),
        (jr.HfDatasetReader(recs), tr.HfDatasetReader(recs)),
        (jr.ConcatReader([jr.TsvReader(tsv), jr.ListReader(recs)]),
         tr.ConcatReader([tr.TsvReader(tsv), tr.ListReader(recs)])),
    ]
    for j, t in pairs:
        assert _records(t) == _records(j)
    for epoch in (0, 1, 2):
        j, t = jr.CachedReader(jr.TsvReader(tsv), seed=4), tr.CachedReader(tr.TsvReader(tsv), seed=4)
        j.reset(epoch)
        t.reset(epoch)
        assert _records(t) == _records(j)
        j = jr.MixedReader([jr.ListReader(recs), jr.TsvReader(tsv)], ratios=[2.0, 0.5], seed=3)
        t = tr.MixedReader([tr.ListReader(recs), tr.TsvReader(tsv)], ratios=[2.0, 0.5], seed=3)
        j.open(), t.open()
        j.reset(epoch)
        t.reset(epoch)
        assert _records(t) == _records(j)
    for path in ("a[1-3].tsv,b.tsv|||c[0-1].tsv", " x.tsv , ,y.tsv"):
        assert tds.parse_dataset_paths(path) == jds.parse_dataset_paths(path)
    with pytest.raises(NotImplementedError, match="item 11"):
        tr.TsvReader("oss://bucket/data.tsv").open()
    assert file_utils.cached_path("file://" + tsv) == tsv


def _process(rec, i):
    """A deterministic sample: tokens from the record, of a length that
    varies (so batches pad), None for every 9th record."""
    if i % 9 == 4:
        return None
    n = 3 + i % 4
    return {"tokens": np.arange(n, dtype=np.int64) + i, "id": np.int64(i)}


def _collate(samples):
    T = max(len(s["tokens"]) for s in samples)
    return {"tokens": np.stack([np.pad(s["tokens"], (0, T - len(s["tokens"])), constant_values=-1)
                                for s in samples]),
            "id": np.stack([s["id"] for s in samples]), "nsentences": len(samples)}


def _fixed_collate(samples):
    return {"tokens": np.stack([np.pad(s["tokens"], (0, 8 - len(s["tokens"])), constant_values=-1)
                                for s in samples]),
            "id": np.stack([s["id"] for s in samples])}


def _iterator(mod, reader, **kw):
    return mod.EpochBatchIterator(reader=reader, process_fn=_process,
                                  collate_fn=kw.pop("collate", _collate), **kw)


def _epochs(it, n=2):
    return [b for _ in range(n) for b in it.next_epoch_itr()]


def _equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("kw", [
    dict(batch_size=4),
    dict(batch_size=4, drop_last=False),
    dict(batch_size=3, rank=0, world_size=2),
    dict(batch_size=3, rank=1, world_size=2, drop_last=False),
    dict(batch_size=2, update_freq=2, collate=_fixed_collate),
    dict(batch_size=4, shuffle=False, prefetch=0),
])
def test_epoch_batch_iterator_matches_ofasys_tpu(kw):
    recs = [{"i": i} for i in range(29)]
    j = _iterator(jds, jr.ListReader(recs), seed=5, **dict(kw))
    t = _iterator(tds, tr.ListReader(recs), seed=5, **dict(kw))
    jb, tb = _epochs(j), _epochs(t)
    assert len(jb) == len(tb) > 0
    for a, b in zip(jb, tb):
        _equal(a, b)
    assert t.state_dict() == j.state_dict() == {"epoch": 3, "iterations_in_epoch": 0}


def test_mid_epoch_state_dict_reload_matches_ofasys_tpu():
    recs = [{"i": i} for i in range(29)]
    sides = []
    for mod, rmod in ((jds, jr), (tds, tr)):
        it = _iterator(mod, rmod.ListReader(recs), batch_size=4, seed=2)
        epochs = it.next_epoch_itr()
        [next(epochs) for _ in range(3)]
        state = it.state_dict()
        it2 = _iterator(mod, rmod.ListReader(recs), batch_size=4, seed=2)
        it2.load_state_dict(state)
        sides.append((state, list(it2.next_epoch_itr()), list(it2.next_epoch_itr())))
    (js, j1, j2), (ts, t1, t2) = sides
    assert js == ts == {"epoch": 1, "iterations_in_epoch": 3}
    _equal(j1, t1)
    _equal(j2, t2)


class Drawing:
    """A process_fn that draws from its own generator, with the random
    state the iterator snapshots."""

    def __init__(self):
        self.rng = np.random.default_rng(11)

    def __call__(self, rec, i):
        n = int(self.rng.integers(2, 6))
        return {"tokens": self.rng.integers(0, 100, n), "id": np.int64(i)}

    def get(self):
        return self.rng.bit_generator.state

    def set(self, state):
        self.rng.bit_generator.state = state


@pytest.mark.parametrize("update_freq, cut", [(1, 3), (1, 7), (2, 2), (2, 4)])
def test_resume_with_sample_rng_is_exact(update_freq, cut):
    """The updates after a saved position equal the uninterrupted run's,
    also across the epoch boundary (7 batches an epoch at update_freq 1)."""
    recs = [{"i": i} for i in range(29)]

    def make(state=None):
        fn = Drawing()
        it = tds.EpochBatchIterator(tr.ListReader(recs), lambda rec, i: fn(rec, i), _fixed_collate,
                                    batch_size=4, update_freq=update_freq, seed=1,
                                    sample_rng=(fn.get, fn.set))
        if state is not None:
            it.load_state_dict(state)
        return it

    def stream(it, n):
        out = []
        while len(out) < n:
            out.extend(it.next_epoch_itr())
        return out[:n]

    straight = make()
    full = stream(straight, 10)
    first = make()
    epochs = first.next_epoch_itr()
    got = []
    while len(got) < cut:
        try:
            got.append(next(epochs))
        except StopIteration:
            epochs = first.next_epoch_itr()
    state = first.state_dict()
    assert "rng" in state and "position" in state
    rest = stream(make(state), 10 - cut)
    _equal(got + rest, full)
