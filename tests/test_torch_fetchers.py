"""Sources through registered fetchers in the port against ofasys_tpu's:
utils/file_utils (``register_scheme_fetcher``, ``cached_path``),
io/reader/object_store, io/reader/streaming and the ``.bin`` and
``scheme://`` branches of ``Task.load_dataset_from_path``.

No test reaches a network: a fetcher for the test scheme ``testfs://``
copies a local file, and streams read local file handles or in-memory
bytes. Every comparison is exact (names, bytes, records, lines).
"""

import io
import json
import os
import threading
import time

import numpy as np
import pytest

from ofasys_tpu.io.reader import object_store as jstore, streaming as jstream
from ofasys_tpu.utils import file_utils as jfu
from ofasys_torch import Task
from ofasys_torch.io.reader import object_store as tstore, streaming as tstream
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.utils import file_utils as tfu

SIDES = (("ofasys_tpu", jfu, jstore, jstream), ("ofasys_torch", tfu, tstore, tstream))


def _copy_fetcher(root, calls):
    """fetch(url, dest) for testfs://<path under root>."""
    def fetch(url, dest):
        calls.append(url)
        with open(os.path.join(root, url[len("testfs://"):]), "rb") as src, open(dest, "wb") as out:
            out.write(src.read())
    return fetch


@pytest.fixture
def testfs(tmp_path, monkeypatch):
    """A local directory served as testfs:// by both packages, each with its
    own cache under a temporary $OFA_CACHE_HOME."""
    root = tmp_path / "bucket"
    root.mkdir()
    calls = {}
    for name, fu, _, _ in SIDES:
        calls[name] = []
        monkeypatch.setitem(fu._SCHEME_FETCHERS, "testfs", _copy_fetcher(str(root), calls[name]))
    return root, calls


def _cache(tmp_path, monkeypatch, name):
    d = tmp_path / f"cache_{name}"
    monkeypatch.setenv("OFA_CACHE_HOME", str(d))
    return d


def test_cached_path_names_and_sidecar_equal_ofasys_tpu(testfs, tmp_path, monkeypatch):
    root, calls = testfs
    (root / "dir").mkdir()
    (root / "dir" / "a.tsv").write_bytes(b"x\ty\n1\t2\n")
    url = "testfs://dir/a.tsv?version=3"
    (root / "dir" / "a.tsv?version=3").write_bytes(b"x\ty\n1\t2\n")
    got = {}
    for name, fu, _, _ in SIDES:
        cache = _cache(tmp_path, monkeypatch, name)
        path = fu.cached_path(url)
        assert fu.cached_path(url) == path and calls[name] == [url]   # fetched once
        assert os.path.dirname(path) == str(cache)
        listing = sorted(p for p in os.listdir(cache) if not p.endswith(".lock"))
        got[name] = (os.path.basename(path), open(path, "rb").read(), listing,
                     json.load(open(path + ".json")))
        # local paths and file:// URLs come back as they are
        assert fu.cached_path(str(root / "dir" / "a.tsv")) == str(root / "dir" / "a.tsv")
        assert fu.cached_path("file:///no/such/file") == "/no/such/file"
        with pytest.raises(FileNotFoundError):
            fu.cached_path(str(tmp_path / "missing.tsv"))
        with pytest.raises(ValueError, match="no fetcher for scheme 'nofetch'"):
            fu.cached_path("nofetch://bucket/x.tsv")
    assert got["ofasys_torch"] == got["ofasys_tpu"]
    assert got["ofasys_torch"][0].endswith(".a.tsv") and got["ofasys_torch"][3] == {"url": url}


def test_object_store_readers_equal_ofasys_tpu(testfs, tmp_path, monkeypatch):
    root, _ = testfs
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 50_000, size=10 * 64 + 17).astype(np.int32)
    ids.tofile(root / "tokens.bin")
    lines = [f"{i}\t{'w' * int(rng.integers(0, 40))}" for i in range(40)] + ["", "ünïcode\tlast"]
    (root / "rows.tsv").write_text("\n".join(lines) + "\n", encoding="utf-8")
    out = {}
    for name, _, store, _ in SIDES:
        _cache(tmp_path, monkeypatch, name)
        bins = [store.OssTextBinReader(src, block_tokens=64)
                for src in ("testfs://tokens.bin", str(root / "tokens.bin"))]
        recs = [[r.read(i).tolist() for i in range(len(r))] for r in bins]
        assert recs[0] == recs[1] and len(recs[0]) == 10
        assert recs[0] == ids[:640].reshape(10, 64).tolist()
        injected = store.OssTextBinReader("anything://x.bin", block_tokens=64,
                                          fetcher=lambda url: str(root / "tokens.bin"))
        assert len(injected) == 10 and injected.read(9).tolist() == recs[0][9]
        lr = store.ObjectStoreLineReader("testfs://rows.tsv")
        streamed = list(lr.iter_lines(lambda url: open(root / url[len("testfs://"):], "rb"),
                                      chunk_bytes=7, max_chunks=2))
        out[name] = ([lr.read(i) for i in range(len(lr))], streamed, recs[0])
        with pytest.raises(ImportError, match="ODPS client"):
            store.OdpsReader("project.table")

        class Client:
            def count(self):
                return 2

            def read(self, i):
                return {"a": i, "b": -i, "c": "x"}

        odps = store.OdpsReader("project.table", client=Client(), selected_cols=["b", "a"])
        assert len(odps) == 2 and odps.read(1) == {"b": -1, "a": 1}
    assert out["ofasys_torch"] == out["ofasys_tpu"]
    assert out["ofasys_torch"][0] == lines == out["ofasys_torch"][1]


class _Source:
    """A byte source that reads ``data`` in pieces, optionally raising
    after ``fail_after`` reads, and records whether it was closed."""

    def __init__(self, data, fail_after=None):
        self._f = io.BytesIO(data)
        self.reads = 0
        self.fail_after = fail_after
        self.closed = False

    def read(self, n):
        self.reads += 1
        if self.fail_after is not None and self.reads > self.fail_after:
            raise OSError("connection reset")
        return self._f.read(n)

    def close(self):
        self.closed = True


@pytest.mark.parametrize("data", [b"alpha\nbeta\n\ngamma-delta-epsilon\nz", b"a\n\n", b"",
                                  b"\n" * 5, b"one line without a terminator"])
def test_streaming_lines_equal_ofasys_tpu(data):
    out = {}
    for name, _, _, stream in SIDES:
        got = []
        for chunk, depth in ((1, 1), (3, 2), (1 << 16, 16)):
            with stream.StreamingLineReader(_Source(data), chunk_bytes=chunk, max_chunks=depth) as r:
                got.append(list(r))
            r = stream.StreamingLineReader(_Source(data), chunk_bytes=chunk, prefetch=False)
            got.append([r.readn(4), r.readline(), r.readn(100)])
        p = stream.PrefetchByteStream(_Source(data), chunk_bytes=2, max_chunks=1)
        got.append([p.read(3), p.read(0), p.read(-1), p.read(5)])
        out[name] = got
    assert out["ofasys_torch"] == out["ofasys_tpu"]
    assert out["ofasys_torch"][0] == data.split(b"\n")[:-1] + ([data.split(b"\n")[-1]]
                                                               if data.split(b"\n")[-1] else [])


def test_streaming_errors_and_abandoned_producer_equal_ofasys_tpu():
    out = {}
    for name, _, _, stream in SIDES:
        # an error of the source reaches the consumer after the lines before it
        r = stream.StreamingLineReader(_Source(b"a\nb\nc\nd\n", fail_after=2), chunk_bytes=2,
                                       max_chunks=4)
        got = []
        with pytest.raises(OSError, match="connection reset"):
            for line in r:
                got.append(line)
        # an abandoned stream: the producer blocks on its full queue until
        # close(), which ends it and closes the source
        src = _Source(b"x\n" * 10_000)
        before = threading.active_count()
        p = stream.PrefetchByteStream(src, chunk_bytes=4, max_chunks=2)
        first = p.read(4)
        time.sleep(0.2)
        alive = p._thread.is_alive()
        p.close()
        p._thread.join(timeout=2.0)
        out[name] = (got, first, alive, p._thread.is_alive(), src.closed, p.read(10))
        assert threading.active_count() <= before + 1
    assert out["ofasys_torch"] == out["ofasys_tpu"]
    assert out["ofasys_torch"] == ([b"a", b"b"], b"x\nx\n", True, False, True, b"")


def _batches(task, split):
    it = task.get_batch_iterator(split, seed=3)
    it.prefetch = 0
    epoch = it.next_epoch_itr()
    try:
        return [{k: v for k, v in b.items() if k != "net_input"} | {
            "slots": [np.asarray(s.value["inputs"]) for s in b["net_input"]["slots"]]}
            for b in epoch]
    finally:
        epoch.close()


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], list):
                for u, v in zip(x[k], y[k], strict=True):
                    np.testing.assert_array_equal(u, v)
            else:
                np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))


def test_task_reads_fetched_and_bin_sources(testfs, tmp_path, monkeypatch):
    root, calls = testfs
    _cache(tmp_path, monkeypatch, "task")
    rng = np.random.default_rng(1)
    words = ["storm", "north", "coast", "monday", "rain", "wind", "the", "a"]
    (root / "rows.tsv").write_text("".join(
        f"{' '.join(rng.choice(words, 6))}\t{' '.join(rng.choice(words, 3))}\n" for _ in range(12)))
    runs = []
    for src in (str(root / "rows.tsv"), "testfs://rows.tsv"):
        t = Task(name="summary", instruction="[TEXT:src] -> [TEXT:tgt]")
        t.cfg.dataset.batch_size = 4
        t.cfg.dataset.selected_cols = "0:src,1:tgt"
        t.cfg.dataset.num_workers = 0
        t.initialize(Dictionary())
        t.load_dataset_from_path(src, split="train").load_dataset_from_path(src, split="valid")
        runs.append({split: _batches(t, split) for split in ("train", "valid")})
    assert calls["ofasys_torch"] == ["testfs://rows.tsv"]
    for split in ("train", "valid"):
        _same(runs[0][split], runs[1][split])
    ids = rng.integers(0, 1000, size=3 * 16 + 5).astype(np.int32)
    ids.tofile(root / "lm.bin")
    t = Task(name="lm", instruction="[TEXT:src] -> [TEXT:tgt]")
    t.cfg.dataset.text_bin_length = 16
    t.initialize(Dictionary())
    for src in (str(root / "lm.bin"), "testfs://lm.bin"):
        reader = t.load_dataset_from_path(src, split="valid").datasets["valid"]
        assert [reader.read(i).tolist() for i in range(len(reader))] == ids[:48].reshape(3, 16).tolist()
