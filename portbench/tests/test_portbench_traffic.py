"""The traffic generators: the same seed gives the same inputs, every seed
the same lengths, at the lengths the traffic files state."""

import json
import os

import numpy as np
import torch

from conftest import GROUND, ROOT
from portbench import build
from portbench.kinds import serve, train


def _cfg():
    return json.load(open(os.path.join(ROOT, "portbench", "configs", "ofa_large.json")))


def _traffic(name, **change):
    t = json.load(open(os.path.join(ROOT, "portbench", "traffic", name + ".json")))
    t.update(change)
    return t


def test_serve_requests_repeat_by_seed():
    cfg = _cfg()
    t = _traffic("serve_caption", **dict(GROUND, pool=16, image_size=32))
    a = serve.Requests(t, cfg, 2 ** 31 + 5, 4, 0, 2)
    b = serve.Requests(t, cfg, 2 ** 31 + 5, 4, 0, 2)
    c = serve.Requests(t, cfg, 2 ** 31 + 6, 4, 0, 2)
    for i in range(20):
        ra, rb = a.record(i), b.record(i)
        assert np.array_equal(ra["img"], rb["img"]) and np.array_equal(ra["text"], rb["text"])
        assert a.src_ids(i) == b.src_ids(i)
    lo, hi = t["text_words"]
    lens = sorted(len(x) for x in a.texts)
    assert lens == sorted(len(x) for x in c.texts) and lo == lens[0] and hi == lens[-1]
    assert not np.array_equal(a.images, c.images)
    # the reference's source ids: bos, the template's bytes, the phrase, eos
    ids = a.src_ids(0)
    assert ids[0] == 0 and ids[-1] == 2 and a.src_len(0) == len(ids) + (32 // 16) ** 2


def test_caption_pool_is_images_at_the_stated_size():
    t = _traffic("serve_caption")
    r = serve.Requests(dict(t, pool=2), _cfg(), 3, 4, 0, 2)
    assert r.images.shape == (2, 480, 480, 3) and r.images.dtype == np.uint8 and r.texts is None


def test_train_ring_repeats_by_seed_at_the_stated_lengths():
    cfg = _cfg()
    t = _traffic("train_summ_long", samples_per_update=6, ring=4)
    d, gp = build.dictionary(cfg, ["text"])
    tc = gp.name2pre["text"].cfg
    tc.max_src_length, tc.max_tgt_length, tc.pad_to_multiple = 1024, 128, t["pad_multiple"]
    a = train.Ring(t, cfg, 2 ** 31 + 9, d, gp, "cpu")
    b = train.Ring(t, cfg, 2 ** 31 + 9, d, gp, "cpu")
    c = train.Ring(t, cfg, 2 ** 31 + 10, d, gp, "cpu")
    for k in range(4):
        for (s1, t1), (s2, t2) in zip(a.host[k], b.host[k]):
            assert np.array_equal(s1, s2) and np.array_equal(t1, t2)
        B, Ts, Tt = a.shapes(k)
        assert B == 6 and Ts % 128 == 0 and Tt == 128
        src, prev, target = a.reference_arrays(k, "cpu")
        dev_src = next(s for s in a.device[k]["net_input"]["slots"] if s.is_src).value["inputs"]
        assert torch.equal(src, dev_src) and torch.equal(target, a.device[k]["target"])
        for s_len, t_len in a.real(k):
            assert 512 <= s_len <= 1024 and 49 <= t_len <= 128
    assert sorted(a.tokens) == sorted(c.tokens)
    assert not all(np.array_equal(x[0], y[0]) for x, y in zip(a.host[0], c.host[0]))
