"""ofasys_torch's host-side image transforms against ofasys_tpu's: the joint
image + box transforms (utils/transforms.py), every RandAugment op and
RandAugment itself (utils/vision_helper.py), and the image preprocessor
with ``rand_augment=True``.

Everything here is numpy + PIL on both sides: images and boxes must come
out bit for bit the same from the same ``np.random.Generator`` (and, for
the RandAugment ops that draw a sign or a position, the same global numpy
seed, as ofasys_tpu draws them from ``np.random``).
"""

import numpy as np
import pytest

from ofasys_tpu import ModalityType as JModality
from ofasys_tpu.preprocessor import image as jpimage
from ofasys_tpu.preprocessor.instruction import Slot as JSlot
from ofasys_tpu.utils import transforms as JT
from ofasys_tpu.utils import vision_helper as jvh
from ofasys_torch import ModalityType
from ofasys_torch.preprocessor import image as tpimage
from ofasys_torch.preprocessor.instruction import Slot
from ofasys_torch.utils import transforms as TT
from ofasys_torch.utils import vision_helper as tvh


def _image(rng, h, w):
    return rng.integers(0, 256, (h, w, 3)).astype(np.float32)


def _boxes(rng, h, w, n=3):
    x0 = rng.uniform(0, w * 0.6, n)
    y0 = rng.uniform(0, h * 0.6, n)
    x1 = x0 + rng.uniform(4, w * 0.4, n)
    y1 = y0 + rng.uniform(4, h * 0.4, n)
    return np.stack([x0, y0, x1, y1], 1).astype(np.float32)


def _equal(a, b):
    (ia, ba), (ib, bb) = a, b
    assert ia.dtype == ib.dtype and ia.shape == ib.shape
    np.testing.assert_array_equal(ia, ib)
    if ba is None:
        assert bb is None
    else:
        assert ba.dtype == bb.dtype
        np.testing.assert_array_equal(ba, bb)


# ------------------------------------------------------------- transforms
@pytest.mark.parametrize("case", ["resize", "resize_max", "resize_square", "resize_no_boxes",
                                  "hflip", "crop", "crop_keep_empty", "center_crop",
                                  "center_crop_small", "object_center_crop",
                                  "object_center_crop_big_box"])
def test_transform_is_bit_equal(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    img = _image(rng, 37, 53)
    boxes = _boxes(rng, 37, 53)
    kw = {}
    if case == "resize":
        args, fn = (img, boxes, 24), "resize"
    elif case == "resize_max":
        args, kw, fn = (img, boxes, 40), dict(max_size=48), "resize"
    elif case == "resize_square":
        args, kw, fn = (img, boxes, 29), dict(square=True), "resize"
    elif case == "resize_no_boxes":
        args, fn = (img, None, 31), "resize"
    elif case == "hflip":
        args, fn = (img, boxes), "hflip"
    elif case == "crop":
        boxes[0] = [0, 0, 3, 3]                 # cropped out entirely: dropped
        args, fn = (img, boxes, (5, 7, 20, 30)), "crop"
    elif case == "crop_keep_empty":
        boxes[0] = [0, 0, 3, 3]
        args, kw, fn = (img, boxes, (5, 7, 20, 30)), dict(drop_empty=False), "crop"
    elif case == "center_crop":
        args, fn = (img, boxes, 24), "center_crop"
    elif case == "center_crop_small":
        args, fn = (img, boxes, 45), "center_crop"
    elif case == "object_center_crop":
        args, fn = (img, boxes, 24), "object_center_crop"
    else:
        boxes[0] = [2, 3, 50, 35]               # larger than the window
        args, fn = (img, boxes, 24), "object_center_crop"
    want = getattr(JT, fn)(*[a.copy() if isinstance(a, np.ndarray) else a for a in args], **kw)
    got = getattr(TT, fn)(*[a.copy() if isinstance(a, np.ndarray) else a for a in args], **kw)
    _equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_transforms_are_bit_equal(seed):
    """Compose(RandomHorizontalFlip, RandomResize) and LargeScaleJitter from
    generators with the same seed, several calls each, and the generators'
    states after."""
    rng = np.random.default_rng(100 + seed)
    imgs = [_image(rng, int(rng.integers(20, 60)), int(rng.integers(20, 60))) for _ in range(4)]
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    jpipe = JT.Compose([JT.RandomHorizontalFlip(0.5, rng=jr), JT.RandomResize([16, 24, 32], 40, rng=jr),
                        JT.LargeScaleJitter(28, 0.5, 1.5, rng=jr)])
    tpipe = TT.Compose([TT.RandomHorizontalFlip(0.5, rng=tr), TT.RandomResize([16, 24, 32], 40, rng=tr),
                        TT.LargeScaleJitter(28, 0.5, 1.5, rng=tr)])
    for img in imgs:
        boxes = _boxes(rng, *img.shape[:2])
        _equal(tpipe(img.copy(), boxes.copy()), jpipe(img.copy(), boxes.copy()))
    assert tr.random() == jr.random()


# ------------------------------------------------------------ RandAugment
@pytest.mark.parametrize("op", sorted(jvh.OPS))
@pytest.mark.parametrize("level", [0, 9, 30])
def test_rand_augment_op_is_bit_equal(op, level):
    assert sorted(tvh.OPS) == sorted(jvh.OPS)
    img = _image(np.random.default_rng(3), 24, 31)
    np.random.seed(level)
    want = jvh.OPS[op](img.copy(), level)
    np.random.seed(level)
    got = tvh.OPS[op](img.copy(), level)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,m", [(2, 9), (3, 20)])
def test_rand_augment_is_bit_equal(n, m):
    rng = np.random.default_rng(4)
    imgs = [_image(rng, 32, 32) for _ in range(6)]
    ja = jvh.RandAugment(n, m, rng=np.random.default_rng(7))
    ta = tvh.RandAugment(n, m, rng=np.random.default_rng(7))
    np.random.seed(11)
    want = [ja(im.copy()) for im in imgs]
    np.random.seed(11)
    got = [ta(im.copy()) for im in imgs]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("split", ["train", "test"])
def test_image_preprocess_rand_augment_is_bit_equal(split):
    """``rand_augment=True`` applies RandAugment from the preprocessor's own
    generator on the train split only, after the crop and flip."""
    cfg = dict(patch_image_size=32, rand_augment=True, rand_augment_n=2, rand_augment_m=9,
               random_crop=True, random_flip=True, seed=5)
    jpre = jpimage.ImagePreprocess(None, jpimage.ImagePreprocessConfig(**cfg))
    tpre = tpimage.ImagePreprocess(None, tpimage.ImagePreprocessConfig(**cfg))
    rng = np.random.default_rng(6)
    for _ in range(4):
        value = _image(rng, 48, 40)
        np.random.seed(2)
        js = jpre.map(JSlot(JModality.IMAGE, True, value=value.copy(), column_name="img", split=split))
        np.random.seed(2)
        ts = tpre.map(Slot(ModalityType.IMAGE, True, value=value.copy(), column_name="img", split=split))
        np.testing.assert_array_equal(ts.value["inputs"], js.value["inputs"])
    assert tpre.rng.random() == jpre.rng.random()
