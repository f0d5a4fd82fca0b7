"""RandAugment (counterpart of ofasys_tpu/utils/vision_helper.py: the
public RandAugment recipe from Cubuk et al., arXiv:1909.13719) built on
PIL's ImageOps/ImageEnhance, imported inside the ops.

Operates on HWC float arrays (0..255); each call picks N random ops from
its ``rng`` and applies them at magnitude M (0..30 scale, standard
convention). As in ofasys_tpu, the signs of the geometric ops and the
cutout position come from numpy's global generator (``np.random``), so the
same ``rng`` and the same global seed give the same pixels bit for bit.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

MAX_LEVEL = 30


def _pil(arr):
    from PIL import Image

    return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))


def _np(img):
    return np.asarray(img, np.float32)


def _enhance(kind: str, arr, level: float):
    from PIL import ImageEnhance

    factor = 0.1 + 1.8 * level / MAX_LEVEL  # 0.1 .. 1.9
    enh = getattr(ImageEnhance, kind)(_pil(arr))
    return _np(enh.enhance(factor))


def autocontrast(arr, level):
    from PIL import ImageOps

    return _np(ImageOps.autocontrast(_pil(arr)))


def equalize(arr, level):
    from PIL import ImageOps

    return _np(ImageOps.equalize(_pil(arr)))


def invert(arr, level):
    return 255.0 - arr


def rotate(arr, level):
    from PIL import Image

    deg = 30.0 * level / MAX_LEVEL
    if np.random.random() < 0.5:
        deg = -deg
    return _np(_pil(arr).rotate(deg, resample=Image.BILINEAR, fillcolor=(128, 128, 128)))


def solarize(arr, level):
    from PIL import ImageOps

    thresh = int(256 - 256 * level / MAX_LEVEL)
    return _np(ImageOps.solarize(_pil(arr), thresh))


def posterize(arr, level):
    from PIL import ImageOps

    bits = max(1, int(8 - 4 * level / MAX_LEVEL))
    return _np(ImageOps.posterize(_pil(arr), bits))


def color(arr, level):
    return _enhance("Color", arr, level)


def contrast(arr, level):
    return _enhance("Contrast", arr, level)


def brightness(arr, level):
    return _enhance("Brightness", arr, level)


def sharpness(arr, level):
    return _enhance("Sharpness", arr, level)


def _affine(arr, coeffs):
    from PIL import Image

    img = _pil(arr)
    return _np(img.transform(img.size, Image.AFFINE, coeffs,
                             resample=Image.BILINEAR, fillcolor=(128, 128, 128)))


def shear_x(arr, level):
    f = 0.3 * level / MAX_LEVEL
    if np.random.random() < 0.5:
        f = -f
    return _affine(arr, (1, f, 0, 0, 1, 0))


def shear_y(arr, level):
    f = 0.3 * level / MAX_LEVEL
    if np.random.random() < 0.5:
        f = -f
    return _affine(arr, (1, 0, 0, f, 1, 0))


def translate_x(arr, level):
    off = int(arr.shape[1] / 3 * level / MAX_LEVEL)
    if np.random.random() < 0.5:
        off = -off
    return _affine(arr, (1, 0, off, 0, 1, 0))


def translate_y(arr, level):
    off = int(arr.shape[0] / 3 * level / MAX_LEVEL)
    if np.random.random() < 0.5:
        off = -off
    return _affine(arr, (1, 0, 0, 0, 1, off))


def cutout(arr, level):
    size = int(min(arr.shape[:2]) / 4 * level / MAX_LEVEL)
    if size == 0:
        return arr
    h, w = arr.shape[:2]
    y = np.random.randint(0, h)
    x = np.random.randint(0, w)
    out = arr.copy()
    out[max(0, y - size):y + size, max(0, x - size):x + size] = 128.0
    return out


OPS: Dict[str, Callable] = {
    "AutoContrast": autocontrast,
    "Equalize": equalize,
    "Invert": invert,
    "Rotate": rotate,
    "Solarize": solarize,
    "Posterize": posterize,
    "Color": color,
    "Contrast": contrast,
    "Brightness": brightness,
    "Sharpness": sharpness,
    "ShearX": shear_x,
    "ShearY": shear_y,
    "TranslateX": translate_x,
    "TranslateY": translate_y,
    "Cutout": cutout,
}


class RandAugment:
    """Apply N randomly-chosen ops at magnitude M per image."""

    def __init__(self, n: int = 2, m: int = 9,
                 ops: Optional[List[str]] = None,
                 rng: Optional[np.random.Generator] = None):
        self.n = n
        self.m = m
        self.ops = ops or list(OPS)
        self.rng = rng or np.random.default_rng(0)

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        names = self.rng.choice(self.ops, size=self.n, replace=True)
        for name in names:
            arr = OPS[name](arr, self.m)
        return arr
