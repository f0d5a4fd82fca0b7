"""Joint image+box transforms (counterpart of ofasys_tpu/utils/transforms.py):
every op moves the image AND keeps the target boxes consistent, so
grounding/detection training can crop/resize/flip without corrupting
supervision.

Host-side numpy/PIL (PIL imported inside the functions that need it), the
same draws from the same ``np.random.Generator`` as ofasys_tpu, so images
and boxes come out bit for bit the same. Images are HWC float arrays
(0..255); boxes are (N, 4) float pixel coords [x0, y0, x1, y1].
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def _pil(arr: np.ndarray):
    from PIL import Image

    return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))


def resize(img: np.ndarray, boxes: Optional[np.ndarray], size: int,
           max_size: Optional[int] = None, square: bool = False):
    """Aspect-preserving resize of the short side to ``size`` (long side
    capped at max_size), or square resize; boxes scale accordingly."""
    h, w = img.shape[:2]
    if square:
        nh = nw = size
    else:
        scale = size / min(h, w)
        if max_size is not None and max(h, w) * scale > max_size:
            scale = max_size / max(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
    from PIL import Image

    out = np.asarray(_pil(img).resize((nw, nh), Image.BICUBIC), np.float32)
    if boxes is not None and len(boxes):
        boxes = boxes * np.asarray([nw / w, nh / h, nw / w, nh / h], np.float32)
    return out, boxes


def hflip(img: np.ndarray, boxes: Optional[np.ndarray]):
    """Horizontal flip; boxes mirror around the vertical axis."""
    w = img.shape[1]
    out = img[:, ::-1].copy()
    if boxes is not None and len(boxes):
        boxes = boxes.copy()
        x0 = boxes[:, 0].copy()
        boxes[:, 0] = w - boxes[:, 2]
        boxes[:, 2] = w - x0
    return out, boxes


def crop(img: np.ndarray, boxes: Optional[np.ndarray],
         region: Tuple[int, int, int, int], drop_empty: bool = True):
    """Crop region (y, x, h, w); boxes translate and clip; fully-cropped-out
    boxes are dropped when drop_empty."""
    y, x, h, w = region
    out = img[y:y + h, x:x + w].copy()
    if boxes is not None and len(boxes):
        boxes = boxes - np.asarray([x, y, x, y], np.float32)
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, w)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, h)
        if drop_empty:
            keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
            boxes = boxes[keep]
    return out, boxes


def center_crop(img: np.ndarray, boxes: Optional[np.ndarray], size: int):
    """Central ``size`` window (the whole side where the image is smaller)."""
    h, w = img.shape[:2]
    ch, cw = min(size, h), min(size, w)
    y = (h - ch) // 2
    x = (w - cw) // 2
    return crop(img, boxes, (y, x, ch, cw), drop_empty=False)


def object_center_crop(img: np.ndarray, boxes: np.ndarray, size: int):
    """Crop a ``size`` window positioned to KEEP the (first) object box fully
    visible when possible (visual grounding: a crop never loses the
    referred region)."""
    h, w = img.shape[:2]
    ch, cw = min(size, h), min(size, w)
    x0, y0, x1, y1 = boxes[0]
    # allowed crop origin so that the box stays inside the window
    x_lo = int(max(min(x0, w - cw), 0))
    x_hi = int(min(max(x1 - cw, 0), w - cw))
    y_lo = int(max(min(y0, h - ch), 0))
    y_hi = int(min(max(y1 - ch, 0), h - ch))
    x = min(x_lo, x_hi) + (abs(x_hi - x_lo) // 2)
    y = min(y_lo, y_hi) + (abs(y_hi - y_lo) // 2)
    return crop(img, boxes, (y, x, ch, cw), drop_empty=False)


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img, boxes):
        for t in self.transforms:
            img, boxes = t(img, boxes)
        return img, boxes


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5, rng: Optional[np.random.Generator] = None):
        self.p = p
        self.rng = rng or np.random.default_rng(0)

    def __call__(self, img, boxes):
        if self.rng.random() < self.p:
            return hflip(img, boxes)
        return img, boxes


class RandomResize:
    """Pick one of ``sizes`` for the short side."""

    def __init__(self, sizes: Sequence[int], max_size: Optional[int] = None,
                 rng: Optional[np.random.Generator] = None):
        self.sizes = list(sizes)
        self.max_size = max_size
        self.rng = rng or np.random.default_rng(0)

    def __call__(self, img, boxes):
        size = self.sizes[int(self.rng.integers(0, len(self.sizes)))]
        return resize(img, boxes, size, self.max_size)


class LargeScaleJitter:
    """Scale-jitter to output_size with box-consistent crop-or-pad."""

    def __init__(self, output_size: int = 512, aug_scale_min: float = 0.3,
                 aug_scale_max: float = 2.0, rng: Optional[np.random.Generator] = None):
        self.output_size = output_size
        self.smin, self.smax = aug_scale_min, aug_scale_max
        self.rng = rng or np.random.default_rng(0)

    def __call__(self, img, boxes):
        scale = float(self.rng.uniform(self.smin, self.smax))
        target = int(round(self.output_size * scale))
        img, boxes = resize(img, boxes, target, square=True)
        h, w = img.shape[:2]
        out = self.output_size
        if h > out:  # random crop back to output_size
            y = int(self.rng.integers(0, h - out + 1))
            x = int(self.rng.integers(0, w - out + 1))
            img, boxes = crop(img, boxes, (y, x, out, out), drop_empty=False)
        elif h < out:  # pad bottom-right
            padded = np.zeros((out, out, img.shape[2]), img.dtype)
            padded[:h, :w] = img
            img = padded
        return img, boxes
