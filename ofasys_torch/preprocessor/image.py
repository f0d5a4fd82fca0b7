"""Image preprocessor (counterpart of ofasys_tpu/preprocessor/image.py).

Host-side, PIL + numpy: loads from path / bytes / base64 / PIL / ndarray,
resizes to a fixed square, normalizes with mean/std, emits NHWC float32.
Train-time augmentation: random square crop + horizontal flip, then
RandAugment (``rand_augment``; utils/vision_helper.py), each from the
preprocessor's own ``rng`` in ofasys_tpu's order.

PIL is imported inside the functions that need it, and an ndarray that
already is ``size x size`` does not go through it: ``resize_image`` then
only truncates to uint8 as PIL's same-size resize (a copy) would, so the
result equals ofasys_tpu's bit for bit and such inputs need no PIL at all.
Remote image sources (http, https, oss) are fetched into the cache by
``utils/file_utils.cached_path`` (an oss:// source needs a registered
fetcher).
"""

from __future__ import annotations

import base64
import io
from dataclasses import dataclass
from typing import Any, List, Tuple

import numpy as np

from ofasys_torch.configure.config_store import register_config
from ofasys_torch.preprocessor.base import (
    BasePreprocess,
    CollateOutput,
    PreprocessConfig,
    PreprocessSkipException,
)
from ofasys_torch.preprocessor.instruction import Slot
from ofasys_torch.utils.file_utils import cached_path


@dataclass
class ImagePreprocessConfig(PreprocessConfig):
    patch_image_size: int = 224
    mean: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    std: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    interpolation: str = "bicubic"
    random_crop: bool = False
    random_flip: bool = False
    # RandAugment, applied on the train split only
    rand_augment: bool = False
    rand_augment_n: int = 2
    rand_augment_m: int = 9
    seed: int = 1


def load_image(value: Any):
    """Accept path / bytes / base64 str / PIL.Image / ndarray -> float32
    (H, W, 3) (an ndarray as it is)."""
    if isinstance(value, np.ndarray):
        return value.astype(np.float32)
    from PIL import Image

    if isinstance(value, Image.Image):
        img = value
    elif isinstance(value, bytes):
        img = Image.open(io.BytesIO(value))
    elif isinstance(value, str):
        if value.startswith(("http://", "https://", "oss://")):
            # a remote source through cached_path's scheme fetchers
            img = Image.open(cached_path(value))
        elif value.startswith("/") or value.startswith("./") or value.startswith("~"):
            img = Image.open(value)
        else:
            try:
                img = Image.open(io.BytesIO(base64.urlsafe_b64decode(value)))
            except Exception:
                try:
                    img = Image.open(io.BytesIO(base64.b64decode(value)))
                except Exception:
                    img = Image.open(value)
    else:
        raise PreprocessSkipException(f"cannot load image from {type(value)}")
    return np.asarray(img.convert("RGB"), dtype=np.float32)


def resize_image(arr: np.ndarray, size: int, interpolation: str = "bicubic") -> np.ndarray:
    """``arr`` truncated to uint8 and resized to (size, size) by PIL; an
    (size, size, 3) input skips PIL (its same-size resize is a copy)."""
    if arr.ndim == 3 and arr.shape == (size, size, 3):
        return arr.astype(np.uint8).astype(np.float32)
    from PIL import Image

    resample = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR, "nearest": Image.NEAREST}[interpolation]
    img = Image.fromarray(arr.astype(np.uint8))
    img = img.resize((size, size), resample)
    return np.asarray(img, dtype=np.float32)


@register_config("ofasys.preprocess", "image", ImagePreprocessConfig)
class ImagePreprocess(BasePreprocess):
    def __init__(self, global_dict, cfg: ImagePreprocessConfig):
        super().__init__(global_dict, cfg)
        self.rng = np.random.default_rng(cfg.seed)
        self._rand_augment = None
        if cfg.rand_augment:
            from ofasys_torch.utils.vision_helper import RandAugment

            self._rand_augment = RandAugment(cfg.rand_augment_n, cfg.rand_augment_m, rng=self.rng)

    def map(self, slot: Slot) -> Slot:
        if isinstance(slot.value, dict):
            return slot
        arr = load_image(slot.value)
        size = self.cfg.patch_image_size
        if slot.split == "train" and self.cfg.random_crop and min(arr.shape[:2]) > size:
            # random resized-crop-lite: random square crop then resize
            h, w = arr.shape[:2]
            s = int(min(h, w) * self.rng.uniform(0.7, 1.0))
            y = int(self.rng.integers(0, h - s + 1))
            x = int(self.rng.integers(0, w - s + 1))
            arr = arr[y:y + s, x:x + s]
        arr = resize_image(arr, size, self.cfg.interpolation)
        if slot.split == "train" and self.cfg.random_flip and self.rng.random() < 0.5:
            arr = arr[:, ::-1]
        if slot.split == "train" and self._rand_augment is not None:
            arr = self._rand_augment(arr)
        arr = arr / 255.0
        arr = (arr - np.asarray(self.cfg.mean, np.float32)) / np.asarray(self.cfg.std, np.float32)
        slot.value = {"inputs": arr.astype(np.float32)}
        return slot

    def collate(self, slots: List[Slot]) -> CollateOutput:
        images = np.stack([s.value["inputs"] for s in slots])  # (B, H, W, 3)
        return CollateOutput(self.to_slot_batch(slots[0], {"inputs": images}))


@dataclass
class ImagenetPreprocessConfig(ImagePreprocessConfig):
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    random_crop: bool = True
    random_flip: bool = True


@register_config("ofasys.preprocess", "imagenet", ImagenetPreprocessConfig)
class ImagenetPreprocess(ImagePreprocess):
    """ImageNet-normalized variant (registered as 'imagenet')."""


@dataclass
class ImagepretrainPreprocessConfig(ImagePreprocessConfig):
    pass


@register_config("ofasys.preprocess", "imagepretrain", ImagepretrainPreprocessConfig)
class ImagepretrainPreprocess(ImagePreprocess):
    """Third registration of the image preprocessor ('imagepretrain')."""
