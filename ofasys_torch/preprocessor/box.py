"""Box (bounding box) preprocessor (counterpart of ofasys_tpu/preprocessor/box.py).

Subclasses TextPreprocess, as ofasys_tpu's does: a box becomes 4 quantized
``<bin>_i`` tokens which then flow through the text group machinery
(bos/eos wrap, merging with adjacent text slots, teacher-forcing collate).
decode reverses the quantization.

Accepted values: dict {"box": [x0,y0,x1,y1], "width": W, "height": H}
(pixel coords) or a 4-vector of normalized [0,1] coords.

On the train split, ``instruction_map`` flips, resizes and object-centre
crops the IMAGE slot and the BOX slot(s) together (utils/transforms.py),
from the preprocessor's own generator, so the supervision stays on the
referred region.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ofasys_torch import ModalityType
from ofasys_torch.configure.config_store import register_config
from ofasys_torch.preprocessor.base import PreprocessSkipException
from ofasys_torch.preprocessor.instruction import Instruction, Slot
from ofasys_torch.preprocessor.text import TextPreprocess, TextPreprocessConfig
from ofasys_torch.utils import transforms as T

# patch_image_size when the slot's image preprocess has none
FALLBACK_IMAGE_SIZE = 224


@dataclass
class BoxPreprocessConfig(TextPreprocessConfig):
    num_bins: int = 1000
    # joint image+box train-time transforms (flip / resize / object-centre crop)
    train_transforms: bool = True
    resize_scales: tuple = (0.8, 0.9, 1.0, 1.1, 1.2)


@register_config("ofasys.preprocess", "box", BoxPreprocessConfig)
class BoxPreprocess(TextPreprocess):
    def __init__(self, global_dict, cfg: BoxPreprocessConfig):
        super().__init__(global_dict, cfg)
        self.bin_start, self.bin_end = global_dict.add_namespace("<bin>", cfg.num_bins)
        self._trng = np.random.default_rng(cfg.seed)

    # ------------------------------------------------------------- encoding
    def encode_box(self, box: np.ndarray) -> np.ndarray:
        """Normalized [0,1] coords -> 4 dictionary token ids (rounded in fp64)."""
        n = self.cfg.num_bins - 1
        bins = np.clip(np.round(np.asarray(box, np.float64) * n), 0, n).astype(np.int64)
        return (bins + self.bin_start).astype(np.int32)

    def decode(self, tokens: np.ndarray, width: Optional[float] = None,
               height: Optional[float] = None, **kwargs) -> np.ndarray:
        """Token ids -> normalized (or pixel, given dims) [x0,y0,x1,y1]."""
        toks = np.asarray(tokens).reshape(-1)
        bins = [int(t) - self.bin_start for t in toks
                if self.bin_start <= int(t) < self.bin_end][:4]
        coords = np.asarray(bins, np.float32) / (self.cfg.num_bins - 1)
        if len(coords) == 4 and width is not None and height is not None:
            coords = coords * np.asarray([width, height, width, height], np.float32)
        return coords

    # ------------------------------------------------------------------ map
    def map(self, slot: Slot) -> Slot:
        if not slot.is_src and slot.value is None:
            return self.dummy_slot(slot)
        v = slot.value
        if isinstance(v, dict) and "inputs" in v:
            return slot
        if isinstance(v, dict):
            box = np.asarray(v["box"], np.float32)
            w, h = float(v.get("width", 1.0)), float(v.get("height", 1.0))
            box = box / np.asarray([w, h, w, h], np.float32)
        else:
            box = np.asarray(v, np.float32)
            if box.max() > 1.0:
                raise PreprocessSkipException(
                    "box coords > 1 need explicit width/height (pass a dict)"
                )
        if box.shape != (4,):
            raise PreprocessSkipException(f"box must have 4 coords, got {box.shape}")
        slot.value = self.encode_box(np.clip(box, 0.0, 1.0))
        return TextPreprocess.map(self, slot)

    def instruction_map(self, ist: Instruction) -> Instruction:
        """Whole-instruction hook: flip/resize/crop the IMAGE slot and the
        BOX slot(s) jointly on the train split."""
        from ofasys_torch.preprocessor.image import load_image

        if not self.cfg.train_transforms:
            return ist
        img_slots = [s for s in ist.slots
                     if s.modality == ModalityType.IMAGE and s.is_src
                     and s.value is not None and not isinstance(s.value, dict)]
        box_slots = [s for s in ist.slots
                     if s.modality == ModalityType.BOX and s.value is not None
                     and not (isinstance(s.value, dict) and "inputs" in s.value)]
        if not img_slots or not box_slots:
            return ist
        if (img_slots[0].split or "train") != "train":
            return ist
        img = load_image(img_slots[0].value)
        h, w = img.shape[:2]
        boxes = []
        for s in box_slots:
            v = s.value
            if isinstance(v, dict):
                bw, bh = float(v.get("width", w)), float(v.get("height", h))
                b = np.asarray(v["box"], np.float32)
                if bw != w or bh != h:  # rescale declared dims to pixels
                    b = b * np.asarray([w / bw, h / bh, w / bw, h / bh], np.float32)
            else:
                b = np.asarray(v, np.float32) * np.asarray([w, h, w, h], np.float32)
            boxes.append(b)
        boxes = np.stack(boxes)

        size = self._patch_image_size(img_slots[0])
        scales = [max(8, int(round(size * r))) for r in self.cfg.resize_scales]
        pipeline = T.Compose([
            T.RandomHorizontalFlip(0.5, rng=self._trng),
            T.RandomResize(scales, rng=self._trng),
        ])
        img, boxes = pipeline(img, boxes)
        img, boxes = T.object_center_crop(img, boxes, size)

        img_slots[0].value = img
        ch, cw = img.shape[:2]
        for s, b in zip(box_slots, boxes):
            s.value = {"box": b.tolist(), "width": float(cw), "height": float(ch)}
        return ist

    @staticmethod
    def _patch_image_size(img_slot: Slot) -> int:
        """The crop size: the ``patch_image_size`` of the config the
        ConfigStore holds for the image slot's preprocess (a preprocessor's
        tuned, deep-copied config does not change it), FALLBACK_IMAGE_SIZE
        where the store has no such node."""
        from ofasys_torch.configure.config_store import ConfigStore
        from ofasys_torch.preprocessor.general import DEFAULT_PREPROCESS

        name = img_slot.get_attr("preprocess") or DEFAULT_PREPROCESS[ModalityType.IMAGE]
        try:
            return int(ConfigStore().get("ofasys.preprocess", name).config.patch_image_size)
        except Exception:
            return FALLBACK_IMAGE_SIZE

    def postprocess(self, outputs, sample):
        for out in outputs if isinstance(outputs, list) else [outputs]:
            if getattr(out, "tokens", None) is not None:
                out.box = self.decode(out.tokens)
        return outputs
