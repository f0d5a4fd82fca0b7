"""Motion (text-to-motion diffusion) preprocessor (counterpart of
ofasys_tpu/preprocessor/motion.py).

BVH mocap -> (T, 3+J*6) continuous features, a fixed window (a random
crop on the train split, from the preprocessor's own numpy generator),
feature-space standardization and the diffusion clamp; ``decode`` writes
BVH again through the header of the first parsed file. Host-side numpy,
the same operations in the same order as ofasys_tpu's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from ofasys_torch.configure.config_store import register_config
from ofasys_torch.preprocessor.base import BasePreprocess, CollateOutput, PreprocessConfig
from ofasys_torch.preprocessor.instruction import Slot
from ofasys_torch.utils.motion_utils import (
    BvhHeader,
    bvh_to_features,
    features_to_bvh,
    parse_bvh,
    save_bvh,
)


@dataclass
class MotionPreprocessConfig(PreprocessConfig):
    window_size: int = 64       # fixed clip length (frames)
    feature_clip: float = 5.0   # clamp range for diffusion outputs
    seed: int = 1


@register_config("ofasys.preprocess", "motion_6d", MotionPreprocessConfig)
class MotionPreprocess(BasePreprocess):
    def __init__(self, global_dict, cfg: MotionPreprocessConfig):
        super().__init__(global_dict, cfg)
        self.rng = np.random.default_rng(cfg.seed)
        self.header: Optional[BvhHeader] = None
        self.feat_dim: Optional[int] = None
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    def to_features(self, value: Any) -> np.ndarray:
        """A (T, F) feature array, BVH text or a BVH path -> features,
        standardized once ``set_normalization`` has run."""
        if isinstance(value, np.ndarray):
            feats = value.astype(np.float32)
        else:
            text = value
            if isinstance(value, str) and "\n" not in value:
                with open(value) as f:
                    text = f.read()
            header, frames = parse_bvh(text)
            if self.header is None:
                self.header = header
            feats = bvh_to_features(header, frames)
        if self.feat_dim is None:
            self.feat_dim = feats.shape[-1]
        if self.mean is not None:
            feats = (feats - self.mean) / self.std
        return feats

    def set_normalization(self, mean: np.ndarray, std: np.ndarray):
        self.mean = mean.astype(np.float32)
        self.std = np.maximum(std.astype(np.float32), 1e-6)

    def map(self, slot: Slot) -> Slot:
        W = self.cfg.window_size
        if not slot.is_src and slot.value is None:
            # open diffusion target at inference: a shape-only placeholder
            dim = self.feat_dim or 3
            slot.value = {"value": np.zeros((W, dim), np.float32),
                          "masks": np.ones((W,), bool)}
            return slot
        if isinstance(slot.value, dict) and "value" in slot.value:
            return slot
        feats = self.to_features(slot.value)
        T = feats.shape[0]
        if T >= W:
            start = int(self.rng.integers(0, T - W + 1)) if slot.split == "train" else 0
            clip = feats[start:start + W]
            masks = np.ones((W,), bool)
        else:
            clip = np.concatenate([feats, np.zeros((W - T, feats.shape[1]), np.float32)])
            masks = np.arange(W) < T
        slot.value = {"value": clip, "masks": masks}
        return slot

    def collate(self, slots: List[Slot]) -> CollateOutput:
        value = np.stack([s.value["value"] for s in slots])   # (B, W, F)
        masks = np.stack([s.value["masks"] for s in slots])   # (B, W) True = valid
        sb = self.to_slot_batch(slots[0], {"value": value, "masks": masks})
        if slots[0].is_src:
            return CollateOutput(sb)
        extra = {"target": value, "target_masks": masks,
                 "ntokens": int(masks.sum())}
        return CollateOutput(sb, sb, extra)

    def clamp(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(x, -self.cfg.feature_clip, self.cfg.feature_clip)

    def decode(self, feature: np.ndarray, **kwargs):
        if self.mean is not None:
            feature = feature * self.std + self.mean
        if self.header is None:
            return feature
        frames = features_to_bvh(self.header, feature)
        return save_bvh(self.header, frames)

    def postprocess(self, outputs, sample):
        for out in outputs if isinstance(outputs, list) else [outputs]:
            if getattr(out, "feature", None) is not None:
                out.bvh = self.decode(np.asarray(out.feature))
        return outputs
