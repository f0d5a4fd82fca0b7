"""Batch containers (counterpart of ofasys_tpu/utils/pytree.py).

:class:`SlotBatch` is a plain dataclass: ``value`` holds the slot's arrays
(numpy after collate, tensors once the generator moves them to the
model's device); everything else is metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ofasys_torch import ModalityType


@dataclasses.dataclass
class SlotBatch:
    """Batched, collated data for one slot of an instruction template."""

    modality: ModalityType
    is_src: bool
    value: Any = None
    column_name: Optional[str] = None
    attributes: Optional[Tuple[str, ...]] = None
    preprocess: Optional[str] = None
    adaptor_name: Optional[str] = None
    split: str = "train"

    # Attr helpers mirror Slot (instruction.py) so adaptors can treat both alike.
    def has_attr(self, key: str) -> bool:
        if not self.attributes:
            return False
        return any(a == key or a.startswith(key + "=") for a in self.attributes)

    def get_attr(self, key: str, class_factory: Optional[type] = None):
        if not self.attributes:
            return None
        prefix = key + "="
        for a in self.attributes:
            if a.startswith(prefix):
                v = a[len(prefix):]
                return class_factory(v) if class_factory is not None else v
        return None

    @staticmethod
    def target_slot(slots: List["SlotBatch"]) -> "SlotBatch":
        return [s for s in slots if not s.is_src][-1]

    @staticmethod
    def source_slots(slots: List["SlotBatch"]) -> List["SlotBatch"]:
        return [s for s in slots if s.is_src]


def slots_to_device(slots: List[SlotBatch], device) -> List[SlotBatch]:
    """Copies of ``slots`` whose array values are tensors on ``device``:
    integer arrays become int64 tensors (token ids, lengths), boolean masks
    stay boolean, float arrays (images, fbank frames, motion features)
    keep their dtype and are cast to the compute dtype in the adaptor."""
    def conv(v):
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(v))
            if not t.is_floating_point() and t.dtype != torch.bool:
                t = t.long()
            return t.to(device)
        if isinstance(v, torch.Tensor):
            return v.to(device)
        return v

    return [dataclasses.replace(s, value={k: conv(v) for k, v in s.value.items()}) for s in slots]


def sample_to_device(sample: dict, device) -> dict:
    """A copy of a collated sample whose slots, ``target`` and
    ``constraint_masks`` are tensors on ``device`` (the form the criterion
    and the train step take): token targets int64, feature targets in
    their float dtype, masks boolean."""
    out = dict(sample)
    out["net_input"] = {**sample["net_input"],
                        "slots": slots_to_device(sample["net_input"]["slots"], device)}
    for key in ("target", "constraint_masks"):
        v = sample.get(key)
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[key] = (t if t.dtype == torch.bool or t.is_floating_point() else t.long()).to(device)
    return out
