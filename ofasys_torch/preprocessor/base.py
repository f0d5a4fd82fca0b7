"""Preprocessor base: the 4-phase host-side API
(counterpart of ofasys_tpu/preprocessor/base.py).

  instruction_map(ist)   whole-instruction hook (cross-slot coordination)
  map(slot)              raw value -> numpy dict per slot
  group_map(slots)       merge adjacent same-modality slots (bos/eos wrap)
  collate(slots)         list-of-samples -> SlotBatch (+ target/extras)

``PreprocessSkipException`` drops a bad sample.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.instruction import Instruction, Slot
from ofasys_torch.utils.pytree import SlotBatch


class PreprocessSkipException(Exception):
    """Raised by a preprocessor to drop the current sample."""


@dataclass
class PreprocessConfig:
    # >=8 keeps the number of distinct batch shapes small
    pad_to_multiple: int = 8


@dataclass
class CollateOutput:
    net_input_slot: SlotBatch
    net_target_slot: Optional[SlotBatch] = None
    sample_extra: Optional[Dict[str, Any]] = None


class BasePreprocess:
    def __init__(self, global_dict: Dictionary, cfg: PreprocessConfig):
        self.global_dict = global_dict
        self.cfg = cfg

    # phase 1
    def instruction_map(self, ist: Instruction) -> Instruction:
        return ist

    # phase 2
    def map(self, slot: Slot) -> Slot:
        return slot

    # phase 3
    def group_map(self, slots: List[Slot]) -> List[Slot]:
        return slots

    # phase 4
    def collate(self, slots: List[Slot]) -> CollateOutput:
        raise NotImplementedError

    # inference-side: generator output -> user-facing data
    def decode(self, tokens: np.ndarray, **kwargs):
        raise NotImplementedError

    def dummy_slot(self, slot: Slot) -> Slot:
        """Fill an open decoder slot for inference."""
        slot.value = None
        return slot

    @staticmethod
    def to_slot_batch(slot: Slot, value: Dict[str, Any]) -> SlotBatch:
        return SlotBatch(
            modality=slot.modality,
            is_src=slot.is_src,
            value=value,
            column_name=slot.column_name,
            attributes=tuple(slot.attributes) if slot.attributes else None,
            preprocess=slot.preprocess,
            adaptor_name=slot.get_attr("adaptor"),
            split=slot.split,
        )
