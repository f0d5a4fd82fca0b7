"""GeneralPreprocess: per-slot dispatch pipeline (counterpart of
ofasys_tpu/preprocessor/general.py).

Sample path (pure numpy):
  instruction_map -> map per slot -> merge adjacent same-group slots
  -> per-position collate into SlotBatch arrays.

The TEXT, BOX, IMAGE, AUDIO and MOTION preprocessors are ported (text-like
modalities share the TEXT group and concatenate into one token run; an
IMAGE, AUDIO or MOTION slot is a group of its own); a slot of any other
modality raises ``NotImplementedError`` naming the ROADMAP Queue A item
that ports it.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

from ofasys_torch import ModalityType
from ofasys_torch.configure.config_store import ConfigStore
# the ported preprocessors register themselves in the ConfigStore
# (ofasys.preprocess/<name>) when their modules are imported
from ofasys_torch.preprocessor import audio, box, image, motion  # noqa: F401
from ofasys_torch.preprocessor.base import BasePreprocess, PreprocessSkipException
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.instruction import Instruction, Slot
from ofasys_torch.preprocessor.text import TextPreprocessConfig

# default preprocessor per modality
DEFAULT_PREPROCESS = {
    ModalityType.TEXT: "text",
    ModalityType.IMAGE: "image",
    ModalityType.BOX: "box",
    ModalityType.AUDIO: "audio",
    ModalityType.MOTION: "motion_6d",
    ModalityType.PHONE: "phone",
    ModalityType.VIDEO: "video",
    ModalityType.STRUCT: "struct",
    ModalityType.CATEGORY: "category",
}

# ROADMAP Queue A item that ports each preprocessor this slice lacks
_PENDING = {
    "phone": 11, "video": 11, "struct": 11, "category": 11, "image_vqgan": 11, "database": 11,
    "table": 11, "text_phone": 11,
}

# modalities whose token outputs merge into the TEXT group
TEXT_GROUP = {
    ModalityType.TEXT,
    ModalityType.BOX,
    ModalityType.PHONE,
    ModalityType.STRUCT,
    ModalityType.CATEGORY,
}


class GeneralPreprocess:
    """Each preprocessor starts from a deep copy of the config the
    ConfigStore holds for it (``ofasys.preprocess/<name>``, as in
    ofasys_tpu; ``text_cfg`` replaces the text preprocessor's); tune one
    through ``name2pre[name].cfg``. ``active`` defaults to the store's
    active preprocess nodes, else text. A ported preprocessor that a slot
    names and ``active`` left out is built at first use."""

    def __init__(self, global_dict: Dictionary, active: Optional[List[str]] = None,
                 text_cfg: Optional[TextPreprocessConfig] = None):
        self.global_dict = global_dict
        self.text_cfg = text_cfg
        self.name2pre: Dict[str, BasePreprocess] = {}
        names = active
        if names is None:
            names = [n.name for n in ConfigStore().active_nodes("ofasys.preprocess")] or ["text"]
        for name in names:
            self._build(name)

    def _build(self, name: str) -> BasePreprocess:
        if not ConfigStore().contains("ofasys.preprocess", name):
            self._raise_pending(name)
        # deep copy: each task owns its preprocessors and may tune their
        # config; the store's config object would leak across tasks
        node = ConfigStore().get("ofasys.preprocess", name)
        cfg = self.text_cfg if name == "text" and self.text_cfg is not None \
            else copy.deepcopy(node.config)
        self.name2pre[name] = node.target_cls(self.global_dict, cfg)
        return self.name2pre[name]

    @staticmethod
    def _raise_pending(name: str):
        item = _PENDING.get(name)
        where = f"ROADMAP Queue A item {item}" if item else "a later slice"
        raise NotImplementedError(
            f"preprocessor {name!r} is not ported to ofasys_torch yet ({where}); "
            f"ported: {ConfigStore().names('ofasys.preprocess')}"
        )

    # ------------------------------------------------------------- helpers
    @property
    def bpe(self):
        return self.name2pre["text"].bpe

    def get_preprocess(self, slot: Slot) -> BasePreprocess:
        name = slot.get_attr("preprocess") or slot.preprocess or DEFAULT_PREPROCESS[slot.modality]
        if name not in self.name2pre:
            return self._build(name)
        return self.name2pre[name]

    def group_key(self, slot: Slot):
        return ModalityType.TEXT if slot.modality in TEXT_GROUP else slot.modality

    # ------------------------------------------------------ sample pipeline
    def __call__(self, ist: Optional[Instruction]) -> Optional[Instruction]:
        if ist is None:
            return None
        try:
            seen = set()
            for slot in ist.slots:
                pre = self.get_preprocess(slot)
                if id(pre) not in seen:
                    ist = pre.instruction_map(ist)
                    seen.add(id(pre))
            slots = [self.get_preprocess(s).map(s) for s in ist.slots]
        except PreprocessSkipException:
            return None

        # merge adjacent slots sharing (group, side)
        groups: List[List[Slot]] = []
        for s in slots:
            if groups and self.group_key(groups[-1][-1]) == self.group_key(s) \
                    and groups[-1][-1].is_src == s.is_src:
                groups[-1].append(s)
            else:
                groups.append([s])
        out: List[Slot] = []
        for g in groups:
            key = self.group_key(g[0])
            handler = self.name2pre.get(DEFAULT_PREPROCESS[key]) if len(g) > 1 else self.get_preprocess(g[0])
            if handler is None:
                handler = self.get_preprocess(g[0])
            out.extend(handler.group_map(g))
        for i, s in enumerate(out):
            s.global_position = i
        ist.slots = out
        return ist

    # --------------------------------------------------------------- batch
    def collate(self, samples: List[Instruction]) -> Dict[str, Any]:
        if not samples:
            return {}
        n_slots = len(samples[0].slots)
        for ist in samples[1:]:
            if len(ist.slots) != n_slots:
                raise ValueError("cannot batch samples with different slot structures")
        result: Dict[str, Any] = {
            "net_input": {"slots": []},
            "nsentences": len(samples),
            "template": samples[0].template,
        }
        for i in range(n_slots):
            pre = self.get_preprocess(samples[0].slots[i])
            co = pre.collate([ist.slots[i] for ist in samples])
            if co.net_input_slot is not None:
                result["net_input"]["slots"].append(co.net_input_slot)
            if co.sample_extra:
                for k, v in co.sample_extra.items():
                    result[k] = v
        return result

    # ------------------------------------------------------------ decoding
    def postprocess(self, outputs, sample: Dict[str, Any]):
        """Route generator outputs back through the target slot's
        preprocessor: its own ``postprocess`` where it has one (audio,
        motion), else de-tokenize."""
        slots = sample["net_input"]["slots"]
        target = [s for s in slots if not s.is_src][-1]
        name = (target.get_attr("preprocess") if target.attributes else None) \
            or target.preprocess or DEFAULT_PREPROCESS[target.modality]
        pre = self.name2pre[name]
        if hasattr(pre, "postprocess"):
            return pre.postprocess(outputs, sample)
        for out in outputs if isinstance(outputs, list) else [outputs]:
            if getattr(out, "tokens", None) is not None:
                out.text = pre.decode(out.tokens)
        return outputs
