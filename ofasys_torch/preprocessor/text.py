"""Text preprocessor (counterpart of ofasys_tpu/preprocessor/text.py).

Per slot: tokenize (byte id + namespace offset), span masking
(``mask_ratio`` on the train split, from a numpy rng seeded by
``cfg.seed``), loss masking for no-loss decoder spans (which become forced
prefix tokens at inference). group_map merges adjacent text slots and wraps
them with bos/eos; collate builds prev_output_tokens = inputs[:-1] and
target = target[1:].

Closed-set constraint masks need the ans2label trie (``ans2label_file``),
which is not ported yet (ROADMAP Queue A item 3); without it ofasys_tpu
makes none either.
"""

from __future__ import annotations

import re
import string
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np

from ofasys_torch.preprocessor.base import BasePreprocess, CollateOutput, PreprocessConfig
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.instruction import Slot
from ofasys_torch.preprocessor.mask_utils import add_span_mask
from ofasys_torch.preprocessor.tokenizer import build_tokenizer
from ofasys_torch.preprocessor.utils import collate_tokens

_PUNCT_RE = re.compile(f"[{re.escape(string.punctuation)}]")


@dataclass
class TextPreprocessConfig(PreprocessConfig):
    bpe: str = "bytes"
    max_src_length: int = 256
    max_tgt_length: int = 256
    # pad every batch to max_src/tgt_length instead of longest-in-batch
    pad_to_fixed: bool = False
    poisson_lambda: float = 3.0
    random_ratio: float = 0.0
    replace_length: int = 1
    seed: int = 1


class TextPreprocess(BasePreprocess):
    def __init__(self, global_dict: Dictionary, cfg: TextPreprocessConfig):
        super().__init__(global_dict, cfg)
        self.bpe = build_tokenizer(cfg.bpe)
        self.text_start, self.text_end = global_dict.add_namespace("<text>", self.bpe.vocab_size)
        self.mask_idx = global_dict.add_symbol("<mask>")
        self.rng = np.random.default_rng(cfg.seed)

    # ------------------------------------------------------------- encoding
    def encode(self, text: str) -> np.ndarray:
        """text -> global-dict token ids (no bos/eos)."""
        ids = self.bpe.encode(" " + text.strip())
        return np.asarray([self.text_start + i for i in ids], dtype=np.int32)

    def decode(self, tokens: np.ndarray, **kwargs) -> str:
        toks = np.asarray(tokens).reshape(-1)
        bpe_ids = [int(t) - self.text_start for t in toks if self.text_start <= int(t) < self.text_end]
        return self.bpe.decode(bpe_ids).strip()

    def dummy_slot(self, slot: Slot) -> Slot:
        """Open decoder slot at inference: empty token run; after the group
        bos/eos wrap, collate yields prev=[bos] / target=[eos]."""
        empty = np.asarray([], np.int32)
        slot.value = {
            "inputs": empty,
            "target": empty,
            "constraint_masks": None,
            "raw_tokens": empty,
            "prefix_tokens": empty,
        }
        return slot

    # ------------------------------------------------------------------ map
    def map(self, slot: Slot) -> Slot:
        if not slot.is_src and slot.value is None:
            return self.dummy_slot(slot)
        if isinstance(slot.value, dict):
            return slot  # already mapped (task-level custom preprocessing)

        text = slot.value
        if isinstance(text, str):
            if slot.has_attr("uncased"):
                text = text.lower()
            if slot.has_attr("no_punctuation"):
                text = " ".join(_PUNCT_RE.sub("", text).strip().split())
            tokens = self.encode(text)
        elif isinstance(text, np.ndarray) and np.issubdtype(text.dtype, np.integer):
            tokens = text.astype(np.int32)
        else:
            raise ValueError(f"text slot expects str or 1-D int array, got {type(text)}")

        max_length = slot.get_attr("max_length", int)
        if max_length:
            tokens = tokens[:max_length]

        inputs = tokens
        mask_ratio = slot.get_attr("mask_ratio", float)
        if mask_ratio and slot.split == "train":
            inputs = add_span_mask(
                tokens,
                mask_ratio,
                self.mask_idx,
                self.rng,
                poisson_lambda=self.cfg.poisson_lambda,
                random_ratio=self.cfg.random_ratio,
                replace_length=self.cfg.replace_length,
                random_token_range=(self.text_start, self.text_end),
            )

        if not slot.is_src:
            no_loss = (slot.is_plaintext and not slot.decoder_plain_with_loss) or slot.has_attr("no_loss")
            target = np.where(no_loss, np.full_like(tokens, self.global_dict.pad()), tokens)
            prefix_tokens = tokens if (no_loss and slot.split != "train") else np.asarray([], np.int32)
        else:
            target = None
            prefix_tokens = None

        slot.value = {
            "inputs": inputs,
            "target": target,
            "constraint_masks": None,
            "raw_tokens": tokens,
            "prefix_tokens": prefix_tokens,
        }
        return slot

    # ------------------------------------------------------------ group_map
    def group_map(self, slots: List[Slot]) -> List[Slot]:
        d = self.global_dict
        # non-text modalities of the text group produce token arrays
        for slot in slots:
            if isinstance(slot.value, np.ndarray):
                slot.value = {
                    "inputs": slot.value,
                    "target": None if slot.is_src else slot.value,
                    "constraint_masks": None,
                    "raw_tokens": slot.value,
                    "prefix_tokens": None if slot.is_src else np.asarray([], np.int32),
                }

        merged: Dict[str, Any] = {"constraint_masks": None}
        wrap = not slots[0].has_attr("disable_auto_boseos")
        for key in ("inputs", "target", "raw_tokens", "prefix_tokens"):
            vals = [s.value[key] for s in slots]
            if all(v is None for v in vals):
                merged[key] = None
                continue
            cat = np.concatenate([v for v in vals if v is not None], axis=0)
            if wrap:
                cat = np.concatenate([[d.bos()], cat, [d.eos()]]).astype(np.int32)
            merged[key] = cat

        max_length = self.cfg.max_src_length if slots[0].is_src else self.cfg.max_tgt_length
        for key, v in merged.items():
            if v is not None:
                merged[key] = v[: max_length + 1]

        out = Slot(
            modality=slots[0].modality,
            is_src=slots[0].is_src,
            value=merged,
            global_position=slots[0].global_position,
            column_name=",".join(s.column_name for s in slots),
            attributes=slots[0].attributes,
            preprocess=slots[0].preprocess,
            is_plaintext=False,
            split=slots[0].split,
        )
        return [out]

    # -------------------------------------------------------------- collate
    def collate(self, slots: List[Slot]) -> CollateOutput:
        d = self.global_dict
        p2m = self.cfg.pad_to_multiple
        fixed_src = self.cfg.max_src_length if self.cfg.pad_to_fixed else None
        fixed_tgt = self.cfg.max_tgt_length if self.cfg.pad_to_fixed else None

        if slots[0].is_src:
            inputs = collate_tokens([s.value["inputs"] for s in slots], pad_idx=d.pad(),
                                    pad_to_multiple=p2m, pad_to_length=fixed_src)
            return CollateOutput(self.to_slot_batch(slots[0], {"inputs": inputs}))

        # decoder side: teacher-forced shift
        prev = collate_tokens(
            [s.value["inputs"][:-1] for s in slots], pad_idx=d.pad(),
            pad_to_multiple=p2m, pad_to_length=fixed_tgt,
        )
        target = collate_tokens(
            [s.value["target"][1:] for s in slots], pad_idx=d.pad(),
            pad_to_multiple=p2m, pad_to_length=fixed_tgt,
        )
        prefix = collate_tokens(
            [s.value["prefix_tokens"][1:-1] if len(s.value["prefix_tokens"]) > 1 else np.asarray([], np.int32)
             for s in slots],
            pad_idx=d.pad(), pad_to_multiple=1,
        )
        extra: Dict[str, Any] = {
            "target": target,
            "ntokens": int((target != d.pad()).sum()),
            "prefix_tokens": prefix,
            "dict_start": self.text_start,
            "dict_end": self.text_end,
        }
        input_batch = self.to_slot_batch(slots[0], {"inputs": prev})
        target_batch = self.to_slot_batch(slots[0], {"inputs": target})
        return CollateOutput(input_batch, target_batch, extra)
