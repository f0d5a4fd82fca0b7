"""Structured-data preprocessors (counterpart of
ofasys_tpu/preprocessor/struct.py; reference
ofasys/preprocessor/default/struct.py: table linearization + Spider database
schema serialization) and category labels
(reference default/category.py) and phonemes (reference default/phone.py).

All are text-group members: they produce token runs that merge with
neighboring text (like the reference, which subclasses the text preprocess).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from ofasys_torch.configure.config_store import register_config
from ofasys_torch.preprocessor.base import CollateOutput, PreprocessSkipException
from ofasys_torch.preprocessor.instruction import Slot
from ofasys_torch.preprocessor.text import TextPreprocess, TextPreprocessConfig
from ofasys_torch.preprocessor.utils import collate_tokens


@dataclass
class StructPreprocessConfig(TextPreprocessConfig):
    row_separator: str = " | "
    col_separator: str = " : "


@register_config("ofasys.preprocess", "struct", StructPreprocessConfig)
@register_config("ofasys.preprocess", "table", StructPreprocessConfig)
class StructPreprocess(TextPreprocess):
    """Tables -> linearized text (reference DefaultStructPreprocess).

    Registered under BOTH "struct" and "table": the reference's canonical
    name is "table" (reference preprocessor/default/struct.py:37 and
    default_preprocess[STRUCT]='table', general.py:33), so reference-authored
    templates with ``preprocess=table`` must resolve; "struct" is kept for
    templates written against this repo.
    """

    def linearize(self, value: Any) -> str:
        if isinstance(value, str):
            return value
        cfg = self.cfg
        if isinstance(value, dict):
            # {"header": [...], "rows": [[...], ...]} table form
            header = value.get("header") or value.get("columns")
            rows = value.get("rows") or value.get("data") or []
            parts = []
            if header:
                parts.append(cfg.col_separator.join(map(str, header)))
            for row in rows:
                parts.append(cfg.col_separator.join(map(str, row)))
            return cfg.row_separator.join(parts)
        if isinstance(value, (list, tuple)):
            # triple list [[subj, pred, obj], ...] (dart-style)
            return cfg.row_separator.join(cfg.col_separator.join(map(str, t)) for t in value)
        raise PreprocessSkipException(f"cannot linearize struct value of type {type(value)}")

    def map(self, slot: Slot) -> Slot:
        if not slot.is_src and slot.value is None:
            return self.dummy_slot(slot)
        if not isinstance(slot.value, dict) or "inputs" not in slot.value:
            if not isinstance(slot.value, np.ndarray):
                slot.value = self.linearize(slot.value)
        return TextPreprocess.map(self, slot)


@dataclass
class DatabasePreprocessConfig(StructPreprocessConfig):
    schema_serialization_with_db_content: bool = True


@register_config("ofasys.preprocess", "database", DatabasePreprocessConfig)
class DatabasePreprocess(StructPreprocess):
    """Spider DB schema serialization (reference DatabaseStructPreprocess,
    struct.py:77-115): peteshaw format
    ``db_id | table : col1 , col2 ( linked value ) | table2 : ...``.

    When ``schema_serialization_with_db_content`` is set and the slot value
    carries a ``question`` plus a database location (``db_path``), question
    tokens are matched against actual DB cell values (BRIDGE content
    encoding, reference utils/spider/bridge_content_encoder.py) and matched
    values are appended after their column — this materially changes the
    text-to-SQL model input and is the reference's default behavior.
    """

    @staticmethod
    def _tables_of(value: Dict[str, Any]) -> List:
        """Ordered (table, [cols]) pairs from either this repo's
        ``{"tables": {t: [cols]}}`` shape or the reference record shape
        ``{"db_table_names": [...], "db_column_names": {"table_id": [...],
        "column_name": [...]}}`` (reference struct.py:280-297)."""
        if "tables" in value:
            return [(str(t), [str(c) for c in cols]) for t, cols in value["tables"].items()]
        names = value.get("db_table_names") or []
        colrec = value.get("db_column_names") or {}
        out = [(str(t), []) for t in names]
        for tid, col in zip(colrec.get("table_id", []), colrec.get("column_name", [])):
            if 0 <= int(tid) < len(out) and str(col) != "*":
                out[int(tid)][1].append(str(col))
        return out

    def _db_file(self, value: Dict[str, Any]) -> str:
        """Resolve the sqlite file: an explicit ``db_path`` pointing at the
        file, or a Spider-layout root ``{root}/{db_id}/{db_id}.sqlite`` (flat
        ``{root}/{db_id}.sqlite`` also accepted)."""
        import os

        raw = value.get("db_path") or ""
        if not raw:
            return ""
        if raw.endswith(".sqlite"):
            return raw
        db_id = str(value.get("db_id", ""))
        for cand in (os.path.join(raw, db_id, f"{db_id}.sqlite"),
                     os.path.join(raw, f"{db_id}.sqlite")):
            if os.path.isfile(cand):
                return cand
        return ""

    def linearize(self, value: Any) -> str:
        if isinstance(value, str):
            return value
        if isinstance(value, dict) and "db_id" in value:
            from ofasys_torch.utils.spider_linking import serialize_schema

            db_file = self._db_file(value)
            return serialize_schema(
                question=str(value.get("question", "")),
                db_path=db_file,
                db_id=str(value["db_id"]),
                tables=self._tables_of(value),
                with_db_id=True,
                with_db_content=(
                    self.cfg.schema_serialization_with_db_content and bool(db_file)
                ),
            ).strip()
        return super().linearize(value)


@dataclass
class CategoryPreprocessConfig(TextPreprocessConfig):
    ans2label_file: Optional[str] = None


@register_config("ofasys.preprocess", "category", CategoryPreprocessConfig)
class CategoryPreprocess(TextPreprocess):
    """Label-id <-> text mapping (reference default/category.py): CATEGORY
    slots carry either a label string or an integer id resolved via
    ans2label."""

    def map(self, slot: Slot) -> Slot:
        if not slot.is_src and slot.value is None:
            return self.dummy_slot(slot)
        v = slot.value
        if isinstance(v, (int, np.integer)):
            if self.ans2label:
                inv = {i: a for a, i in self.ans2label.items()}
                slot.value = inv.get(int(v), str(v))
            else:
                slot.value = str(v)
        return TextPreprocess.map(self, slot)


@dataclass
class PhonePreprocessConfig(TextPreprocessConfig):
    phone_dict_file: Optional[str] = None
    use_g2p: bool = False


@register_config("ofasys.preprocess", "phone", PhonePreprocessConfig)
class PhonePreprocess(TextPreprocess):
    """Phoneme tokens in a dedicated <phone>_ namespace
    (reference default/phone.py:32-206). Input may be a pre-phonemized
    space-separated phone string; g2p_en conversion is applied when
    installed and enabled.

    Namespace layout mirrors the reference's
    ``<phone>_dict_begin | phones... | <phone>_unk`` block
    (default/phone.py:41-55): row 0 doubles as the CTC blank class
    (reference speech_to_text_loss.py:142 uses blank_idx=0 over the
    ``[dict_begin, dict_end)`` embedding slice), the last row is the
    unknown-phone bucket.
    """

    def __init__(self, global_dict, cfg: PhonePreprocessConfig):
        super().__init__(global_dict, cfg)
        self.phone2id: Dict[str, int] = {}
        if cfg.phone_dict_file:
            with open(cfg.phone_dict_file) as f:
                phones = [line.split()[0] for line in f if line.strip()]
        else:
            # CMUdict ARPABET inventory as a hermetic default
            phones = ("AA AE AH AO AW AY B CH D DH EH ER EY F G HH IH IY JH K L M N NG "
                      "OW OY P R S SH T TH UH UW V W Y Z ZH sil sp").split()
        start, end = global_dict.add_namespace(
            "<phone>", len(phones) + 2, fmt="{prefix}_{i}"
        )
        self.phone_blank = start          # CTC blank (== reference dict_begin row)
        self.phone_unk = end - 1          # unknown-phone bucket
        for i, p in enumerate(phones):
            self.phone2id[p] = start + 1 + i
        self.id2phone = {v: k for k, v in self.phone2id.items()}

    def phonemize(self, text: str) -> List[str]:
        if self.cfg.use_g2p:
            try:
                from g2p_en import G2p

                return [p for p in G2p()(text) if p.strip()]
            except ImportError:
                pass
        return text.strip().split()

    def encode_phones(self, text: str) -> np.ndarray:
        ids = [self.phone2id.get(p, self.phone_unk) for p in self.phonemize(text)]
        return np.asarray(ids, np.int32)

    def map(self, slot: Slot) -> Slot:
        if not slot.is_src and slot.value is None:
            return self.dummy_slot(slot)
        if isinstance(slot.value, str):
            slot.value = self.encode_phones(slot.value)
        return TextPreprocess.map(self, slot)

    def decode(self, tokens: np.ndarray, **kwargs) -> str:
        toks = np.asarray(tokens).reshape(-1)
        return " ".join(self.id2phone[int(t)] for t in toks if int(t) in self.id2phone)


# --------------------------------------------------------------- text_phone
_LETTER_PHONES = {
    "a": ("AH",), "b": ("B",), "c": ("K",), "d": ("D",), "e": ("EH",),
    "f": ("F",), "g": ("G",), "h": ("HH",), "i": ("IH",), "j": ("JH",),
    "k": ("K",), "l": ("L",), "m": ("M",), "n": ("N",), "o": ("AO",),
    "p": ("P",), "q": ("K",), "r": ("R",), "s": ("S",), "t": ("T",),
    "u": ("AH",), "v": ("V",), "w": ("W",), "x": ("K", "S"), "y": ("Y",),
    "z": ("Z",),
}


def hermetic_g2p(text: str) -> List[str]:
    """Deterministic letter->ARPABET fallback used when g2p_en is not
    installed (zero-egress environments): each letter maps to its closest
    single phoneme. NOT linguistically accurate — it exists so the
    text->phone pipeline (and its CTC targets) stay exercisable hermetically;
    with g2p_en present the real lexicon+model pronunciation is used instead
    (reference default/phone.py:173-193 phonemize())."""
    out: List[str] = []
    for word in text.lower().split():
        for ch in word:
            out.extend(_LETTER_PHONES.get(ch, ()))
    return out


@dataclass
class TextPhonePreprocessConfig(PhonePreprocessConfig):
    use_t2p: bool = True


@register_config("ofasys.preprocess", "text_phone", TextPhonePreprocessConfig)
class TextPhonePreprocess(PhonePreprocess):
    """Text targets with auxiliary phoneme encoder-targets (reference
    default/text.py:404-509 TextForPhonePreprocess, registered as
    'text_phone'): the decoder target is ordinary BPE text, and when
    ``use_t2p`` the raw string is additionally phonemized (g2p) into
    ``<phone>_`` namespace ids which collate into ``sample['encoder_target']``
    — consumed by the speech_to_text criterion's CTC branch against encoder
    states (reference speech_to_text_loss.py:217-225). Used by ASR templates:
    ``[AUDIO:wav] ... -> [TEXT:text,preprocess=text_phone]``.
    """

    def text_to_phones(self, text: str) -> List[str]:
        try:
            from g2p_en import G2p

            raw = list(G2p()(text))
        except Exception:
            # no g2p_en, or a stubbed module whose import succeeds but whose
            # call fails
            return hermetic_g2p(text)
        if not all(isinstance(p, str) for p in raw):
            return hermetic_g2p(text)
        # strip stress digits so g2p output maps onto the hermetic
        # inventory when no phone_dict_file carries stressed variants
        phones = [p.rstrip("012") for p in raw if p.strip() and p != " "]
        return [p for p in phones if p.strip()]

    def map(self, slot: Slot) -> Slot:
        if not slot.is_src and slot.value is None:
            slot = self.dummy_slot(slot)
            slot.value["phone_tokens"] = np.asarray([], np.int32)
            return slot
        text = slot.value if isinstance(slot.value, str) else None
        slot = TextPreprocess.map(self, slot)
        if not slot.is_src and self.cfg.use_t2p and text is not None:
            ids = [self.phone2id.get(p, self.phone_unk) for p in self.text_to_phones(text)]
            # eos-terminated, no bos (reference text.py:466-468)
            slot.value["phone_tokens"] = np.asarray(
                ids + [self.global_dict.eos()], np.int32
            )
        return slot

    def group_map(self, slots: List[Slot]) -> List[Slot]:
        # the generic text group merge only threads the five standard keys;
        # carry the phone aux targets across it (target groups for ASR are
        # single-slot, so concatenation order is trivial)
        phone_runs = [
            s.value.get("phone_tokens") for s in slots
            if isinstance(s.value, dict) and s.value.get("phone_tokens") is not None
        ]
        out = TextPreprocess.group_map(self, slots)
        if phone_runs and not slots[0].is_src:
            out[0].value["phone_tokens"] = np.concatenate(phone_runs).astype(np.int32)
        return out

    def collate(self, slots: List[Slot]) -> CollateOutput:
        out = TextPreprocess.collate(self, slots)
        if (
            not slots[0].is_src
            and self.cfg.use_t2p
            and all(isinstance(s.value, dict) and "phone_tokens" in s.value for s in slots)
        ):
            out.sample_extra["encoder_target"] = collate_tokens(
                [s.value["phone_tokens"] for s in slots],
                pad_idx=self.global_dict.pad(),
                pad_to_multiple=self.cfg.pad_to_multiple,
            )
            # the CTC projection's rows (the <phone> range, blank first) are
            # read by the criterion from the dictionary's namespace
        return out

    def decode(self, tokens: np.ndarray, **kwargs) -> str:
        return TextPreprocess.decode(self, tokens, **kwargs)
