"""The instruction DSL: one line declares a multi-modal task.

Grammar (parity with reference ofasys/preprocessor/instruction.py:109-279)::

    template   := source '->' target
    source     := (plaintext | slot)*
    target     := (plaintext | slot)*
    slot       := '[' MODALITY (':' name)? (',' attr)* ']'
    attr       := key ('=' value)?

Example: ``[IMAGE:img] what does the image describe? -> [TEXT:cap]``.

Plain text between slots becomes implicit TEXT slots with ``is_plaintext=True``.
Slots left of ``->`` are encoder slots (E-slots, ``is_src=True``); right of it,
decoder slots (D-slots). The *last* D-slot is the generation/loss target.

Recognized attributes (superset used across the reference's 30 tasks):
``closed_set``, ``no_loss``, ``preprocess=<name>``, ``adaptor=<name>``,
``mask_ratio=<float>``, ``max_length=<int>`` — arbitrary ``k=v`` pairs are
carried through to the slot's preprocessor/adaptor as kwargs.
"""

from __future__ import annotations

import copy
import re
from collections import Counter
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ofasys_torch import ModalityType

_SLOT_RE = re.compile(
    r"\[("
    + "|".join(m.name for m in ModalityType)
    + r")"
    + r"(?::([_A-Za-z0-9]+))?"      # optional :column_name
    + r"(?:,([_A-Za-z0-9,.=\-]+))?"  # optional ,attr[,attr...]
    + r"\]"
)


@dataclass
class Slot:
    """One contiguous span of a single modality inside an instruction.

    Attributes follow the reference Slot (instruction.py:29-106): ``modality``,
    ``is_src`` (E-slot vs D-slot), optional bound ``value``, the template
    ``column_name`` used by :meth:`Instruction.format`, and free-form
    ``attributes``.
    """

    modality: ModalityType
    is_src: bool
    value: Optional[Any] = None
    global_position: Optional[int] = None
    column_name: Optional[str] = None
    attributes: Optional[List[str]] = None
    preprocess: Optional[str] = None
    is_plaintext: bool = False
    split: str = "train"
    decoder_plain_with_loss: bool = False

    def __post_init__(self):
        if self.column_name is None:
            self.column_name = str(self.global_position)
        if isinstance(self.attributes, str):
            self.attributes = self.attributes.split(",")

    # -------------------------------------------------------------- attrs
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
                val = a[len(prefix):]
                return class_factory(val) if class_factory is not None else val
        return None

    def attr2kwargs(self) -> Dict[str, Any]:
        kwargs: Dict[str, Any] = {}
        for a in self.attributes or ():
            k, eq, v = a.partition("=")
            kwargs[k] = v if eq else True
        return kwargs

    # ------------------------------------------------------------- helpers
    @property
    def is_plain_text(self) -> bool:
        return self.is_plaintext

    @staticmethod
    def get_target_slot_from_slots(slots: List["Slot"]) -> "Slot":
        return [s for s in slots if not s.is_src][-1]

    @staticmethod
    def get_target_slot_from_sample(sample: Dict) -> "Slot":
        return Slot.get_target_slot_from_slots(sample["net_input"]["slots"])


class Instruction:
    """Parses a template into a slot list and binds data via :meth:`format`.

    >>> ist = Instruction("[IMAGE:img] what does the image describe? -> [TEXT:cap]")
    >>> [s.modality.name for s in ist.slots]
    ['IMAGE', 'TEXT', 'TEXT']
    >>> bound = ist.format(img=image, cap="a red bird")
    """

    def __init__(self, template: str, split: str = "train", decoder_plain_with_loss: bool = False):
        template = template.strip()
        if template.count("->") != 1:
            raise ValueError(
                "instruction template must contain exactly one '->' separating "
                f"encoder and decoder parts, got: {template!r}"
            )
        source, target = (part.strip() for part in template.split("->"))
        self.template = template
        self.split = split
        self.decoder_plain_with_loss = decoder_plain_with_loss
        self.slots: List[Slot] = []
        self._parse(source, is_src=True)
        self._parse(target, is_src=False)
        self.others: Dict[str, Any] = {}

    # ------------------------------------------------------------- parsing
    def _parse(self, text: str, is_src: bool):
        def add(**kw):
            self.slots.append(
                Slot(
                    is_src=is_src,
                    global_position=len(self.slots),
                    split=self.split,
                    decoder_plain_with_loss=self.decoder_plain_with_loss,
                    **kw,
                )
            )

        pos = 0
        for m in _SLOT_RE.finditer(text):
            mod_name, col_name, attrs = m.groups()
            plain = text[pos:m.start()].strip()
            if plain:
                add(modality=ModalityType.TEXT, value=plain, is_plaintext=True)
            add(modality=ModalityType[mod_name], column_name=col_name, attributes=attrs)
            pos = m.end()
        tail = text[pos:].strip()
        if tail:
            add(modality=ModalityType.TEXT, value=tail, is_plaintext=True)

    # ------------------------------------------------------------- binding
    def get_slot_names(self) -> List[str]:
        return [s.column_name for s in self.slots if s.value is None]

    def format(self, *args, **kwargs) -> "Instruction":
        """Return a deep copy with open slots filled positionally/by name.

        Positional args fill open slots in order; slots sharing a
        ``column_name`` all receive the same value; leftover kwargs are kept
        in ``.others`` (available to the task's preprocess hook).
        """
        ist = copy.deepcopy(self)
        remaining = Counter(s.column_name for s in ist.slots if not s.is_plaintext)
        args = list(args)
        for slot in ist.slots:
            if slot.value is not None:
                continue
            if args:
                slot.value = args.pop(0)
                remaining[slot.column_name] -= 1
                if remaining[slot.column_name] != 0:
                    # value shared by a later slot with the same name
                    kwargs[slot.column_name] = slot.value
            else:
                slot.value = kwargs.get(slot.column_name)
                remaining[slot.column_name] -= 1
                if slot.value is None and slot.is_src:
                    raise ValueError(f"missing value for source slot {slot.column_name!r}")
        if args:
            raise ValueError(f"unexpected extra positional args: {args}")
        ist.others = kwargs
        return ist

    # ------------------------------------------------------------ utilities
    @property
    def source_slots(self) -> List[Slot]:
        return [s for s in self.slots if s.is_src]

    @property
    def target_slots(self) -> List[Slot]:
        return [s for s in self.slots if not s.is_src]

    @property
    def target_slot(self) -> Slot:
        return Slot.get_target_slot_from_slots(self.slots)

    def __str__(self):
        parts: List[str] = []
        emitted_arrow = False
        for s in self.slots:
            if not s.is_src and not emitted_arrow:
                parts.append("->")
                emitted_arrow = True
            parts.append(str(s.value))
        return " ".join(parts)

    def __repr__(self):
        return f"Instruction({self.template!r})"
