"""Global shared vocabulary.

Counterpart of ofasys_tpu/preprocessor/dictionary.py (pure Python, same behaviour):
one vocab shared by every modality, with special tokens up front and
*contiguous sub-vocab namespaces* (``<bin>_i`` box bins, ``<code>_i`` VQGAN
codes, ``<phone>_i`` phonemes, ...) appended in blocks.

Namespaces are tracked explicitly as ``(start, end)`` ranges instead of
discovered by scanning symbols, so ``get_start_end_idx`` is O(1).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np


class Dictionary:
    """Symbol <-> index mapping with namespaced contiguous ranges."""

    def __init__(
        self,
        bos: Optional[str] = "<s>",
        pad: Optional[str] = "<pad>",
        eos: Optional[str] = "</s>",
        unk: Optional[str] = "<unk>",
        extra_special_symbols: Optional[Iterable[str]] = None,
    ):
        self.symbols: List[str] = []
        self.count: List[int] = []
        self.indices: Dict[str, int] = {}
        # namespace -> (start, end) contiguous block
        self._ranges: Dict[str, Tuple[int, int]] = {}

        self.bos_word, self.pad_word, self.eos_word, self.unk_word = bos, pad, eos, unk
        self.bos_index = self.add_symbol(bos) if bos is not None else None
        self.pad_index = self.add_symbol(pad) if pad is not None else None
        self.eos_index = self.add_symbol(eos) if eos is not None else None
        self.unk_index = self.add_symbol(unk) if unk is not None else None
        for s in extra_special_symbols or ():
            self.add_symbol(s)
        self.nspecial = len(self.symbols)

    # --------------------------------------------------------------- basics
    def __len__(self):
        return len(self.symbols)

    def __contains__(self, sym: str):
        return sym in self.indices

    def __getitem__(self, idx: int) -> str:
        if 0 <= idx < len(self.symbols):
            return self.symbols[idx]
        return self.unk_word

    def __eq__(self, other):
        return isinstance(other, Dictionary) and self.indices == other.indices

    def index(self, sym: str) -> int:
        assert isinstance(sym, str)
        return self.indices.get(sym, self.unk_index)

    def get_count(self, idx: int) -> int:
        return self.count[idx]

    def bos(self):
        return self.bos_index

    def pad(self):
        return self.pad_index

    def eos(self):
        return self.eos_index

    def unk(self):
        return self.unk_index

    # ------------------------------------------------------------ mutation
    def add_symbol(self, word: str, n: int = 1, overwrite: bool = False) -> int:
        if word in self.indices and not overwrite:
            idx = self.indices[word]
            self.count[idx] += n
            return idx
        idx = len(self.symbols)
        self.indices[word] = idx
        self.symbols.append(word)
        self.count.append(n)
        return idx

    def add_namespace(self, prefix: str, size: int, fmt: str = "{prefix}_{i}") -> Tuple[int, int]:
        """Append a contiguous block ``prefix_0 .. prefix_{size-1}``.

        Returns its (start, end) index range (end exclusive). Calling again
        with the same prefix returns the existing range (must match size).
        Replaces the reference's scan-based sub-vocab discovery
        (dictionary.py:66-74) with an explicit registry.
        """
        if prefix in self._ranges:
            start, end = self._ranges[prefix]
            if end - start != size:
                raise ValueError(
                    f"namespace {prefix!r} already registered with size {end - start}, requested {size}"
                )
            return start, end
        names = [fmt.format(prefix=prefix, i=i) for i in range(size)]
        first = self.indices.get(names[0]) if names else None
        if first is not None and all(self.indices.get(w) == first + i for i, w in enumerate(names)):
            # a dictionary read from a file (``load``) holds the block already
            self._ranges[prefix] = (first, first + size)
            return first, first + size
        start = len(self.symbols)
        for i in range(size):
            self.add_symbol(fmt.format(prefix=prefix, i=i), n=0)
        end = len(self.symbols)
        self._ranges[prefix] = (start, end)
        return start, end

    def get_start_end_idx(self, prefix: str) -> Tuple[int, int]:
        """(start, end-exclusive) of the contiguous block whose symbols begin
        with ``prefix``. O(1) for registered namespaces; falls back to a scan
        for ad-hoc prefixes (reference parity)."""
        for ns, (start, end) in self._ranges.items():
            if ns.startswith(prefix) or prefix.startswith(ns):
                return start, end
        start, end = -1, -1
        for i, tok in enumerate(self.symbols):
            if tok.startswith(prefix):
                if start < 0:
                    start = i
                end = i + 1
        return start, end

    def add_from_file(self, f, prefix: Optional[str] = None):
        """Load ``symbol count`` lines, optionally namespacing each symbol as
        ``{prefix}{symbol}`` (reference dictionary.py:248-300)."""
        if isinstance(f, str):
            with open(f, "r", encoding="utf-8") as fd:
                return self.add_from_file(fd, prefix=prefix)
        start = len(self.symbols)
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            word, _, cnt = line.rpartition(" ")
            if not word:
                word, cnt = cnt, "1"
            if prefix:
                word = f"{prefix}{word}"
            try:
                n = int(cnt)
            except ValueError:
                word, n = line, 1
            self.add_symbol(word, n=n)
        if prefix and len(self.symbols) > start:
            self._ranges[prefix] = (start, len(self.symbols))

    def update(self, other: "Dictionary"):
        for word in other.symbols:
            self.add_symbol(word, n=other.count[other.indices[word]])

    def pad_to_multiple_(self, padding_factor: int):
        """Round vocab size up so the tied logits GEMM gets a vocab dim that
        tiles evenly (128 is the usual factor)."""
        if padding_factor > 1:
            i = 0
            while len(self) % padding_factor != 0:
                self.add_symbol(f"madeupword{i:04d}", n=0)
                i += 1

    # ------------------------------------------------------------- encoding
    def encode_line(
        self,
        line: str,
        line_tokenizer=None,
        add_if_not_exist: bool = False,
        append_eos: bool = True,
        reverse_order: bool = False,
    ) -> np.ndarray:
        words = line_tokenizer(line) if line_tokenizer is not None else line.split()
        if reverse_order:
            words = list(reversed(words))
        ids = [
            self.add_symbol(w) if add_if_not_exist else self.index(w)
            for w in words
        ]
        if append_eos:
            ids.append(self.eos_index)
        return np.asarray(ids, dtype=np.int32)

    def string(
        self,
        tensor,
        bpe_symbol: Optional[str] = None,
        escape_unk: bool = False,
        extra_symbols_to_ignore: Optional[Iterable[int]] = None,
        unk_string: Optional[str] = None,
        include_eos: bool = False,
    ) -> str:
        """Detokenize an id sequence (skips bos/pad, optionally eos)."""
        ids = np.asarray(tensor).reshape(-1).tolist()
        ignore = set(extra_symbols_to_ignore or ())
        ignore.add(self.pad_index)
        if self.bos_index is not None:
            ignore.add(self.bos_index)
        if not include_eos and self.eos_index is not None:
            ignore.add(self.eos_index)

        def tok(i):
            if i == self.unk_index:
                if unk_string is not None:
                    return unk_string
                return f"<{self.unk_word}>" if escape_unk else self.unk_word
            return self[i]

        sent = " ".join(tok(i) for i in ids if i not in ignore)
        if bpe_symbol is not None:
            sent = (sent + " ").replace(bpe_symbol, "").rstrip()
        return sent

    # ---------------------------------------------------------- persistence
    @classmethod
    def load(cls, f) -> "Dictionary":
        d = cls()
        d.add_from_file(f)
        return d

    def save(self, f):
        if isinstance(f, str):
            with open(f, "w", encoding="utf-8") as fd:
                return self.save(fd)
        for sym, cnt in zip(self.symbols[self.nspecial:], self.count[self.nspecial:]):
            print(f"{sym} {cnt}", file=f)

    def state_dict(self) -> Dict:
        return {
            "symbols": list(self.symbols),
            "count": list(self.count),
            "nspecial": self.nspecial,
            "ranges": {k: list(v) for k, v in self._ranges.items()},
        }

    @classmethod
    def from_state_dict(cls, state: Dict) -> "Dictionary":
        d = cls(bos=None, pad=None, eos=None, unk=None)
        for sym, cnt in zip(state["symbols"], state["count"]):
            d.add_symbol(sym, n=cnt)
        d.nspecial = state["nspecial"]
        d._ranges = {k: tuple(v) for k, v in state.get("ranges", {}).items()}
        for attr, word in (("bos", "<s>"), ("pad", "<pad>"), ("eos", "</s>"), ("unk", "<unk>")):
            setattr(d, f"{attr}_word", word)
            setattr(d, f"{attr}_index", d.indices.get(word))
        return d
