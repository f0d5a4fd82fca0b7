"""GPT-2 byte-level BPE and the hermetic tokenizers (counterpart of
ofasys_tpu/preprocessor/tokenizer/gpt2_bpe.py).

``GPT2BPE`` loads ``encoder.json`` + ``vocab.bpe`` from explicit paths or
from ``$OFA_CACHE_HOME`` (default ``~/.cache/ofasys_torch``). The word
split uses the ``regex`` package's Unicode classes when it is installed
and an ASCII pattern with ``re`` otherwise, exactly as ofasys_tpu does;
``REGEX_BACKEND`` names the one in use. The C++ encoder of ofasys_tpu
(``native_bpe.py``) is not ported: ``build_tokenizer`` always returns the
Python ``GPT2BPE``, whose ids are the same.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Tuple

from ofasys_torch.preprocessor.tokenizer.base import BaseTokenizer

try:
    import regex as _re

    # the canonical GPT-2 word-splitting pattern
    _PAT = _re.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
    )
    REGEX_BACKEND = "regex"
except ImportError:  # pragma: no cover
    import re as _re

    _PAT = _re.compile(r"""'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+""")
    REGEX_BACKEND = "re"


def cache_home() -> str:
    return os.environ.get("OFA_CACHE_HOME", os.path.expanduser("~/.cache/ofasys_torch"))


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (printable ranges map to
    themselves, the rest shift above 255)."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    chars = printable[:]
    n = 0
    for b in range(256):
        if b not in printable:
            printable.append(b)
            chars.append(256 + n)
            n += 1
    return dict(zip(printable, (chr(c) for c in chars)))


def _pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _assets(home: str) -> Tuple[str, str]:
    enc, bpe = os.path.join(home, "encoder.json"), os.path.join(home, "vocab.bpe")
    if not (os.path.exists(enc) and os.path.exists(bpe)):
        raise FileNotFoundError(
            f"GPT-2 BPE assets not found at {home} (need encoder.json + vocab.bpe); "
            "set OFA_CACHE_HOME or use bpe='bytes' for a hermetic tokenizer"
        )
    return enc, bpe


class GPT2BPE(BaseTokenizer):
    def __init__(self, encoder_json: str, vocab_bpe: str):
        with open(encoder_json, "r", encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(vocab_bpe, "r", encoding="utf-8") as f:
            merges = [tuple(line.split()) for line in f.read().split("\n")[1:] if line and not line.startswith("#")]
        self.bpe_ranks = {m: i for i, m in enumerate(merges) if len(m) == 2}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: Dict[str, List[str]] = {}
        self.vocab_size = len(self.encoder)

    @classmethod
    def from_cache_home(cls) -> "GPT2BPE":
        return cls(*_assets(cache_home()))

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        pairs = _pairs(word)
        while pairs:
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            a, b = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
            if len(word) == 1:
                break
            pairs = _pairs(word)
        out = list(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _PAT.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._bpe(mapped))
        return ids

    def decode(self, ids: List[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        data = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace")


class ByteTokenizer(BaseTokenizer):
    """Hermetic byte-level tokenizer: ids are raw utf-8 bytes (0..255)."""

    vocab_size = 256

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: List[int]) -> str:
        return bytes(int(i) for i in ids if 0 <= int(i) < 256).decode("utf-8", errors="replace")


class CharacterTokenizer(BaseTokenizer):
    """Character-level tokenizer over a fixed unicode range (BMP)."""

    vocab_size = 65536

    def encode(self, text: str) -> List[int]:
        return [min(ord(c), 65535) for c in text]

    def decode(self, ids: List[int]) -> str:
        return "".join(chr(int(i)) for i in ids)


class WordPieceTokenizer(BaseTokenizer):
    """Greedy longest-match WordPiece over a local vocab file (one token per
    line, '##'-prefixed continuations)."""

    def __init__(self, vocab_file: str, unk: str = "[UNK]", lowercase: bool = True):
        with open(vocab_file, encoding="utf-8") as f:
            self.itos = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        self.stoi = {t: i for i, t in enumerate(self.itos)}
        self.unk = unk
        self.lowercase = lowercase
        self.vocab_size = len(self.itos)

    def _word(self, word):
        ids = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.stoi:
                    cur = self.stoi[piece]
                    break
                end -= 1
            if cur is None:
                return [self.stoi.get(self.unk, 0)]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str):
        if self.lowercase:
            text = text.lower()
        out = []
        for word in text.strip().split():
            out.extend(self._word(word))
        return out

    def decode(self, ids):
        toks = [self.itos[int(i)] if 0 <= int(i) < len(self.itos) else self.unk
                for i in ids]
        out = ""
        for t in toks:
            if t.startswith("##"):
                out += t[2:]
            else:
                out += (" " if out else "") + t
        return out


def build_tokenizer(name: str, **kwargs) -> BaseTokenizer:
    if name in ("gpt2", "gpt2_bpe"):
        if kwargs.get("encoder_json"):
            return GPT2BPE(kwargs["encoder_json"], kwargs["vocab_bpe"])
        return GPT2BPE(*_assets(cache_home()))
    if name == "bytes":
        return ByteTokenizer()
    if name in ("characters", "char"):
        return CharacterTokenizer()
    if name in ("wordpiece", "bert_file"):
        return WordPieceTokenizer(kwargs["vocab_file"])
    if name in ("bert", "bert_cn", "hf_bert"):
        if kwargs.get("vocab_file"):
            return WordPieceTokenizer(kwargs["vocab_file"])
        from transformers import BertTokenizerFast

        tok = BertTokenizerFast.from_pretrained(kwargs.get("bert_name", "bert-base-uncased"))

        class _Bert(BaseTokenizer):
            vocab_size = tok.vocab_size

            def encode(self, text):
                return tok.encode(text, add_special_tokens=False)

            def decode(self, ids):
                return tok.decode(list(map(int, ids)))

        return _Bert()
    raise ValueError(f"unknown tokenizer {name!r}")
