"""Tokenizers (counterpart of ofasys_tpu/preprocessor/tokenizer/base.py and
``ByteTokenizer`` from tokenizer/gpt2_bpe.py).

A tokenizer maps text <-> a list of integer ids in its OWN id space
(0..vocab_size). The text preprocessor reserves a contiguous ``<text>_i``
namespace in the global Dictionary and adds the namespace offset.

This slice ports the hermetic byte tokenizer only: GPT-2 BPE needs
``encoder.json`` and ``vocab.bpe``, which the repository does not hold.
"""

from __future__ import annotations

from typing import List


class BaseTokenizer:
    vocab_size: int

    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: List[int]) -> str:
        raise NotImplementedError


class ByteTokenizer(BaseTokenizer):
    """Hermetic byte-level tokenizer: ids are raw utf-8 bytes (0..255)."""

    vocab_size = 256

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: List[int]) -> str:
        return bytes(int(i) for i in ids if 0 <= int(i) < 256).decode("utf-8", errors="replace")


def build_tokenizer(name: str) -> BaseTokenizer:
    if name == "bytes":
        return ByteTokenizer()
    raise NotImplementedError(
        f"tokenizer {name!r} is not ported yet; ofasys_torch supports bpe='bytes' "
        "(GPT-2 BPE waits for its encoder.json/vocab.bpe assets)"
    )
