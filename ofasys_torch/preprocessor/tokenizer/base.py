"""Tokenizer interface (counterpart of ofasys_tpu/preprocessor/tokenizer/base.py).

A tokenizer maps text <-> a list of integer ids in its OWN id space
(0..vocab_size). The text preprocessor reserves a contiguous ``<text>_i``
namespace in the global Dictionary and adds the namespace offset.
"""

from __future__ import annotations

from typing import List


class BaseTokenizer:
    vocab_size: int

    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: List[int]) -> str:
        raise NotImplementedError
