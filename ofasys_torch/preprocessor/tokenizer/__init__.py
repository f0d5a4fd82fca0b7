"""Tokenizers (counterpart of ofasys_tpu/preprocessor/tokenizer/)."""

from ofasys_torch.preprocessor.tokenizer.base import BaseTokenizer
from ofasys_torch.preprocessor.tokenizer.gpt2_bpe import (
    ByteTokenizer,
    CharacterTokenizer,
    GPT2BPE,
    WordPieceTokenizer,
    build_tokenizer,
    bytes_to_unicode,
)

__all__ = ["BaseTokenizer", "ByteTokenizer", "CharacterTokenizer", "GPT2BPE",
           "WordPieceTokenizer", "build_tokenizer", "bytes_to_unicode"]
