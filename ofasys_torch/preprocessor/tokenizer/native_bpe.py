"""ctypes bridge to the port's C++ GPT-2 BPE encoder (counterpart of
ofasys_tpu/preprocessor/tokenizer/native_bpe.py; source
``ofasys_torch/csrc/host/bpe_encode.cpp``).

``NativeGPT2BPE`` is a drop-in ``GPT2BPE``: same assets, same ids (the C++
scanner's unicode tables are generated from the same ``regex`` module by
``ofasys_torch/tools/gen_unicode_tables.py``, and its merge loop mirrors
``GPT2BPE._bpe``). The library is built with the host's C++ compiler at
first use (``ops/host_build.py``); a build or load failure raises.
``ctypes`` releases the GIL for the call, so a prefetch thread that
tokenizes leaves the launching thread free.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import List

import numpy as np

from ofasys_torch.ops import host_build
from ofasys_torch.preprocessor.tokenizer.gpt2_bpe import GPT2BPE

_INITIAL_IDS = 4096


def _load_lib() -> ctypes.CDLL:
    lib = host_build.load("bpe_encode")
    lib.ofa_bpe_create.restype = ctypes.c_void_p
    lib.ofa_bpe_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.ofa_bpe_free.argtypes = [ctypes.c_void_p]
    lib.ofa_bpe_encode.restype = ctypes.c_int64
    lib.ofa_bpe_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    return lib


def _serialize_tables(bpe: GPT2BPE) -> bytes:
    """Vocab + merges, translated from the byte->unicode remapped strings the
    Python tables use back into RAW BYTE strings (the remap is a per-byte
    bijection, so the native side can merge in plain byte space). The
    strings are mapped and laid out at once with numpy: the table symbols
    all lie in the basic multilingual plane, one UTF-16 unit each."""
    n_tok = max(bpe.encoder.values()) + 1
    by_id = [""] * n_tok
    for tok, idx in bpe.encoder.items():
        by_id[idx] = tok
    merges = [s for pair, _rank in sorted(bpe.bpe_ranks.items(), key=lambda kv: kv[1]) for s in pair]
    strings = by_id + merges
    lut = np.full(1 << 16, 256, np.uint16)
    for c, b in bpe.byte_decoder.items():
        lut[ord(c)] = b
    mapped = lut[np.frombuffer("".join(strings).encode("utf-16-le"), np.uint16)]
    if (mapped > 255).any():
        raise KeyError("a table symbol holds a character that is no byte's symbol")
    # [u32 n_tok][(u32 len, bytes) x n_tok][u32 n_merges][(u32 len, bytes) x 2 n_merges]
    lens = np.fromiter(map(len, strings), np.int64, len(strings))
    heads = 4 + 4 * np.arange(len(strings)) + np.cumsum(lens) - lens
    heads[n_tok:] += 4
    counts = (0, int(heads[n_tok - 1] + 4 + lens[n_tok - 1]))
    out = np.empty(8 + 4 * len(strings) + int(lens.sum()), np.uint8)
    fixed = np.zeros(len(out), bool)
    for at, value in zip(counts, (n_tok, len(merges) // 2)):
        out[at:at + 4] = np.frombuffer(struct.pack("<I", value), np.uint8)
        fixed[at:at + 4] = True
    cols = heads[:, None] + np.arange(4)
    out[cols] = lens.astype("<u4").view(np.uint8).reshape(-1, 4)
    fixed[cols] = True
    out[~fixed] = mapped
    return out.tobytes()


class NativeGPT2BPE(GPT2BPE):
    """GPT2BPE whose ``encode`` runs in the C++ library. ``decode`` and all
    tables stay Python-side (decode is cold). Each thread encodes into its
    own id buffer, which grows when a line needs more."""

    def __init__(self, encoder_json: str, vocab_bpe: str):
        super().__init__(encoder_json, vocab_bpe)
        self._lib = _load_lib()
        blob = _serialize_tables(self)
        self._handle = self._lib.ofa_bpe_create(blob, len(blob))
        if not self._handle:
            raise RuntimeError("ofa_bpe_create rejected the vocab blob")
        self._local = threading.local()

    def _buffer(self, n: int = _INITIAL_IDS):
        buf = getattr(self._local, "buf", None)
        if buf is None or len(buf) < n:
            buf = self._local.buf = (ctypes.c_int32 * n)()
        return buf

    def encode(self, text: str) -> List[int]:
        raw = text.encode("utf-8")
        buf = self._buffer()
        n = self._lib.ofa_bpe_encode(self._handle, raw, len(raw), buf, len(buf))
        if n < -1:
            buf = self._buffer(-n)
            n = self._lib.ofa_bpe_encode(self._handle, raw, len(raw), buf, len(buf))
        if n < 0:
            raise RuntimeError("native BPE encode failed")
        ids = buf[:n]
        if any(i < 0 for i in ids):
            # a symbol missing from the vocab (truncated assets): the Python
            # encoder raises for it as it always does
            return super().encode(text)
        return ids

    def __del__(self):
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_handle", None)
        if lib is not None and h:
            lib.ofa_bpe_free(h)
            self._handle = None


def build(encoder_json: str, vocab_bpe: str) -> NativeGPT2BPE:
    """The native encoder over the assets; raises when the library cannot be
    built or loaded."""
    return NativeGPT2BPE(encoder_json, vocab_bpe)
