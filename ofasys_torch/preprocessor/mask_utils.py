"""BART-style span masking (counterpart of ofasys_tpu/preprocessor/mask_utils.py).

Numpy implementation used host-side in dataloader workers: sample span
lengths from Poisson(lambda), cover ~p of the tokens, replace each span with
a single <mask> (replace_length=1) or per-token masks, optionally substitute
a random vocab token for a fraction of masks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def add_span_mask(
    tokens: np.ndarray,
    p: float,
    mask_idx: int,
    rng: np.random.Generator,
    poisson_lambda: float = 3.0,
    random_ratio: float = 0.0,
    replace_length: int = 1,
    random_token_range: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """Returns a new 1-D int array with masked spans."""
    n = len(tokens)
    num_to_mask = int(round(n * p))
    if num_to_mask == 0 or n == 0:
        return tokens.copy()

    # sample span lengths until they cover num_to_mask
    lengths = []
    total = 0
    while total < num_to_mask:
        l = max(1, int(rng.poisson(poisson_lambda)))
        lengths.append(l)
        total += l
    if total > num_to_mask and len(lengths) > 1:
        lengths[-1] = max(1, lengths[-1] - (total - num_to_mask))

    # choose non-overlapping-ish span starts
    starts = rng.choice(n, size=min(len(lengths), n), replace=False)
    keep = np.ones(n, dtype=bool)
    is_start = np.zeros(n, dtype=bool)
    replaced: list = []
    for s, l in zip(starts, lengths):
        e = min(s + l, n)
        if not keep[s:e].all():
            continue
        keep[s:e] = False
        is_start[s] = True

    out = []
    for i, tok in enumerate(tokens):
        if keep[i]:
            out.append(int(tok))
        elif is_start[i] or replace_length == -1:
            if random_ratio > 0 and rng.random() < random_ratio and random_token_range:
                lo, hi = random_token_range
                out.append(int(rng.integers(lo, hi)))
            else:
                out.append(mask_idx)
        # interior span tokens dropped (replace_length=1 semantics)
    return np.asarray(out, dtype=tokens.dtype)
