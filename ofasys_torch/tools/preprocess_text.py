"""Offline text tokenization (counterpart of
ofasys_tpu/tools/preprocess_text.py): encode a text file line by line with
a tokenizer into an .npy id array for fixed-block LM pretraining.

    python -m ofasys_torch.tools.preprocess_text in.txt out.npy [tokenizer]

``tokenizer`` is a ``build_tokenizer`` name (default ``bytes``).
"""

import sys

import numpy as np

from ofasys_torch.preprocessor.tokenizer.gpt2_bpe import build_tokenizer


def main(argv):
    if len(argv) < 2:
        print(__doc__)
        return 2
    src, out = argv[0], argv[1]
    tok = build_tokenizer(argv[2] if len(argv) > 2 else "bytes")
    ids = []
    with open(src) as f:
        for line in f:
            ids.extend(tok.encode(line.rstrip("\n")))
    np.save(out, np.asarray(ids, np.int32))
    print(f"{src}: {len(ids)} tokens -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
