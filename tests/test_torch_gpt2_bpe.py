"""ofasys_torch's tokenizers (preprocessor/tokenizer/) against ofasys_tpu's.

GPT-2 BPE on a merge table learned here with the textbook procedure
(as tests/test_native_bpe.py learns one) and written as encoder.json +
vocab.bpe: ids and decoded text equal ofasys_tpu's Python GPT2BPE across
scripts, contractions, whitespace shapes, <|endoftext|> and unicode fuzz,
with the ``regex`` word split and with the ``re`` fallback forced on both
sides. Also the WordPiece and character tokenizers, ``build_tokenizer``'s
names, and a ``bpe='gpt2'`` text preprocessor (through the ConfigStore)
giving ofasys_tpu's dictionary and collated batches.
"""

import collections
import importlib
import json
import random
import sys

import numpy as np
import pytest

from ofasys_tpu.configure import ConfigStore as JConfigStore
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.preprocessor.general import GeneralPreprocess as JGeneralPreprocess
from ofasys_tpu.preprocessor.instruction import Instruction as JInstruction
from ofasys_tpu.preprocessor.tokenizer import gpt2_bpe as jbpe
from ofasys_torch.configure import ConfigStore
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess
from ofasys_torch.preprocessor.instruction import Instruction
from ofasys_torch.preprocessor.tokenizer import gpt2_bpe as tbpe

CORPUS = (
    "the quick brown fox jumps over the lazy dog. "
    "The Quick Brown Fox! don't can't won't it's we're they've I'll he'd "
    "hello world hello there hello again 12345 3.14159 100,000 "
    "naïve café jalapeño übermäßig çağrı Ελληνικά русский 中文分词 日本語 한국어 "
    "🙂🚀 emoji test 🙂 tabs\tand\nnewlines   multiple   spaces "
) * 4
TEXTS = [
    "the quick brown fox", "Don't stop; it's 3.14159!", "  leading and   inner   spaces  ",
    "tabs\tand\nnewlines\n\n", "naïve café Ελληνικά русский 中文分词 日本語 한국어",
    "🙂🚀 emoji", "hello<|endoftext|>world", "", " ", "100,000 items at $4.99 each",
]


def train_bpe(corpus, n_merges=200):
    """Classic BPE training on byte-unicode symbol sequences."""
    be = jbpe.bytes_to_unicode()
    words = collections.Counter()
    for w in corpus.split(" "):
        if w:
            words[tuple(be[b] for b in w.encode("utf-8"))] += 1
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for word, c in words.items():
            for i in range(len(word) - 1):
                pairs[(word[i], word[i + 1])] += c
        if not pairs:
            break
        (a, b), cnt = pairs.most_common(1)[0]
        if cnt < 2:
            break
        merges.append((a, b))
        new_words = collections.Counter()
        for word, c in words.items():
            out, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            new_words[tuple(out)] += c
        words = new_words
    seen, toks = set(), []
    for t in [be[i] for i in range(256)] + [a + b for a, b in merges] + ["<|endoftext|>"]:
        if t not in seen:
            seen.add(t)
            toks.append(t)
    return {t: i for i, t in enumerate(toks)}, merges


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    enc, merges = train_bpe(CORPUS)
    d = tmp_path_factory.mktemp("bpe")
    enc_path, bpe_path = str(d / "encoder.json"), str(d / "vocab.bpe")
    with open(enc_path, "w", encoding="utf-8") as f:
        json.dump(enc, f, ensure_ascii=False)
    with open(bpe_path, "w", encoding="utf-8") as f:
        f.write("#version: test\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return enc_path, bpe_path


def _fuzz(n=60, seed=0):
    rng = random.Random(seed)
    pool = "abcxyz ABC 019 .,;:!?'\"-\t\n éüñ Ωж中日한🙂"
    return ["".join(rng.choice(pool) for _ in range(rng.randint(0, 40))) for _ in range(n)]


def _same(assets):
    j, t = jbpe.GPT2BPE(*assets), tbpe.GPT2BPE(*assets)
    assert t.vocab_size == j.vocab_size
    for text in TEXTS + _fuzz():
        ids = t.encode(text)
        assert ids == j.encode(text), repr(text)
        assert t.decode(ids) == j.decode(ids) == text.encode("utf-8").decode("utf-8", "replace")


def test_gpt2_bpe_matches_ofasys_tpu(assets):
    assert tbpe.REGEX_BACKEND == "regex"
    _same(assets)
    assert tbpe.bytes_to_unicode() == jbpe.bytes_to_unicode()


def test_gpt2_bpe_re_fallback_matches_ofasys_tpu(assets):
    """Without the regex package both sides split words with re's ASCII
    classes (the card machine may lack regex)."""
    real = sys.modules.get("regex")
    sys.modules["regex"] = None
    try:
        importlib.reload(jbpe)
        importlib.reload(tbpe)
        assert tbpe.REGEX_BACKEND == "re" and jbpe._PAT.pattern == tbpe._PAT.pattern
        _same(assets)
    finally:
        sys.modules["regex"] = real
        importlib.reload(jbpe)
        importlib.reload(tbpe)
    assert tbpe.REGEX_BACKEND == "regex"


def test_wordpiece_and_character_tokenizers(tmp_path):
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("[UNK]\nthe\nquick\n##est\nbrown\nfox\n##es\nun\n##known\n")
    j, t = jbpe.WordPieceTokenizer(str(vocab)), tbpe.WordPieceTokenizer(str(vocab))
    for text in ("The quickest brown foxes", "unknown zebra", "", "THE FOX"):
        assert t.encode(text) == j.encode(text)
        assert t.decode(t.encode(text)) == j.decode(j.encode(text))
    jc, tc = jbpe.CharacterTokenizer(), tbpe.CharacterTokenizer()
    for text in TEXTS:
        assert tc.encode(text) == jc.encode(text) and tc.decode(tc.encode(text)) == jc.decode(jc.encode(text))
    assert tc.vocab_size == jc.vocab_size == 65536


def test_build_tokenizer_names(assets, tmp_path, monkeypatch):
    from ofasys_torch.preprocessor.tokenizer import native_bpe

    enc, bpe = assets
    monkeypatch.delenv("OFASYS_NATIVE_BPE", raising=False)
    for name in ("gpt2", "gpt2_bpe"):
        # the C++ encoder by default, the Python one under OFASYS_NATIVE_BPE=0
        assert isinstance(tbpe.build_tokenizer(name, encoder_json=enc, vocab_bpe=bpe),
                          native_bpe.NativeGPT2BPE)
        monkeypatch.setenv("OFASYS_NATIVE_BPE", "0")
        assert isinstance(tbpe.build_tokenizer(name, encoder_json=enc, vocab_bpe=bpe), tbpe.GPT2BPE)
        monkeypatch.delenv("OFASYS_NATIVE_BPE")
    assert isinstance(tbpe.build_tokenizer("bytes"), tbpe.ByteTokenizer)
    for name in ("characters", "char"):
        assert isinstance(tbpe.build_tokenizer(name), tbpe.CharacterTokenizer)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("[UNK]\na\n")
    for name in ("wordpiece", "bert_file", "bert"):
        assert isinstance(tbpe.build_tokenizer(name, vocab_file=str(vocab)), tbpe.WordPieceTokenizer)
    with pytest.raises(ValueError):
        tbpe.build_tokenizer("sentencepiece")
    with pytest.raises(ValueError):
        jbpe.build_tokenizer("sentencepiece")
    # the assets from $OFA_CACHE_HOME, as ofasys_tpu reads them
    monkeypatch.setenv("OFA_CACHE_HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="OFA_CACHE_HOME"):
        tbpe.build_tokenizer("gpt2")
    (tmp_path / "encoder.json").write_text(open(enc, encoding="utf-8").read(), encoding="utf-8")
    (tmp_path / "vocab.bpe").write_text(open(bpe, encoding="utf-8").read(), encoding="utf-8")
    assert tbpe.build_tokenizer("gpt2").encode("hello world") == jbpe.GPT2BPE(enc, bpe).encode("hello world")


@pytest.fixture
def gpt2_store(assets):
    """bpe='gpt2' with the test table in both packages' ConfigStores."""
    saved = []
    for store in (ConfigStore(), JConfigStore()):
        cfg = store.get("ofasys.preprocess", "text").config
        saved.append((cfg, cfg.bpe, cfg.encoder_json, cfg.vocab_bpe))
        store.override("ofasys.preprocess.text.bpe", "gpt2")
        store.override("ofasys.preprocess.text.encoder_json", assets[0])
        store.override("ofasys.preprocess.text.vocab_bpe", assets[1])
    yield
    for cfg, *values in saved:
        cfg.bpe, cfg.encoder_json, cfg.vocab_bpe = values


def test_gpt2_text_preprocess_matches_ofasys_tpu(gpt2_store, monkeypatch):
    monkeypatch.setenv("OFASYS_NATIVE_BPE", "0")   # ofasys_tpu's Python GPT2BPE
    jd, td = JDictionary(), Dictionary()
    jgp, tgp = JGeneralPreprocess(jd, active=["text"]), GeneralPreprocess(td, active=["text"])
    assert type(tgp.name2pre["text"].bpe).__name__ == "GPT2BPE"
    assert jd.state_dict() == td.state_dict()
    recs = [{"src": t or "x", "tgt": TEXTS[(i + 3) % len(TEXTS)] or "y"} for i, t in enumerate(TEXTS)]
    for tpl, split in (("[TEXT:src] -> [TEXT:tgt]", "train"),
                       ('what is the complete text of " [TEXT:src,mask_ratio=0.3] "? -> [TEXT:src]',
                        "train"),
                       ("[TEXT:src] -> [TEXT:tgt]", "test")):
        js = jgp.collate([jgp(JInstruction(tpl, split=split).format(**r)) for r in recs])
        ts = tgp.collate([tgp(Instruction(tpl, split=split).format(**r)) for r in recs])
        for a, b in zip(js["net_input"]["slots"], ts["net_input"]["slots"], strict=True):
            for k, v in a.value.items():
                if v is not None:
                    np.testing.assert_array_equal(np.asarray(v), np.asarray(b.value[k]), err_msg=k)
        for k in ("target", "ntokens", "nsentences"):
            np.testing.assert_array_equal(np.asarray(js[k]), np.asarray(ts[k]))
    text = "the quick brown fox"
    assert tgp.name2pre["text"].decode(tgp.name2pre["text"].encode(text)) == text
