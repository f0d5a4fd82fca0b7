"""The port's C++ GPT-2 BPE encoder (ofasys_torch/csrc/host/bpe_encode.cpp,
built with the host's C++ compiler) against ofasys_tpu's Python GPT2BPE.

On a merge table learned here by BPE training (the helper of
tests/test_native_bpe.py, written as encoder.json + vocab.bpe), the port's
``NativeGPT2BPE`` gives ofasys_tpu's ids on the fixed cases, 300 seeded
fuzz strings over many scripts and one line of more than 4,096 ids (the
buffer regrow), and decodes them back. ``build_tokenizer`` picks it unless
``OFASYS_NATIVE_BPE=0``; a failed build raises, naming that switch. The
committed ``unicode_tables.h`` is what the generator writes. A host
library is rebuilt when its source or a shared header is newer, and
processes that build it at once all load a whole library.
"""

import json
import os
import random
import subprocess
import sys

import pytest
import torch

from ofasys_tpu.preprocessor.tokenizer.gpt2_bpe import GPT2BPE as JGPT2BPE
from ofasys_torch.ops import host_build
from ofasys_torch.preprocessor.tokenizer import gpt2_bpe, native_bpe
from ofasys_torch.tools import gen_unicode_tables

from test_native_bpe import CASES, CORPUS, train_bpe

FUZZ_POOL = (
    "abcdefXYZ 0123456789 .,!?'\"-_()[] \t\n"
    "äöüßçéñ Ωλφ жзд 中文字 かなカナ 한글 🙂🚀𝔘"
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    enc, merges = train_bpe(CORPUS)
    d = tmp_path_factory.mktemp("bpe")
    enc_path, bpe_path = str(d / "encoder.json"), str(d / "vocab.bpe")
    with open(enc_path, "w", encoding="utf-8") as f:
        json.dump(enc, f, ensure_ascii=False)
    with open(bpe_path, "w", encoding="utf-8") as f:
        f.write("#version: test\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
    return enc_path, bpe_path


@pytest.fixture(scope="module")
def pair(assets):
    return JGPT2BPE(*assets), native_bpe.NativeGPT2BPE(*assets)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_native_matches_jax_on_cases(pair, case):
    ref, nat = pair
    assert nat.encode(CASES[case]) == ref.encode(CASES[case]), repr(CASES[case])


def test_native_matches_jax_fuzz(pair):
    ref, nat = pair
    rng = random.Random(0)
    for _ in range(300):
        s = "".join(rng.choice(FUZZ_POOL) for _ in range(rng.randrange(0, 60)))
        assert nat.encode(s) == ref.encode(s), repr(s)


def test_long_line_buffer_regrow(pair):
    """A line of more than 4,096 ids takes the -(needed) retry; the grown
    buffer then serves the short lines too."""
    ref, nat = pair
    words = CORPUS.split()
    rng = random.Random(3)
    big = " ".join(rng.choice(words) for _ in range(3000))
    want = ref.encode(big)
    assert len(want) > native_bpe._INITIAL_IDS
    assert nat.encode(big) == want
    assert len(nat._buffer()) >= len(want)
    assert nat.encode(CASES[0]) == ref.encode(CASES[0])


def test_decode_roundtrip(pair):
    ref, nat = pair
    for s in CASES:
        assert nat.decode(nat.encode(s)) == ref.decode(ref.encode(s)) == s


def test_build_tokenizer_picks_native_unless_switched_off(assets, monkeypatch):
    monkeypatch.delenv("OFASYS_NATIVE_BPE", raising=False)
    tok = gpt2_bpe.build_tokenizer("gpt2", encoder_json=assets[0], vocab_bpe=assets[1])
    assert type(tok) is native_bpe.NativeGPT2BPE
    monkeypatch.setenv("OFASYS_NATIVE_BPE", "0")
    tok = gpt2_bpe.build_tokenizer("gpt2", encoder_json=assets[0], vocab_bpe=assets[1])
    assert type(tok) is gpt2_bpe.GPT2BPE


def test_failed_build_raises(assets, monkeypatch, tmp_path):
    """With CXX naming a compiler that does not exist, the library cannot be
    built: the encoder raises, and build_tokenizer names OFASYS_NATIVE_BPE=0."""
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(host_build, "_libs", {})
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.delenv("OFASYS_NATIVE_BPE", raising=False)
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native_bpe.NativeGPT2BPE(*assets)
    with pytest.raises(RuntimeError, match="OFASYS_NATIVE_BPE=0"):
        gpt2_bpe.build_tokenizer("gpt2", encoder_json=assets[0], vocab_bpe=assets[1])


def test_serialized_tables_match_ofasys_tpu(assets):
    from ofasys_tpu.preprocessor.tokenizer import native_bpe as jnative

    blob = native_bpe._serialize_tables(gpt2_bpe.GPT2BPE(*assets))
    assert blob == jnative._serialize_tables(JGPT2BPE(*assets))


def test_symbol_outside_the_byte_alphabet_raises(assets, tmp_path):
    with open(assets[0], encoding="utf-8") as f:
        enc = json.load(f)
    enc["two words"] = len(enc)
    path = tmp_path / "encoder.json"
    path.write_text(json.dumps(enc, ensure_ascii=False), encoding="utf-8")
    with pytest.raises(KeyError):
        native_bpe.NativeGPT2BPE(str(path), assets[1])


def test_unicode_tables_are_generated(tmp_path):
    out = tmp_path / "unicode_tables.h"
    gen_unicode_tables.main([str(out)])
    assert out.read_text() == (host_build.HOST_CSRC / "unicode_tables.h").read_text()


@pytest.mark.parametrize("newer", ["none", "source", "header"])
def test_host_library_is_fresh_only_while_newer_than_source_and_headers(tmp_path, monkeypatch, newer):
    csrc, build = tmp_path / "host", tmp_path / "_build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(host_build, "HOST_CSRC", csrc)
    monkeypatch.setattr(host_build, "BUILD_DIR", build)
    assert not host_build._fresh("k")
    for path, t in ((csrc / "k.cpp", 1000), (csrc / "tables.h", 1000), (build / "libk.so", 2000)):
        path.write_text("")
        os.utime(path, (t, t))
    if newer != "none":
        os.utime(csrc / ("k.cpp" if newer == "source" else "tables.h"), (3000, 3000))
    assert host_build._fresh("k") == (newer == "none")


_BUILD_CHILD = r"""
import sys
from pathlib import Path
from ofasys_torch.ops import host_build
host_build.BUILD_DIR = Path(sys.argv[1])
lib = host_build.load("line_locate")
print(lib.ofa_line_locate(sys.argv[2].encode(), (sys.argv[2] + ".idx").encode()))
"""


def test_concurrent_builds(tmp_path):
    """Six processes build the same library into one directory at once (as
    six test workers may): each loads a whole library and runs it."""
    build, data = tmp_path / "_build", tmp_path / "data"
    data.mkdir()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    procs = []
    for i in range(6):
        (data / f"{i}.tsv").write_text("a\tb\n" * (i + 1))
        procs.append(subprocess.Popen([sys.executable, "-c", _BUILD_CHILD, str(build), str(data / f"{i}.tsv")],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env))
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        assert out.strip() == "0"
    assert sorted(os.listdir(build)) == ["libline_locate.so"]
    for i in range(6):
        assert (data / f"{i}.tsv.idx").read_bytes()[:8] == (i + 1).to_bytes(8, "little")
