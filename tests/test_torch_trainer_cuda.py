"""Trainer.fit and OFASys.from_pretrained on the card (kernels B1 and B2).

A tiny model (2+2 layers) trains 3 summed two-task updates from TSV files
through Task + Trainer on CUDA, with every attention call on the dense
route: B1 and B2 launch once per attention call (12 an update), a
checkpoint is saved, and OFASys.from_pretrained of it gives the tokens of
OFASys.from_trainer on the same requests. The file imports no JAX, so it
runs on a GPU machine without it:

    python -m pytest --noconftest tests/test_torch_trainer_cuda.py
"""

import os

import numpy as np
import pytest
import torch

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA GPU")]

INFILL = 'what is the complete text of " [TEXT:text,mask_ratio=0.3] "? -> [TEXT:text]'
SUMMARY = 'what is the summary of article " [TEXT:src] "? -> [TEXT:tgt]'
WORDS = ["the", "storm", "moved", "north", "over", "coast", "on", "monday", "and", "officials"]


def _text(rng, n):
    return " ".join(rng.choice(WORDS, n))


def _tasks(root):
    from ofasys_torch import Task

    rng = np.random.default_rng(0)
    with open(os.path.join(root, "infill.tsv"), "w") as f:
        for _ in range(32):
            f.write(_text(rng, 12) + "\n")
    with open(os.path.join(root, "summary.tsv"), "w") as f:
        for _ in range(32):
            f.write(f"{_text(rng, 30)}\t{_text(rng, 6)}\n")
    infill = Task(name="infill", instruction=INFILL)
    infill.cfg.dataset.batch_size = 16
    infill.cfg.dataset.selected_cols = "0:text"
    summary = Task(name="summary", instruction=SUMMARY)
    summary.cfg.dataset.batch_size = 16
    summary.cfg.dataset.selected_cols = "0:src,1:tgt"
    return [infill.load_dataset_from_path(os.path.join(root, "infill.tsv")),
            summary.load_dataset_from_path(os.path.join(root, "summary.tsv"))]


def test_fit_save_and_from_pretrained_on_card(tmp_path, monkeypatch):
    from ofasys_torch import GeneralistModel, OFASys, Trainer, TrainerConfig
    from ofasys_torch.ops import dense_attention as tdense

    monkeypatch.setenv("OFA_CACHE_HOME", str(tmp_path))
    cfg = TrainerConfig()
    cfg.optimization.lr = (1e-3,)
    cfg.checkpoint.save_dir = str(tmp_path / "ckpt")
    cfg.checkpoint.save_interval_updates = 3
    cfg.checkpoint.no_epoch_checkpoints = True
    model = GeneralistModel(arch="tiny")
    model.cfg.encoder.layers = model.cfg.decoder.layers = 2
    tasks = _tasks(str(tmp_path))
    trainer = Trainer(cfg)
    assert trainer.device.type == "cuda"
    tdense.dense_attention_fwd.launches = tdense.dense_attention_bwd.launches = 0
    state = trainer.fit(model, tasks, max_update=3)
    assert state.step == 3
    # 2 tasks x (encoder self + decoder self + cross) x 2 layers, 3 updates
    assert tdense.dense_attention_fwd.launches == 36
    assert tdense.dense_attention_bwd.launches == 36
    last = tmp_path / "ckpt" / "checkpoint_last"
    assert last.exists() and (tmp_path / "ckpt" / "checkpoint_1_3.meta.json").exists()

    hub = OFASys.from_pretrained(str(last))
    ref = OFASys.from_trainer(trainer, tasks)
    recs = [{"src": _text(np.random.default_rng(i), 30)} for i in range(8)]
    got = hub.inference("[TEXT:src] -> [TEXT:tgt]", recs, max_len_b=8)
    want = ref.inference("[TEXT:src] -> [TEXT:tgt]", recs, max_len_b=8)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a.tokens, b.tokens)
