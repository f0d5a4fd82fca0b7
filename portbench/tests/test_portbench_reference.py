"""The float32 reference against the port at a tiny width on the CPU,
through the harness: tiny cells added by files and entries alone run end to
end and come out correct, their hypotheses' log-probabilities and their
training steps matching the reference to float32 rounding."""

import pytest

from conftest import run_tiny


@pytest.mark.parametrize("cell", ["tiny.caption", "tiny.ground"])
def test_serving_matches_the_reference(tiny_root, cell):
    result, compared = run_tiny(tiny_root, cell)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert compared["gap_mean"]["value"] ** 2 + compared["gap_sd"]["value"] ** 2 < 1e-8
    assert set(result["metrics"]) == {"serve_tokens_per_s", "serve_p95_ms", "setup_s"}
    assert result["device"]["platform"] == "cpu"


def test_training_matches_the_reference(tiny_root):
    result, compared = run_tiny(tiny_root, "tiny.train")
    assert result["correct"] and result["attempted"] > 0
    assert compared["loss1_rel"]["value"] < 1e-5
    assert compared["grad_leaf_gap"]["value"] < 1e-4 and compared["change_leaf_gap"]["value"] < 1e-4
    assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("cell", ["tiny.caption", "tiny.train"])
def test_traced_run_reads_what_the_cpu_has(tiny_root, cell):
    """A traced CPU run prints only what a CPU can give: the counters, and
    no device metric."""
    result, _ = run_tiny(tiny_root, cell, trace=True)
    assert result["correct"]
    device_metrics = {"mfu.serve", "mfu.train", "idle.serve", "idle.train", "attn_roofline.serve",
                      "attn_roofline.train", "launches_per_token.caption", "launches_per_update.train",
                      "peak_mem_gib.train"}
    assert not set(result["metrics"]) & device_metrics
    if cell == "tiny.caption":
        assert result["metrics"]["batch_occupancy.serve"]["value"] == 100.0
