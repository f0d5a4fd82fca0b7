"""The comparison that decides ``correct`` fails where it must: a run with
the timed path broken underneath (the chip's look skipped, the rest of a
run driven) comes out not correct, once for each fault a cell can have;
and the lower-precision control (the port's own int8 paths) reads far above
a sound run at this size. The control's readings at the cells' own sizes,
from which the limits were set, are in PERF.md."""

import pytest
import torch

from conftest import run_tiny
from portbench import controls
from portbench.controls import (half_batch, int8_serving, int8_training, state_unchanged,
                                token_altered)


def test_the_controls_refuse_to_run_without_a_card(monkeypatch, capsys):
    """Their readings set the limits of the card's runs, so none is taken
    elsewhere."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert controls.main(["--workload", "ofa_huge.serve_caption", "--control", "none", "--seeds", "1"]) == 3
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cell", ["tiny.caption", "tiny.ground"])
def test_a_token_altered_where_it_is_produced_is_caught(tiny_root, cell):
    result, compared = run_tiny(tiny_root, cell, hook=token_altered)
    assert not result["correct"] and compared["gap_mean"]["value"] > 5.0


@pytest.mark.parametrize("fault", [state_unchanged, half_batch])
def test_training_faults_are_caught(tiny_root, fault):
    result, compared = run_tiny(tiny_root, "tiny.train", hook=fault)
    assert not result["correct"]
    if fault is state_unchanged:
        assert compared["change_leaf_gap"]["value"] == pytest.approx(1.0)
    else:
        assert compared["grad_leaf_gap"]["value"] > 0.1


@pytest.mark.parametrize("cell,control,number", [("tiny.caption", int8_serving, "gap_sd"),
                                                 ("tiny.train", int8_training, "grad_leaf_gap")])
def test_the_int8_control_reads_far_above_a_sound_run(tiny_root, cell, control, number):
    sound = run_tiny(tiny_root, cell, seed=21)[1][number]["value"]
    low = run_tiny(tiny_root, cell, seed=21, hook=control)[1][number]["value"]
    assert low > 100 * sound
