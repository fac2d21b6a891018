"""The check sees a broken timed path. Each run skips the look for a card
and drives the rest of a run of the tiny cell on the CPU (one step of two
images), with one fault planted under ``serve`` (``asr_bench.faults``) as
``calibrate`` plants it on the card; the fault must turn ``correct`` false,
and the same run without it must stay true. The limits here lie between
the sound run's readings and the faults' at this size and seed. The fault
of an exchange between chips has no place on one card."""

import pytest

from asr_bench import run
from asr_bench.faults import FAULTS
from asr_bench.tests.tiny import CELL, make_tree, tiny_bands

SEED = 13
LIMITS = {"violation_pct": 1.0, "flip_margin": 1.0, "solve_miss_pct": 30.0}


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    """One run with the control and every fault beside the program."""
    tree = make_tree(str(tmp_path_factory.mktemp("tree")), limits=LIMITS)
    with tiny_bands():
        return run.run_cell(tree, CELL, SEED, 0.0, False, "cpu", control=True,
                            faults=sorted(FAULTS))


def test_sound_run_is_correct(result):
    assert result["correct"] is True, result["checks"]


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_fault_is_caught(result, name):
    variant = result["detail"]["variants"][name]
    assert variant["correct"] is False, (name, variant["numbers"])


def test_control_is_not_correct(result):
    """The control, the reference with its network in float8 put in the
    program's place, is judged by the same numbers and limits."""
    variant = result["detail"]["variants"]["control"]
    assert variant["correct"] is False, variant["numbers"]


def test_solve_fault_is_caught_by_the_moved_pixels(result):
    """A solve that returns its state leaves the moved pixels where they
    started, whatever the bands of the other numbers."""
    sound = result["detail"]["reading"]
    fault = result["detail"]["variants"]["solve_returns_its_state"]
    assert sound["by_kind"]["aug"]["solve_moved"] > 0
    assert fault["numbers"]["solve_miss_pct"] > LIMITS["solve_miss_pct"]
    assert sound["numbers"]["solve_miss_pct"] < LIMITS["solve_miss_pct"]
