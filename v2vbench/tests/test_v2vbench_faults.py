"""The check catches the faults that a cell can have: the run driven with the
timed path broken underneath (``faults.py``) comes out not correct."""

from __future__ import annotations

import pytest

from v2vbench.tests.helpers import run_cell, tiny_copy


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("v2vbench")))


@pytest.mark.parametrize("fault", ["stale_step", "half_batch", "altered_answer"])
@pytest.mark.parametrize("cell", ["i2vgen-tiny.edit2", "consisti2v-tiny.edit2",
                                  "i2vgen-tiny.invert2"])
def test_fault_is_not_correct(copy, cell, fault):
    rc, result, err = run_cell(copy, cell, seed=2 ** 31 + 7, module="v2vbench.tests.faults",
                               pre=(fault,))
    assert rc == 0 and result is not None, err[-3000:]
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", ["i2vgen-tiny.invert2", "i2vgen-tiny.invert2host"])
def test_per_frame_temporal_norm_is_not_correct(copy, cell):
    """The temporal transformer's group norm per frame, where the published
    modules take it over the clip's frames, comes out not correct. (At the
    tiny edit's size it moves the UNet's output by about 4 %, under that
    cell's limit of 8 %.)"""
    rc, result, err = run_cell(copy, cell, seed=2 ** 31 + 7, module="v2vbench.tests.faults",
                               pre=("per_frame_norm",))
    assert rc == 0 and result is not None, err[-3000:]
    assert result["correct"] is False, result["checks"]
