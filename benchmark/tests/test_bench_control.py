"""The control: the reference in the program's place, computed with every
conv and dense layer's input and weight rounded to float8 e4m3.  At a size
that the CPU holds, its numbers read far above the program's; on a card, at
the cell's own size, it fails the cell's limits (``control.py`` reads it
over several seeds)."""

from __future__ import annotations

import pytest
import torch

import harness
import judge
from conftest import small_copy
from reference.maskrcnn import fp8_e4m3


def _readings(cell, seed):
    drv = cell.driver()
    state = drv.setup(cell, seed)
    drv.window(state, 0.5)
    drv.release(state)
    sound, limits = drv.judge(state)
    control, _ = drv.control(state, fp8_e4m3)
    drv.close(state)
    return sound, control, limits


def test_the_control_reads_far_above_the_program(tmp_path):
    torch.set_num_threads(4)
    cell = harness.Cell("r101_tile_stream", small_copy(tmp_path))
    sound, control, limits = _readings(cell, 2 ** 31 + 99)
    assert control["judged_detections"] > 0
    for k in limits:
        assert control[k] >= 3 * sound[k], (k, sound[k], control[k])


@pytest.mark.gpu
def test_the_control_fails_the_limits_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    cell = harness.Cell("r101_tile_stream")
    _, control, limits = _readings(cell, 2 ** 31 + 101)
    assert not judge.verdict(control, limits), control


def test_fp8_rounding_keeps_three_mantissa_bits():
    t = torch.tensor([448.0, 1.0, 1.0625, -3.3, 0.0])
    q = fp8_e4m3(t)
    assert q[0] == 448.0 and q[1] == 1.0 and q[2] == 1.0 and q[4] == 0.0
    assert q[3] == pytest.approx(-3.25)
