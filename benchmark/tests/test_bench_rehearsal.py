"""A small rehearsal of the stream driver on the CPU against the reference:
a sound run of the program is correct, and the same run with its timed path
broken underneath is not.  The faults are those that a serving cell can
have: an answer altered where it is produced (one tile of every batch has
its boxes moved in the forward), half of every batch left out (its tiles
report no valid detection), no valid detection at all, and two faults of
the forward itself (the frozen norms' shift dropped, the box head's dx and
dy swapped in decoding)."""

from __future__ import annotations

import pytest
import torch

import harness
import judge
from conftest import small_copy


def _shift_one_tile(out):
    boxes = out.boxes.clone()
    boxes[0] += 24.0
    return out._replace(boxes=boxes)


def _drop_half(out):
    valid = out.valid.clone()
    valid[::2] = False
    return out._replace(valid=valid)


def _drop_all(out):
    return out._replace(valid=torch.zeros_like(out.valid))


def _on_output(fault):
    def plant(monkeypatch):
        from treedetection_tpu_torch.models.mask_rcnn import MaskRCNN
        forward = MaskRCNN.forward
        monkeypatch.setattr(MaskRCNN, "forward",
                            lambda self, *a, **k: fault(forward(self, *a,
                                                                **k)))
    return plant


def _norm_shift_dropped(monkeypatch):
    from treedetection_tpu_torch.models.resnet import FrozenBN
    monkeypatch.setattr(FrozenBN, "forward", lambda self, x: x * self.scale.to(
        x.dtype)[:, None, None])


def _box_dx_dy_swapped(monkeypatch):
    from treedetection_tpu_torch.models import roi_heads
    decode = roi_heads.apply_deltas
    monkeypatch.setattr(roi_heads, "apply_deltas",
                        lambda d, boxes, w: decode(d[..., [1, 0, 2, 3]],
                                                   boxes, w))


FAULTS = {"altered_answer": _on_output(_shift_one_tile),
          "half_batch_dropped": _on_output(_drop_half),
          "nothing_valid": _on_output(_drop_all),
          "norm_shift_dropped": _norm_shift_dropped,
          "box_dx_dy_swapped": _box_dx_dy_swapped}


@pytest.fixture(scope="module")
def sound_state(tmp_path_factory):
    torch.set_num_threads(4)
    cell = harness.Cell("r101_tile_stream",
                        small_copy(tmp_path_factory.mktemp("bench")))
    drv = cell.driver()
    state = drv.setup(cell, 2 ** 32 + 7)
    yield drv, state
    drv.close(state)


def test_a_sound_run_is_correct(sound_state):
    drv, state = sound_state
    win = drv.window(state, 0.5)
    assert win["failed"] == 0 and win["attempted"] > 0
    numbers, limits = drv.judge(state)
    assert numbers["judged_detections"] > 0 and numbers["due_detections"] > 0
    assert judge.verdict(numbers, limits), numbers


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_run_is_not_correct(sound_state, fault, monkeypatch):
    drv, state = sound_state
    FAULTS[fault](monkeypatch)
    drv.window(state, 0.5)
    numbers, limits = drv.judge(state)
    assert not judge.verdict(numbers, limits), (fault, numbers)
