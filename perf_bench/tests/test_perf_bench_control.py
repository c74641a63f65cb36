"""The control, the plain reference computed with TF32 products in the
program's place, comes out not correct (on a card: TF32 exists only
there).  ``python -m pytest perf_bench/tests -q -m cuda`` on the card."""

import pytest
import torch

from perf_bench import control, run
from perf_bench.drivers import serve_check

SMALL = {
    "stream-4096x100": {"streams": 64, "segment_chunks": 2, "sample_streams": 4, "check_streams": 8},
    "frame-b1": {"segment_frames": 200, "segments": 2, "check_segments": 2},
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 products exist only there")
    return torch.device("cuda:0")


def _fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > lim for k, lim in serve_check.compared(limits).items())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_serving_control_fails(name):
    dev = _card()
    cell = run.load_cell(name)
    cell.traffic.update(SMALL[name])
    got = control.serve_seed(cell, 2**31 + 5, 1.0, True, dev)
    assert not _fails(got["program"], cell.limits)
    assert _fails(got["control"], cell.limits)


@pytest.mark.cuda
def test_training_control_and_half_batch_fail():
    from perf_bench.drivers.train import Cell

    dev = _card()
    cell = run.load_cell("train-32x2000")
    cell.traffic.update(sequences=64, sequence_frames=200)
    cell_run = Cell(cell, 2**31 + 5, dev)
    cell_run.setup()
    got = control.train_seed(cell_run, 2**31 + 5, True, True)
    assert not _fails(got["program"], cell.limits)
    assert _fails(got["control"], cell.limits)
    assert _fails(got["half_batch"], cell.limits)
