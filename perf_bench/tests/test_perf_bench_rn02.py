"""The cell this benchmark gained with RNNoise 0.2's trainer: its files
found by name, its readers, and CPU runs of the rn02 driver at a
small size (65 -> 16 -> 24 convolution widths, GRUs of 24, 20 frames) with
a fault planted in the program, each of which reads not correct: the 2018
network's reset-before GRU cell, the loss without its target shaping, half
of each batch left out.  On a card, the reference's TF32 control reads not
correct at the published widths."""

import pytest
import torch
import torch.nn.functional as F

from perf_bench import counts_rn02, run
from perf_bench.trace import Trace

SMALL = {"cond_size": 16, "gru_size": 24}
TINY = {"sequences": 8, "sequence_frames": 20, "batch": 4}


def execute(seconds: float = 0.5) -> dict:
    cell = run.load_cell("rn02-train-128x2000")
    cell.config.update(SMALL)
    cell.traffic.update(TINY)
    return run.execute(cell, 2**31 + 77, seconds, False, "cpu")


def test_the_cell_resolves_and_every_metric_has_a_reader():
    cell = run.load_cell("rn02-train-128x2000")
    assert [m["name"] for m in cell.end_to_end][-1] == "setup_s" and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(run.load_reader(m["name"]))


def test_the_rn02_cell_is_the_published_network_at_the_recipes_batch():
    cell = run.load_cell("rn02-train-128x2000")
    c, tr = cell.config, cell.traffic
    assert (c["input_dim"], c["cond_size"], c["gru_size"], c["output_dim"]) == (65, 128, 384, 32)
    assert (tr["batch"], tr["sequence_frames"], tr["driver"]) == (128, 2000, "train_rn02")
    assert counts_rn02.macs() == c["macs_per_frame"] == 2_877_312
    assert [m["name"] for m in cell.end_to_end] == ["train_step_ms", "setup_s"]


def test_readers_on_a_hand_built_trace():
    ops = [(f"op{i}", 10.0 * i, 2.0 * (i + 1)) for i in range(10)]
    tr = Trace(window_s=1.0, units=1, ops=list(reversed(ops)))
    phases = {"forward.front": 2, "forward.gru": 3, "forward.head": 1, "loss": 1, "backward": 2, "optimizer": 1}
    ctx = {"trace": tr, "program": {"graph_nodes": 10, "phase_nodes": phases, "warmup_s": 2.0, "capture_s": 3.0},
           "window": {"train_step_ms": 1000.0, "batch": 128, "sequence_frames": 2000},
           "cell": run.load_cell("rn02-train-128x2000")}
    read = lambda name, c=ctx: run.load_reader(name)(c)
    assert read("rn02_gru_fwd_ms") == pytest.approx((6 + 8 + 10) / 1e3)
    assert read("rn02_backward_ms") == pytest.approx((16 + 18) / 1e3)
    # the 2018 cell's trainer readers read this cell's program and trace as they are
    assert read("train_graph_nodes") == 10 and read("train_device_ops") == 10
    assert read("train_capture_s") == 5.0
    assert read("rn02_train_mfu") == pytest.approx(100 * 4.419551232e12 / 67e12)
    # another count of operations than of nodes, or no marks: nothing
    for program in ({"graph_nodes": 11, "phase_nodes": phases}, {"graph_nodes": 10}, {}):
        c = dict(ctx, program=program)
        assert read("rn02_gru_fwd_ms", c) is None and read("rn02_backward_ms", c) is None


def test_sound_run_is_correct():
    assert execute()["correct"] is True


def test_reset_before_gru_is_not_correct():
    from nnnoiseless_tpu_torch.training import rn02

    def reset_before(layer, xw, h):
        n = h.shape[1]
        w, b = layer["weight_hh_l0"], layer["bias_hh_l0"]
        x_rz, x_n = xw.split((2 * n, n), 1)
        r, z = torch.sigmoid(x_rz + F.linear(h, w[: 2 * n], b[: 2 * n])).split(n, 1)
        return torch.lerp(torch.tanh(x_n + F.linear(r * h, w[2 * n :], b[2 * n :])), h, z)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rn02, "gru_step", reset_before)
        assert execute()["correct"] is False


def test_loss_without_target_shaping_is_not_correct():
    from nnnoiseless_tpu_torch.training import rn02

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rn02, "target_gains", lambda g: torch.clamp(g, min=0.0))
        assert execute()["correct"] is False


def test_half_batch_left_out_is_not_correct():
    from nnnoiseless_tpu_torch.training import train

    real = train.train_step_indexed

    def half(model, opt, data, idx, seq_w):
        return real(model, opt, data, idx[: idx.shape[0] // 2], seq_w)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train, "train_step_indexed", half)
        assert execute()["correct"] is False


@pytest.mark.cuda
def test_rn02_tf32_control_fails():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 products exist only there")
    from perf_bench.drivers import train_check
    from perf_bench.drivers.train_rn02 import Cell

    cell = run.load_cell("rn02-train-128x2000")
    cell.traffic.update(sequences=64, sequence_frames=200, batch=16)
    c = Cell(cell, 2**31 + 5, torch.device("cuda:0"))
    c.setup()
    c.keep_rows()
    got = (c.losses, c.grad1, c.p_end)
    fails = lambda numbers: any(numbers[k] > lim for k, lim in cell.limits.items())
    assert not fails(train_check.numbers(got, c.reference(), c.p0))
    assert fails(train_check.numbers(c.reference(tf32=True), c.reference(), c.p0))
    assert torch.backends.cuda.matmul.allow_tf32 is False  # the control's flags restored
