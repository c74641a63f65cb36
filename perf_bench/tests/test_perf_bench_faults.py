"""A run with its timed path broken underneath comes out not correct.

Each test drives ``run.execute`` on the CPU (past the harness's look for a
card) at a tiny size, with one fault the cell can have planted in the
program: an answer altered where it is produced, in every stream or in a
few streams or segments alone (the serving cells), a step that leaves its
state unchanged, and half of the batch left out with the mean taken over
the rest (the training cell).  The cells have one chip
each, so there is no exchange between chips to leave out."""

import pytest
import torch

from perf_bench import run

TINY = {
    "stream-4096x100": {"streams": 6, "chunk_frames": 10, "segment_chunks": 3, "sample_streams": 2,
                        "check_streams": 4, "warmup_chunks": 1},
    "frame-b1": {"segment_frames": 30, "segments": 2, "check_segments": 3},
    "train-32x2000": {"sequences": 8, "sequence_frames": 20, "batch": 4},
}


def execute(name: str, seconds: float = 0.5, **traffic) -> dict:
    cell = run.load_cell(name)
    cell.traffic.update(TINY[name], **traffic)
    return run.execute(cell, 2**31 + 77, seconds, False, "cpu")


def caught_by_the_count_alone(result: dict) -> bool:
    """Not correct, with the medians within their limits and a ``_far``
    count over its own."""
    c = result["compared"]
    medians = all(v["value"] <= v["limit"] for k, v in c.items() if not k.endswith("_far"))
    counts = any(v["value"] > v["limit"] for k, v in c.items() if k.endswith("_far"))
    return result["correct"] is False and medians and counts


def test_stream_answer_altered():
    from nnnoiseless_tpu_torch.denoise import StreamBatch

    real = StreamBatch.process_tensor

    def altered(self, frames):
        out, vad = real(self, frames)
        out, vad = out.clone(), vad.clone()
        out[:, out.shape[1] // 2] = 0.0  # one frame of each chunk lost
        vad[:, vad.shape[1] // 2] = 1.0 - vad[:, vad.shape[1] // 2]
        return out, vad

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(StreamBatch, "process_tensor", altered)
        assert execute("stream-4096x100")["correct"] is False


def test_stream_every_eighth_stream_altered():
    from nnnoiseless_tpu_torch.denoise import StreamBatch

    real = StreamBatch.process_tensor

    def altered(self, frames):
        out, vad = real(self, frames)
        out = out.clone()
        out[::8] = 0.0  # one stream in eight lost, the rest right
        return out, vad

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(StreamBatch, "process_tensor", altered)
        result = execute("stream-4096x100", streams=32, sample_streams=32, check_streams=512)
    assert caught_by_the_count_alone(result)


def test_frame_answer_altered():
    from nnnoiseless_tpu_torch.denoise import DenoiseState

    real, calls = DenoiseState.process_frame, [0]

    def altered(self, frame):
        out, vad = real(self, frame)
        calls[0] += 1
        return (out * 0.0, 1.0 - vad) if calls[0] % 3 == 0 else (out, vad)  # every third answer lost

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DenoiseState, "process_frame", altered)
        result = execute("frame-b1", seconds=2.0)
    assert result["attempted"] >= 3 and result["correct"] is False


def test_frame_every_fourth_segment_altered():
    from nnnoiseless_tpu_torch.denoise import DenoiseState

    real, calls = DenoiseState.process_frame, [0]
    seg = 10
    warm = run.load_cell("frame-b1").traffic["warmup_frames"]  # calls before the window

    def altered(self, frame):
        out, vad = real(self, frame)
        calls[0] += 1
        return (out * 0.0, vad) if (calls[0] - 1 - warm) // seg % 4 == 1 else (out, vad)  # one segment in four lost

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DenoiseState, "process_frame", altered)
        result = execute("frame-b1", seconds=2.0, segment_frames=seg, check_segments=512)
    assert result["attempted"] >= 6 * seg and caught_by_the_count_alone(result)


def test_train_state_unchanged():
    from nnnoiseless_tpu_torch.training import losses, train
    from nnnoiseless_tpu_torch.training.network import sequence_forward

    def frozen(model, opt, data, idx, seq_w):
        with torch.no_grad():
            batch = {k: v.index_select(0, idx) for k, v in data.items()}
            g, v = sequence_forward(model, batch["features"])
            sw = seq_w.index_select(0, idx)[:, None].expand(batch["vad"].shape[:2])
            return losses.total_loss(batch["gains"], g, batch["vad"], v, sw) + losses.l2_regularization(model)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train, "train_step_indexed", frozen)
        assert execute("train-32x2000")["correct"] is False


def test_train_half_batch_left_out():
    from nnnoiseless_tpu_torch.training import train

    real = train.train_step_indexed

    def half(model, opt, data, idx, seq_w):
        return real(model, opt, data, idx[: idx.shape[0] // 2], seq_w)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train, "train_step_indexed", half)
        assert execute("train-32x2000")["correct"] is False


@pytest.mark.parametrize("name", sorted(TINY))
def test_sound_run_is_correct(name):
    assert execute(name)["correct"] is True
