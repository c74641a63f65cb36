"""The port's spans (nnnoiseless_tpu_torch/tracing.py): off by default,
invisible to the outputs, placed at the layer boundaries, nested and
rooted per unit, and seen by ``torch.profiler`` as host ranges.

The ``cuda`` cases need a card and skip here: there a span also carries
kernel launches and device times, and a captured program counts its
graph's nodes.  The file imports no JAX::

    NNT_TEST_PLATFORM=cuda python -m pytest tests/test_torch_tracing.py -q -m cuda
"""

import numpy as np
import pytest
import torch

import nnnoiseless_tpu_torch as nt
from nnnoiseless_tpu_torch import tracing
from nnnoiseless_tpu_torch.constants import FRAME_SIZE
from nnnoiseless_tpu_torch.ops import frame_kernel, pitch_kernel

B, T = 4, 10
FRAME_SPANS = ["frame", "frame.launch", "frame.wait"]
CHUNK_SPANS = ["chunk", "chunk.precompute", "chunk.frame_loop"]


@pytest.fixture(scope="module", params=[True, False], ids=["two_phase", "scan"])
def engine(request):
    return nt.Engine(nt.RnnModel.default(), "cpu", fused=request.param)


@pytest.fixture(scope="module")
def clip(testing_raw):
    """(frames (3, 480), chunk (B, T, 480)) of the golden clip."""
    frames = testing_raw[: 3 * FRAME_SIZE].reshape(3, FRAME_SIZE)
    chunk = testing_raw[: B * T * FRAME_SIZE].reshape(B, T, FRAME_SIZE)
    return frames, torch.as_tensor(chunk)


def _run(engine, clip):
    """3 process_frame calls, then 2 process_chunk calls at B=4, T=10."""
    frames, chunk = clip
    state = nt.DenoiseState(engine)
    outs = [state.process_frame(f) for f in frames]
    batch = nt.StreamBatch(B, model=engine)
    outs += [batch.process_tensor(chunk) for _ in range(2)]
    return outs


def test_span_off_is_the_shared_null_context(engine, clip, monkeypatch):
    assert tracing.span("frame") is tracing.OFF
    assert tracing.span("frame.launch", torch.device("cpu")) is tracing.OFF

    def opened(*args):
        raise AssertionError("a span was opened with tracing off")

    monkeypatch.setattr(tracing, "_Open", opened)
    _run(engine, clip)


def test_outputs_bit_equal_with_recording_on_and_off(engine, clip):
    off = _run(engine, clip)
    with tracing.recording():
        on = _run(engine, clip)
    for a, b in zip(off, on, strict=True):
        for x, y in zip(a, b, strict=True):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_recording_holds_the_layer_spans_nested_by_unit(engine, clip):
    with tracing.recording() as rec:
        _run(engine, clip)
    spans = rec.spans
    assert [s.name for s in spans] == FRAME_SPANS * 3 + CHUNK_SPANS * 2
    assert [s.id for s in spans] == list(range(len(spans)))
    for unit in range(5):
        root, *children = spans[3 * unit : 3 * unit + 3]
        assert root.parent is None and root.root == root.id
        for c in children:
            assert c.parent == root.id and c.root == root.id
            assert root.start_ns <= c.start_ns <= c.end_ns <= root.end_ns
        assert children[0].end_ns <= children[1].start_ns
    assert all(s.device_ms is None and s.launches == {} for s in spans)
    assert rec.ms("frame.wait") == [s.ms for s in spans if s.name == "frame.wait"]
    assert rec.ms("frame.launch", device=True) == [None] * 3
    assert tracing.span("chunk") is tracing.OFF


def test_span_counts_the_launches_made_inside_it(monkeypatch):
    monkeypatch.setattr(pitch_kernel, "launches", 5)
    monkeypatch.setattr(frame_kernel, "launches", 0)
    with tracing.recording() as rec:
        with tracing.span("chunk"):
            with tracing.span("chunk.precompute"):
                pitch_kernel.launches += 1
            with tracing.span("chunk.frame_loop"):
                frame_kernel.launches += 2
    assert [s.launches for s in rec.spans] == [{"K1": 1, "K2": 2}, {"K1": 1}, {"K2": 2}]


def test_profiler_ranges_enclose_the_phase_ops(engine, clip):
    frames, chunk = clip
    state = nt.DenoiseState(engine)
    batch = nt.StreamBatch(B, model=engine)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        state.process_frame(frames[0])
        batch.process_tensor(chunk)
    events = prof.events()
    ranges = {e.name: e.time_range for e in events if e.name.startswith("nnt.")}
    assert set(ranges) == {"nnt." + n for n in FRAME_SPANS + CHUNK_SPANS}

    def inside(outer, inner):
        return outer.start <= inner.start and inner.end <= outer.end

    aten = [e.time_range for e in events if e.name.startswith("aten::")]
    for name in ("nnt.frame.launch", "nnt.chunk.precompute", "nnt.chunk.frame_loop"):
        assert any(inside(ranges[name], r) for r in aten), name
    for name in CHUNK_SPANS[1:]:
        assert inside(ranges["nnt.chunk"], ranges["nnt." + name])
    for name in FRAME_SPANS[1:]:
        assert inside(ranges["nnt.frame"], ranges["nnt." + name])


def test_program_counts_no_graph_nodes_on_the_cpu(engine, clip):
    state = nt.DenoiseState(engine)
    state.process_frame(clip[0][0])
    assert state.program.program.graph_nodes == 0


# ---- on a card -----------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda_engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return nt.Engine(nt.RnnModel.default(), "cuda")


@pytest.mark.cuda
def test_spans_carry_the_kernel_launches_on_the_card(cuda_engine, clip):
    frames, chunk = clip
    state = nt.DenoiseState(cuda_engine)
    state.process_frame(frames[0])  # the capture
    batch = nt.StreamBatch(B, model=cuda_engine, device="cuda")
    with tracing.recording() as rec:
        state.process_frame(frames[1])
        batch.process_tensor(chunk.cuda())
        torch.cuda.synchronize()
    by = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["frame", "frame.launch", "program.replay", "frame.wait"] + CHUNK_SPANS
    assert by["program.replay"].launches == {"K3": 1, "K5": 1, "K6": 1}
    assert by["frame.launch"].launches == {"K3": 1, "K5": 1, "K6": 1}
    assert by["chunk.precompute"].launches == {"K1": 1}
    assert by["chunk.frame_loop"].launches == {"K2": 1}


@pytest.mark.cuda
def test_frame_launch_is_timed_on_the_device(cuda_engine, clip):
    frames, _ = clip
    state = nt.DenoiseState(cuda_engine)
    with tracing.recording() as rec:
        for f in frames:
            state.process_frame(f)
    names = [s.name for s in rec.spans]
    assert names[:4] == ["frame", "frame.launch", "program.replay", "frame.wait"]
    device = rec.ms("frame.launch", device=True)
    assert len(device) == 3 and all(ms > 0 for ms in device)
    assert all(s.device_ms is None for s in rec.spans if s.name != "frame.launch")


@pytest.mark.cuda
def test_graph_nodes_repeat_across_captures_on_the_card(cuda_engine, clip):
    frames, _ = clip
    counts = []
    for _ in range(2):
        state = nt.DenoiseState(cuda_engine)
        state.process_frame(frames[0])
        prog = state.program.program
        assert prog.graph is not None
        counts.append(prog.graph_nodes)
    assert counts[0] == counts[1] > sum(prog.captured.values())
