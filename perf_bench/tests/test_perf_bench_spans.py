"""The readers of the program's spans and counters: their values on a
hand-built recording and node count, nothing where the program has
neither, and the recording they make themselves on the CPU at a tiny
size."""

import pytest
import torch

from nnnoiseless_tpu_torch import tracing
from perf_bench import run
from perf_bench.metrics import spans

SPAN_READERS = {"precompute_issue_ms": "stream-4096x100", "frame_launch_ms": "frame-b1",
                "frame_wait_ms": "frame-b1", "frame_device_ms": "frame-b1"}
COUNT_READERS = {"frame_graph_nodes": "frame-b1", "train_graph_nodes": "train-32x2000"}


def _recording(units: list) -> tracing.Recording:
    """A recording of units given as [(name, host ms, device ms), ...] children
    of one ``perf_bench.unit`` root each."""
    rec = tracing.Recording()
    t = 0
    for children in units:
        root = tracing.Span("perf_bench.unit", len(rec.spans), None)
        rec.spans.append(root)
        root.start_ns = t
        for name, ms, dev in children:
            s = tracing.Span(name, len(rec.spans), root)
            s.start_ns, s.end_ns, s.device_ms = t, t + int(ms * 1e6), dev
            t = s.end_ns
            rec.spans.append(s)
        root.end_ns = t
    return rec


def test_the_new_metrics_are_entries_with_their_cells():
    for name, cell in {**SPAN_READERS, **COUNT_READERS}.items():
        assert name in [m["name"] for m in run.load_cell(cell).per_layer]


def test_readers_on_a_hand_built_recording():
    frames = [[("frame.launch", ms, dev), ("frame.wait", wait, None)]
              for ms, dev, wait in [(0.03, 1.01, 0.95), (0.05, 1.03, 0.90), (0.04, 1.02, 1.10)]]
    chunks = [[("chunk.precompute", ms, None), ("chunk.frame_loop", 2.0, None)] for ms in (0.6, 0.9, 0.7, 0.8)]
    ctx_frame = {"spans": _recording(frames), "program": {"graph_nodes": 803}}
    ctx_stream = {"spans": _recording(chunks), "program": {}}
    ctx_train = {"program": {"warmup_s": 9.0, "capture_s": 21.0, "graph_nodes": 446_200}}
    read = lambda name, ctx: run.load_reader(name)(ctx)
    assert read("precompute_issue_ms", ctx_stream) == pytest.approx(0.75)
    assert read("frame_launch_ms", ctx_frame) == pytest.approx(0.04)
    assert read("frame_wait_ms", ctx_frame) == pytest.approx(0.95)
    assert read("frame_device_ms", ctx_frame) == pytest.approx(1.02)
    assert read("frame_graph_nodes", ctx_frame) == 803
    assert read("train_graph_nodes", ctx_train) == 446_200


def test_readers_report_nothing_without_the_programs_spans():
    for name in SPAN_READERS:
        assert run.load_reader(name)({"spans": None, "program": {}}) is None
    cpu = {"spans": _recording([[("frame.launch", 0.03, None)]]), "program": {}}
    assert run.load_reader("frame_device_ms")(cpu) is None


@pytest.mark.parametrize("cell,traffic,span,units", [
    ("stream-4096x100", {"streams": 4, "chunk_frames": 10, "segment_chunks": 2, "warmup_chunks": 1, "buffers": 1},
     "chunk.precompute", 2),
    ("frame-b1", {"trace_frames": 5, "warmup_frames": 2, "segment_frames": 8, "segments": 1}, "frame.launch", 5),
])
def test_spans_record_the_cells_units_on_the_cpu(cell, traffic, span, units):
    c = run.load_cell(cell)
    c.traffic.update(traffic)
    ctx = {"cell": c, "program": {}, "device": "cpu"}
    rec = spans.spans(ctx)
    assert ctx["spans"] is rec
    roots = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in roots] == ["perf_bench.unit"] * units
    assert len(rec.ms(span)) == units and all(s.root in {r.id for r in roots} for s in rec.spans)
    assert spans.median_ms(ctx, span) > 0
    assert spans.graph_nodes(ctx) is None  # nothing is captured on the CPU


def test_spans_refuse_a_card_the_recording_process_cannot_see():
    c = run.load_cell("frame-b1")
    with pytest.raises(RuntimeError, match="not visible"):
        spans.record(c, f"cuda:{torch.cuda.device_count()}")
