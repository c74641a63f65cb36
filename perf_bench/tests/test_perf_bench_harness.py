"""The harness is driven by data: a cell, its traffic and its limits are
files found by name, and a per-layer metric is a reader of its own."""

import ast
import json
import pathlib
import shutil

from perf_bench import counts, run
from perf_bench.tests.conftest import REPO

BENCH = REPO / "perf_bench"


def test_new_workload_file_is_loaded_without_a_code_edit(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "perf_bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "stream-8x10", "config": "rnnoise-xiph", "traffic": "stream-8x10",
                               "chips": 1, "why": "a small batch"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "stream-4096x100" in m.get("workloads", []):
            m["workloads"].append("stream-8x10")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((BENCH / "workloads" / "stream-4096x100.json").read_text())
    traffic.update(streams=8, chunk_frames=10)
    (tmp_path / "perf_bench" / "workloads" / "stream-8x10.json").write_text(json.dumps(traffic))
    shutil.copy(BENCH / "limits" / "stream-4096x100.json", tmp_path / "perf_bench" / "limits" / "stream-8x10.json")

    cell = run.load_cell("stream-8x10", tmp_path)
    assert cell.traffic["streams"] == 8 and cell.traffic["driver"] == "stream"
    assert cell.config["model_file"] == "perf_bench/configs/rnnoise-xiph.rnn"
    assert [m["name"] for m in cell.end_to_end] == ["realtime_x", "chunk_p95_ms", "setup_s"]
    assert "k1_roofline" in [m["name"] for m in cell.per_layer]
    assert callable(run.load_reader("k1_roofline", tmp_path))


def test_every_metric_has_its_reader_and_every_cell_its_files():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert callable(run.load_reader(m["name"]))
    for w in bench["workloads"]:
        cell = run.load_cell(w["name"])
        assert cell.per_layer and any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2


def test_rnn_macs_match_the_model_dims():
    from nnnoiseless_tpu_torch.ops.rnn_kernel import DIMS

    assert counts.rnn_macs(**DIMS) == counts.rnn_macs() == 86_952


def test_k1_count_is_the_reference_search_not_the_lag_table():
    table = 385 * 480 + 147 * 240 + 5 * 864 + 6 * 864 + 480 + 2 * 384
    assert 60_000 < counts.pitch_window_macs() < table / 2


def _imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program_or_jax():
    for path in (BENCH / "reference").glob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "nnnoiseless_tpu", "nnnoiseless_tpu_torch"}, path


def test_nothing_the_card_runs_imports_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" not in path.parts:
            assert not _imports(path) & {"jax", "jaxlib", "flax", "nnnoiseless_tpu"}, path
