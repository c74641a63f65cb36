"""The port's tools on the CPU: the pitch trace against the native engine
and the JAX package's trace, the sine benchmark and its profiler trace,
the correlation tool, the attribution tool's sections at B=2, T=4,
kernel_ab.py's SASS counts and resource usage on hand-written listings,
and chip_smoke.py's count of the sectors that K4 reads."""

import json

import numpy as np
import pytest
import torch

from nnnoiseless_tpu_torch import native
from nnnoiseless_tpu_torch.ops.pitch import candidate_lanes
from nnnoiseless_tpu_torch.tools import attrib, corr, profile, trace

import chip_smoke
import kernel_ab


@pytest.fixture(scope="module")
def port_trace(testing_raw):
    return trace.pitch_trace(testing_raw, device="cpu")


def test_pitch_trace_lag_exact_against_native(port_trace, testing_raw):
    """The bar of tests/test_pitch_trace.py: at most 2 of 100 periods off
    the native engine, by at most 2; gains within 5e-3 where they agree."""
    native.load_library()
    pt, gt = port_trace
    pn, gn = trace.pitch_trace_native(testing_raw)
    neq = pt != pn
    assert neq.sum() <= 2, (np.nonzero(neq)[0], pt[neq], pn[neq])
    if neq.any():
        assert np.abs(pt[neq].astype(int) - pn[neq].astype(int)).max() <= 2
    assert np.abs(gt[~neq] - gn[~neq]).max() < 5e-3


def test_pitch_trace_matches_jax(port_trace, testing_raw):
    from nnnoiseless_tpu.tools.trace import pitch_trace as jax_pitch_trace

    pj, gj = jax_pitch_trace(testing_raw)
    pt, gt = port_trace
    np.testing.assert_array_equal(pt, pj)
    # gain lanes' bar of tests/test_torch_pitch_kernel.py: the JAX chain's
    # correlation is an FFT product, the port's a direct sum
    np.testing.assert_allclose(gt, gj, atol=1e-3)


def test_sine_bench_and_chrome_trace(tmp_path):
    sig = profile.sine_signal(0.2)
    assert sig.shape == (9600,) and np.max(np.abs(sig)) <= 16000
    stats = profile.sine_bench(batch=2, seconds=0.2, trace_dir=tmp_path, device="cpu")
    assert stats["device"] == "cpu" and stats["batch"] == 2 and stats["frames"] == 20
    assert stats["frames_per_sec"] > 0 and stats["realtime_factor"] > 0
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_corr_tool(tmp_path):
    rng = np.random.RandomState(0)
    sig = (rng.randn(1000) * 1000).astype("<i2")
    assert corr.correlation(sig, sig) == pytest.approx(1.0)
    assert corr.correlation(np.zeros(10), np.zeros(10)) == 1.0
    assert corr.correlation(np.zeros(10), np.ones(10)) == 0.0
    a, b = tmp_path / "a.raw", tmp_path / "b.raw"
    sig.tofile(a)
    sig[::-1].copy().tofile(b)
    assert corr.main([str(a), str(a)]) == 0
    assert corr.main([str(a), str(b)]) == 1
    assert corr.main([str(a), str(b), "--threshold", "2"]) == 0


def test_attrib_sections_on_cpu():
    res = attrib.main(["--batches", "2", "--frames", "4", "--device", "cpu", "--reps", "1"])
    assert set(res) == {"device", "golden", "pitch", "totals", "prefix", "stages"}
    assert res["golden"]["rel"] < 1e-4 and res["golden"]["max"] <= 2
    assert res["pitch"]["windows"] == 97 and res["pitch"]["pidx_flips"] == 0
    assert res["pitch"]["t_lane_diffs"] == 0
    assert set(res["totals"]["2"]) == {"precompute_ms", "two_phase_ms"}
    assert set(res["prefix"]["ms"]) == {"biquad", "fwin", "dswin", "full"}
    assert res["prefix"]["oldchain_ms"] > 0
    stages = res["stages"]
    names = {"none", "lag0", "dft", "rd", "feat", "rnn", "comb", "inv"}
    assert set(stages["ms"]) == names and set(stages["cost_ms"]) == names - {"none"}
    assert all(stages["finite"].values()) and stages["skip_none_bit_equal"]
    assert set(stages["launches"].values()) == {0}  # the plain versions on the CPU


SASS = """
		Function : _ZN12_GLOBAL__N_110rnn_kernelIN8rnn_tile4TileILi1ELi1ELi576ELi2EEEEEvPKfi
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS R2, [R3] ;
        /*0020*/                   I2F.S8 R4, R5 ;
        /*0030*/                   FFMA R6, R2, R4, R6 ;
        /*0040*/                   LDS.128 R8, [R3+0x10] ;
        /*0050*/              @!P1 I2FP.F32.S32 R7, R8 ;
        /*0060*/              @P0  BRA 0x30 ;
        /*0070*/                   PRMT R9, R8, 0x7440, R9 ;
        /*0080*/                   FADD R9, R9, -8388736 ;
        /*0090*/                   STS.128 [R3], R8 ;
        /*00a0*/                   EXIT ;
		Function : _Z10frame_loopPf
        /*0000*/                   FFMA R6, R2, R4, R6 ;
		Function : _ZN12_GLOBAL__N_112frame_kernelILi0EEEvN5frame4ArgsE
        /*0000*/                   LDG.E.CONSTANT R2, desc[UR4][R2.64] ;
        /*0010*/                   PRMT R3, R2, 0x7440, R9 ;
        /*0020*/                   LDS.128 R4, [R8] ;
        /*0030*/                   FFMA R6, R4, R3, R6 ;
		Function : _ZN12_GLOBAL__N_117candidates_kernelEPKfS1_S1_PKiPfi
        /*0000*/                   LDG.E.CONSTANT R2, desc[UR4][R2.64] ;
        /*0010*/              @!P0 LDG.E.CONSTANT R3, desc[UR4][R4.64] ;
        /*0020*/                   SHFL.IDX PT, R5, R2, RZ, 0x101f ;
        /*0030*/                   STG.E desc[UR4][R6.64], R5 ;
        /*0040*/                   STG.E desc[UR4][R6.64+0x3c], R3 ;
        /*0050*/                   EXIT ;
"""


def test_kernel_ab_sass_counts():
    """Counts over the whole function, for K2's, K4's, K5's and K6's
    kernels only; predicated instructions, I2FP and every width of a load
    or store count; K2's summary reads its production instance."""
    counts = kernel_ab.sass_counts(SASS)
    assert len(counts) == 3
    (rnn,) = (c for name, c in counts.items() if "rnn_kernel" in name)
    (cand,) = (c for name, c in counts.items() if "candidates_kernel" in name)
    (frame,) = (c for name, c in counts.items() if "frame_kernel" in name)
    assert rnn == {"FFMA": 1, "LDS": 2, "I2F": 2, "PRMT": 1, "FADD": 1, "LDG": 0, "STG": 0, "STS": 1}
    assert cand == {"FFMA": 0, "LDS": 0, "I2F": 0, "PRMT": 0, "FADD": 0, "LDG": 2, "STG": 2, "STS": 0}
    assert frame == {"FFMA": 1, "LDS": 1, "I2F": 0, "PRMT": 1, "FADD": 0, "LDG": 1, "STG": 0, "STS": 0}
    summary = kernel_ab.k2_summary({"res": {}, "sass": counts})
    assert "per FFMA {'LDS': 1.0, 'LDG': 1.0, 'I2F': 0.0, 'PRMT': 1.0}" in summary


RES_USAGE = """
Resource usage:
 Common:
  GLOBAL:0 CONSTANT[3]:24
 Function _ZN12_GLOBAL__N_117candidates_kernelEPKfS1_S1_PKiPfi:
  REG:30 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:572 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _Z10frame_loopPf:
  REG:128 STACK:24 SHARED:0 LOCAL:24 CONSTANT[0]:900 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN12_GLOBAL__N_113window_kernelEPKfPKiPfi:
  REG:26 STACK:8 SHARED:0 LOCAL:8 CONSTANT[0]:380 TEXTURE:0 SURFACE:0 SAMPLER:0
"""


def test_kernel_ab_res_usage():
    """Registers, stack, shared and local memory (spills) of K4's, K5's and
    K6's kernel functions only."""
    res = kernel_ab.res_usage(RES_USAGE)
    assert res == {
        "_ZN12_GLOBAL__N_117candidates_kernelEPKfS1_S1_PKiPfi": {"REG": 30, "STACK": 0, "SHARED": 0, "LOCAL": 0},
        "_ZN12_GLOBAL__N_113window_kernelEPKfPKiPfi": {"REG": 26, "STACK": 8, "SHARED": 0, "LOCAL": 8},
    }


def test_k4_sectors_match_a_set_count():
    """chip_smoke.k4_reads holds, row by row, the lags that the plain walk
    (ops/pitch.py::candidate_lanes) looks up, and k4_sectors counts the
    distinct 32-byte sectors of those lookups that fall on the tables:
    64 rows with pitch indices over [0, 768), the smallest among them (their
    lookups fall off the tables)."""
    rows = 64
    pidx = np.random.RandomState(13).randint(0, 768, size=rows)
    pidx[:4] = [0, 1, 3, 767]
    pidx = torch.as_tensor(pidx.astype(np.int32))
    seen = {"corr": [], "yy": []}

    def spy(name):
        def at(t):
            seen[name].append(t.clone())
            return torch.zeros(t.shape)
        return at

    candidate_lanes(torch.clamp(pidx.to(torch.int64) // 2, max=383), torch.zeros(rows), spy("corr"), spy("yy"))
    corr_t, yy_t = chip_smoke.k4_reads(torch, pidx)
    assert corr_t.shape == (rows, 59) and yy_t.shape == (rows, 29)
    sectors = set()
    for name, reads in (("corr", corr_t), ("yy", yy_t)):
        looked_up = torch.stack(seen[name], 1)
        for r in range(rows):
            assert set(looked_up[r].tolist()) == set(reads[r].tolist())
            for t in looked_up[r].tolist():
                i = 384 - t if name == "corr" else t
                if 0 <= i < 385:
                    sectors.add((name, (r * 385 + i) // 8))
    assert any(t < 0 or t > 384 for t in yy_t[:4].flatten().tolist() + corr_t[:4].flatten().tolist())
    assert chip_smoke.k4_sectors(torch, pidx) == len(sectors)
