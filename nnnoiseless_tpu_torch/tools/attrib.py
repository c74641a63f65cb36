"""Engine attribution: parity and stage timing in one process on one device.

The five sections of ``nnnoiseless_tpu/tools/attrib.py``, on the port:

1. golden parity through the two-phase engine (kernels K1 and K2);
2. pitch decisions of kernel K3 against the old chain on the golden
   clip's windows: whiten, the 385-lag correlation and energy tables, the
   search, ``doubling_tables`` and kernel K4 (``pidx`` flips, t-lane
   differences, g1 max);
3. totals at each batch: the precompute and the whole two-phase chunk;
4. cumulative-prefix attribution of ``chunk.precompute_chunk`` (biquad ->
   frame windows -> decimated windows -> K1), and the old chain on the
   same windows for the delta;
5. K2's stage bisection through its ``skip`` knob: each stage's cost is
   the production time minus the time with that stage stubbed out.

Times come from CUDA events on a card (the best of ``--reps`` runs after a
warm-up), and from the host clock on the CPU, where they time the plain
versions.  Run from the repo root::

    python -m nnnoiseless_tpu_torch.tools.attrib --device cuda
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from ..chunk import decimate, precompute_chunk
from ..constants import FRAME_SIZE, PITCH_BUF_SIZE, PITCH_FRAME_DS, PITCH_MAX_DS, PITCH_MAX_PERIOD
from ..denoise import Engine, check_device, denoise_audio, init_batch_carry, process_chunk
from ..model import RnnModel
from ..ops import frame_kernel as fk
from ..ops.biquad import biquad_filter_frames
from ..ops.pitch import (
    N_LAGS, doubling_tables, downsample_2x, pitch_search, sliding_dot, whiten, window_energies,
)
from ..ops.pitch_kernel import pitch_analysis_stacked, pitch_analysis_stream, window_stack
from ..tables import BIQUAD_HP_A, BIQUAD_HP_B

DATA = pathlib.Path(__file__).resolve().parents[2] / "tests" / "data"
STAGES = ((), ("lag0",), ("dft",), ("rd",), ("feat",), ("rnn",), ("comb",), ("inv",))
T_LANES = [0] + list(range(4, 18))


def make_timer(device: torch.device, reps: int):
    """``time_ms(fn)``: the best of ``reps`` runs after one warm-up, in ms
    (CUDA events on a card, the host clock on the CPU)."""

    def time_ms(fn) -> float:
        fn()
        best = float("inf")
        for _ in range(reps):
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn()
                best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    return time_ms


def golden_windows(clip: np.ndarray, device) -> torch.Tensor:
    """The (R, 864) decimated pitch windows of the HP-filtered clip, one per
    frame hop, each decimated on its own (lane 0 window-local)."""
    nfr = len(clip) // FRAME_SIZE
    frames = torch.as_tensor(clip[: nfr * FRAME_SIZE].reshape(1, nfr, FRAME_SIZE), device=device)
    hp = torch.zeros((1, 2), dtype=torch.float32, device=device)
    filt, _ = biquad_filter_frames(frames, hp, tuple(BIQUAD_HP_A), tuple(BIQUAD_HP_B))
    sig = filt.reshape(-1)
    starts = range(0, sig.shape[0] - PITCH_BUF_SIZE, FRAME_SIZE)
    return downsample_2x(torch.stack([sig[s : s + PITCH_BUF_SIZE] for s in starts])).contiguous()


def old_chain(windows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, 864) raw decimated windows -> ((R, 105) candidate lanes, (R,)
    int32 pitch index) by the chain the pitch kernel replaced: whiten, the
    shared 385-lag tables, the search, ``doubling_tables`` and kernel K4."""
    y = whiten(windows)
    corr = sliding_dot(y[..., PITCH_MAX_DS:], y, N_LAGS)
    energies = window_energies(y, PITCH_FRAME_DS, N_LAGS)
    pidx = (PITCH_MAX_PERIOD - pitch_search(y, corr, energies)).to(torch.int32)
    corr_full, yy_lookup, xx = doubling_tables(y, corr, energies)
    cand = fk.candidates(corr_full.contiguous(), yy_lookup.contiguous(), xx.contiguous(), pidx)
    return cand, pidx


def _golden(engine: Engine, device) -> dict:
    clip = np.fromfile(DATA / "testing.raw", "<i2").astype(np.float32)
    ref = np.fromfile(DATA / "reference_output.raw", "<i2").astype(np.float64)
    out = denoise_audio(clip, engine, device=device)
    got = np.clip(np.rint(out.astype(np.float64)), -32768, 32767)
    n = min(len(got), len(ref))
    d = ref[:n] - got[:n]
    res = {"rel": float(np.sum(d * d) / np.sum(got[:n] ** 2)), "max": float(np.abs(d).max())}
    print(f"[1] golden: rel {res['rel']:.3e}, max |d| {res['max']:.0f}", flush=True)
    if not res["rel"] < 1e-4:
        raise RuntimeError(f"golden rel {res['rel']} >= 1e-4")
    return res


def _pitch(device) -> dict:
    clip = np.fromfile(DATA / "testing.raw", "<i2").astype(np.float32)
    wins = golden_windows(clip, device)
    cand_old, pidx_old = old_chain(wins)
    cand_new, pidx_new = pitch_analysis_stacked(wins)
    res = {
        "windows": int(wins.shape[0]),
        "pidx_flips": int((pidx_old != pidx_new).sum()),
        "t_lane_diffs": int((cand_old[:, T_LANES] != cand_new[:, T_LANES]).sum()),
        "g1_max": float((cand_old[:, 46:60] - cand_new[:, 46:60]).abs().max()),
    }
    print(f"[2] pitch agreement on {res['windows']} golden windows, K3 against the old chain "
          f"with K4: pidx flips {res['pidx_flips']}, t-lane diffs {res['t_lane_diffs']}, "
          f"g1 max|d| {res['g1_max']:.2e}", flush=True)
    return res


def _frames(b: int, t: int, device) -> torch.Tensor:
    rng = np.random.RandomState(0)
    return torch.as_tensor((rng.randn(b, t, FRAME_SIZE) * 3000).astype(np.float32), device=device)


def _line(name: str, ms: float, b: int, t: int) -> None:
    print(f"    {name:44s} {ms:10.3f} ms   ({b * t / (ms / 1e3) / 100:,.0f}x rt)", flush=True)


def _totals(engine, batches, t, device, time_ms) -> dict:
    res = {}
    for b in batches:
        frames = _frames(b, t, device)
        carry = init_batch_carry(engine.model.meta, b, device)
        pre_ms = time_ms(lambda: precompute_chunk(carry.feat.input_mem, carry.feat.hp_mem, frames))
        tot_ms = time_ms(lambda: process_chunk(engine, carry, frames))
        _line(f"[3] B={b} precompute", pre_ms, b, t)
        _line(f"[3] B={b} two-phase total", tot_ms, b, t)
        res[str(b)] = {"precompute_ms": pre_ms, "two_phase_ms": tot_ms}
        del frames, carry
    return res


def _prefix(engine, b, t, device, time_ms) -> dict:
    frames = _frames(b, t, device)
    carry = init_batch_carry(engine.model.meta, b, device)
    imem, hpm = carry.feat.input_mem, carry.feat.hp_mem

    def run(stop):
        filtered, hp_out = biquad_filter_frames(frames, hpm, tuple(BIQUAD_HP_A), tuple(BIQUAD_HP_B))
        if stop == "biquad":
            return filtered, hp_out
        filtered_tm = filtered.transpose(0, 1).contiguous()  # as chunk.py
        full = torch.cat([imem, filtered.reshape(b, t * FRAME_SIZE)], dim=1)
        if stop == "fwin":
            return filtered_tm, full
        ds, w0 = decimate(full, t)
        if stop == "dswin":
            return filtered_tm, ds, w0
        if stop == "oldchain":
            return filtered_tm, old_chain(window_stack(ds, w0, t).reshape(t * b, -1))
        return filtered_tm, pitch_analysis_stream(ds, w0, t)

    ms, marginal, prev = {}, {}, 0.0
    for stop in ("biquad", "fwin", "dswin", "full"):
        ms[stop] = time_ms(lambda: run(stop))
        marginal[stop] = ms[stop] - prev
        prev = ms[stop]
        _line(f"[4] prefix <= {stop}", ms[stop], b, t)
        print(f"        marginal {stop}: {marginal[stop]:+.3f} ms", flush=True)
    old_ms = time_ms(lambda: run("oldchain"))
    _line("[4] prefix <= oldchain (plain pitch chain + K4)", old_ms, b, t)
    return {"batch": b, "ms": ms, "marginal_ms": marginal, "oldchain_ms": old_ms}


def _arrays(result) -> tuple:
    """run_frame_loop's (carry', out, vad) as a flat tuple of tensors."""
    carry, out, vad = result
    return (out, vad, *fk.carry_arrays(carry))


def _stages(engine, b, t, device, time_ms) -> dict:
    frames = _frames(b, t, device)
    carry = init_batch_carry(engine.model.meta, b, device)
    pre, _ = precompute_chunk(carry.feat.input_mem, carry.feat.hp_mem, frames)
    rnn, w = engine.rnn, engine.rnn_weights
    production = fk.run_frame_loop(rnn, carry, pre, w)
    res = {"batch": b, "ms": {}, "cost_ms": {}, "launches": {}, "finite": {}}
    for skip in STAGES:
        name = ",".join(skip) or "none"
        before = fk.launches
        got = fk.run_frame_loop(rnn, carry, pre, w, skip=skip)
        res["launches"][name] = fk.launches - before
        res["finite"][name] = bool(torch.isfinite(got[1]).all() and torch.isfinite(got[2]).all())
        if not skip:
            res["skip_none_bit_equal"] = all(
                torch.equal(a, p) for a, p in zip(_arrays(got), _arrays(production))
            )
        res["ms"][name] = time_ms(lambda: fk.run_frame_loop(rnn, carry, pre, w, skip=skip))
        _line(f"[5] K2 skip={name}", res["ms"][name], b, t)
        if skip:
            res["cost_ms"][name] = res["ms"]["none"] - res["ms"][name]
            print(f"        stage cost ~{res['cost_ms'][name]:+.3f} ms", flush=True)
    return res


def main(argv=None) -> dict:
    """Run the five sections; returns their results as a dict (keys
    ``device``, ``golden``, ``pitch``, ``totals``, ``prefix``, ``stages``)."""
    ap = argparse.ArgumentParser(description="engine attribution on one device")
    ap.add_argument("--batches", default="4096,1024", help="batches of section 3; the first "
                    "is also that of sections 4 and 5")
    ap.add_argument("--frames", type=int, default=100, help="frames per chunk (T)")
    ap.add_argument("--reps", type=int, default=3, help="timed runs per measurement")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    batches = [int(v) for v in args.batches.split(",")]
    t = args.frames
    time_ms = make_timer(device, args.reps)
    engine = Engine(RnnModel.default(), device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"attribution on {name}: batches {batches}, T={t}", flush=True)
    return {
        "device": name,
        "golden": _golden(engine, device),
        "pitch": _pitch(device),
        "totals": _totals(engine, batches, t, device, time_ms),
        "prefix": _prefix(engine, batches[0], t, device, time_ms),
        "stages": _stages(engine, batches[0], t, device, time_ms),
    }


if __name__ == "__main__":
    print(json.dumps(main()))
