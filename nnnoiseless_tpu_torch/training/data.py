"""Training-data generator: the equivalent of the reference `train` binary.

The counterpart of ``nnnoiseless_tpu/training/data.py``.  Mirrors
src/training.rs end to end: round-robin WAV readers with random seeks, the
noise simulator (random gains, random biquads, random lowpass -> band
cutoff, energy-hysteresis VAD), and the 87-column HDF5 output
``[42 features | 22 gains | 22 noise_level | 1 vad]`` consumed unchanged by
the trainer (and by the reference's train/rnn_train.py).

The host side (numpy, copied from the JAX module, which imports JAX) does
the WAV I/O and the cheap random mixing; the three feature pipelines of a
world (clean, noise, combined) run on the device as one batch, a chunk of
frames at a time: ``chunk.precompute_chunk`` (kernel K1 on CUDA) over all
streams, then a loop over frames of ``pipeline.analyze_frame_hoisted``
(kernel K6 on CUDA) on the combined streams only, one replay a frame of a
``programs.FeatureProgram`` (a CUDA graph on a card).

Usage::

    python -m nnnoiseless_tpu_torch.training.data \
        --signal-glob 'speech/*.wav' --noise-glob 'noise/*.wav' \
        --count 100000 -o training.h5 --device cuda
"""

from __future__ import annotations

import argparse
import glob as globlib
import os
import time
import wave
from typing import List

import numpy as np
import torch

from ..chunk import precompute_chunk
from ..constants import (
    EBAND_5MS,
    FRAME_SIZE,
    FRAME_SIZE_SHIFT,
    FREQ_SIZE,
    NB_BANDS,
    NB_FEATURES,
    PITCH_BUF_SIZE,
)
from ..denoise import check_device
from ..pipeline import FeatureState, FramePre, init_feature_state
from ..programs import FeatureProgram

GAIN_CHANGE_COUNT = 2821  # frames between re-randomizations (training.rs:17)


# --------------------------------------------------------------------------
# Host side: signal readers + noise simulator
# --------------------------------------------------------------------------


class SignalReader:
    """Round-robin frame reader over many WAV files (training.rs:171-261).

    Requires 48 kHz 16-bit mono PCM WAVs; takes a random slice of large
    files so a bounded number of frames per file covers the corpus.
    """

    def __init__(self, paths: List[str], count: int, rng: np.random.RandomState):
        if not paths:
            raise ValueError("cannot read from an empty set of files")
        self.paths = paths
        self.frames_per_file = max(count // len(paths) + 1, 100)
        self.cur_idx = 0
        self.frames_left = 0
        self.rng = rng
        self._samples: np.ndarray | None = None
        self._pos = 0

    def _open_next(self):
        if self.cur_idx >= len(self.paths):
            self.cur_idx = 0
        path = self.paths[self.cur_idx]
        with wave.open(path, "rb") as w:
            if (
                w.getnchannels() != 1
                or w.getframerate() != 48_000
                or w.getsampwidth() != 2
            ):
                raise ValueError(f"unsupported wav format in {path} (need 48kHz/16-bit/mono)")
            n = w.getnframes()
            num_samples = FRAME_SIZE * self.frames_per_file
            if n > num_samples:
                start = self.rng.randint(0, n - num_samples + 1)
                w.setpos(start)
                data = w.readframes(num_samples)
                self.frames_left = self.frames_per_file
            else:
                data = w.readframes(n)
                self.frames_left = n // FRAME_SIZE
        self._samples = np.frombuffer(data, dtype="<i2").astype(np.float32)
        self._pos = 0
        if self.frames_left == 0:
            self._samples = None
            self.cur_idx += 1

    def frame(self) -> np.ndarray:
        while self._samples is None:
            self._open_next()
        out = np.zeros(FRAME_SIZE, np.float32)
        avail = len(self._samples) - self._pos
        take = min(FRAME_SIZE, avail)
        out[:take] = self._samples[self._pos : self._pos + take]
        self._pos += take
        if take < FRAME_SIZE:
            self.frames_left = 0
        if self.frames_left <= 1:
            self._samples = None
            self.cur_idx += 1
        else:
            self.frames_left -= 1
        return out


_NATIVE_BIQUAD = None  # lazily resolved; False = unavailable


def _biquad_np(data: np.ndarray, mem: np.ndarray, a, b) -> np.ndarray:
    """Host biquad for augmentation (training.rs:397-400 / util.rs:114-126).

    Uses the native engine's ``nnt_biquad_inplace`` when the C++ toolchain
    is available (the reference's generator is a native binary; the Python
    loop below is the portable fallback, ~100x slower).
    """
    global _NATIVE_BIQUAD
    if _NATIVE_BIQUAD is None:
        try:
            import ctypes

            from ..native import load_library

            lib = load_library()
            lib.nnt_biquad_inplace.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
            ]
            _NATIVE_BIQUAD = lib.nnt_biquad_inplace
        except Exception:
            _NATIVE_BIQUAD = False
    if _NATIVE_BIQUAD:
        import ctypes

        fp = ctypes.POINTER(ctypes.c_float)
        out = np.ascontiguousarray(data, np.float32).copy()
        a32 = np.ascontiguousarray(a, np.float32)
        b32 = np.ascontiguousarray(b, np.float32)
        _NATIVE_BIQUAD(
            out.ctypes.data_as(fp),
            len(out),
            a32.ctypes.data_as(fp),
            b32.ctypes.data_as(fp),
            mem.ctypes.data_as(fp),
        )
        return out

    out = np.empty_like(data)
    m0, m1 = float(mem[0]), float(mem[1])
    a0, a1, b0, b1 = float(a[0]), float(a[1]), float(b[0]), float(b[1])
    for i, x in enumerate(data.astype(np.float64)):
        y = x + m0
        m0 = np.float32(m1 + (b0 * x - a0 * y))
        m1 = np.float32(b1 * x - a1 * y)
        out[i] = np.float32(y)
    mem[0], mem[1] = m0, m1
    return out


class NoiseSimulator:
    """Random gain/filter/lowpass augmentation + VAD (training.rs:263-422)."""

    def __init__(self, signal: SignalReader, noise: SignalReader, rng):
        self.signal = signal
        self.noise = noise
        self.rng = rng
        self.sig_filter = (np.zeros(2, np.float32), np.zeros(2, np.float32))
        self.noise_filter = (np.zeros(2, np.float32), np.zeros(2, np.float32))
        self.vad_count = 0
        self.gain_change_count = 0
        self.signal_gain = 1.0
        self.noise_gain = 1.0
        self.lowpass = FREQ_SIZE
        self.band_lp = NB_BANDS - 1
        self.sig_mem = np.zeros(2, np.float32)
        self.noise_mem = np.zeros(2, np.float32)

    def _random_filter(self):
        r = lambda: 0.75 * (self.rng.random_sample() - 0.5)
        return (
            np.array([r(), r()], np.float32),
            np.array([r(), r()], np.float32),
        )

    def _randomize(self):
        rng = self.rng
        self.signal_gain = 10.0 ** (rng.randint(-40, 20) / 20.0)
        self.noise_gain = 10.0 ** (rng.randint(-20, 20) / 20.0) * self.signal_gain
        if rng.random_sample() < 0.1:
            self.signal_gain = 0.0
        self.sig_filter = self._random_filter()
        self.noise_filter = self._random_filter()
        self.lowpass = int(
            FREQ_SIZE * 3000.0 / 24000.0 * 50.0 ** rng.random_sample()
        )
        self.band_lp = next(
            (
                i
                for i, e in enumerate(EBAND_5MS)
                if (e << FRAME_SIZE_SHIFT) > self.lowpass
            ),
            NB_BANDS - 1,
        )

    def _vad(self, sig_e: float) -> float:
        if sig_e > 1e9:
            self.vad_count = 0
        elif sig_e > 1e8:
            self.vad_count -= 5
        elif sig_e > 1e7:
            self.vad_count += 1
        else:
            self.vad_count += 2
        self.vad_count = min(max(self.vad_count, 0), 15)
        if self.vad_count >= 10:
            return 0.0
        if self.vad_count > 0:
            return 0.5
        return 1.0

    def next_frame(self):
        self.gain_change_count += 1
        if self.gain_change_count > GAIN_CHANGE_COUNT:
            self.gain_change_count = 0
            self._randomize()
        noise = self.noise.frame() * self.noise_gain
        sig = self.signal.frame()
        sig_e = float(np.sum(sig.astype(np.float64) ** 2))
        sig = sig * self.signal_gain

        sig = _biquad_np(sig, self.sig_mem, self.sig_filter[0], self.sig_filter[1])
        noise = _biquad_np(
            noise, self.noise_mem, self.noise_filter[0], self.noise_filter[1]
        )
        combined = sig + noise
        vad = self._vad(sig_e)
        band_gain_cutoff = (
            0 if (vad == 0.0 and self.noise_gain == 0.0) else self.band_lp + 1
        )
        return sig, noise, combined, band_gain_cutoff, vad

    def next_frames(self, n: int):
        """``n`` frames at once, BIT-IDENTICAL to ``n`` next_frame() calls.

        Augmentation parameters only change every GAIN_CHANGE_COUNT frames,
        and the biquad is one continuous recurrence across frames within a
        parameter segment — so the batch path pulls all reader frames first
        (in the exact per-frame order, preserving the shared-RNG draw
        sequence), then applies gains and ONE whole-segment biquad per
        filter per segment, and vectorizes the energies.  Only the VAD
        hysteresis (a 4-line scalar recurrence) stays per-frame.

        Returns (sig (n,480), noise (n,480), combined (n,480),
        cutoffs (n,) int32, vads (n,) f32).
        """
        sig = np.empty((n, FRAME_SIZE), np.float32)
        noise = np.empty((n, FRAME_SIZE), np.float32)
        # segments of constant augmentation parameters: (start, sig_gain,
        # noise_gain, sig_filter, noise_filter, band_lp, end)
        segs: list[tuple] = []

        def snap(start):
            return (
                start,
                self.signal_gain,
                self.noise_gain,
                self.sig_filter,
                self.noise_filter,
                self.band_lp,
            )

        cur = snap(0)
        for t in range(n):
            self.gain_change_count += 1
            if self.gain_change_count > GAIN_CHANGE_COUNT:
                self.gain_change_count = 0
                if t > cur[0]:
                    segs.append(cur + (t,))
                self._randomize()
                cur = snap(t)
            # per-frame pull order (noise, then signal) preserves the
            # shared-RandomState draw sequence of the scalar path
            noise[t] = self.noise.frame()
            sig[t] = self.signal.frame()
        segs.append(cur + (n,))

        sig64 = sig.astype(np.float64)
        sig_e = np.einsum("ij,ij->i", sig64, sig64)

        combined = np.empty_like(sig)
        cutoffs = np.empty(n, np.int32)
        vads = np.empty(n, np.float32)
        for t in range(n):
            vads[t] = self._vad(sig_e[t])
        for start, g_s, g_n, f_s, f_n, blp, end in segs:
            s = sig[start:end] * g_s
            nz = noise[start:end] * g_n
            s = _biquad_np(s.reshape(-1), self.sig_mem, f_s[0], f_s[1]).reshape(
                s.shape
            )
            nz = _biquad_np(
                nz.reshape(-1), self.noise_mem, f_n[0], f_n[1]
            ).reshape(nz.shape)
            sig[start:end] = s
            noise[start:end] = nz
            combined[start:end] = s + nz
            cutoffs[start:end] = np.where(
                (vads[start:end] == 0.0) & (g_n == 0.0), 0, blp + 1
            )
        return sig, noise, combined, cutoffs, vads


# --------------------------------------------------------------------------
# Device side: batched feature extraction over chunks of frames
# --------------------------------------------------------------------------


def _feature_chunk(states: FeatureState, frames: torch.Tensor, frame_loop=None):
    """Batched hoisted analysis over w worlds of (clean, noise) streams.

    ``frames`` is (2w, T, 480) on the device — each world's clean and noise
    streams, ``[w0-clean, w0-noise, w1-clean, ...]``; ``states`` is (3w,
    ...).  The combined stream is rebuilt on the device as clean + noise
    (bit-identical to the host's f32 add), so a third of the host-to-device
    bytes never cross.

    The two-phase shape of the inference engine: the precompute with its
    lag-0 products (HP filter, spectra, band energies, cepstra, kernel K1)
    for all 3w streams, then a loop over frames of the carry-coupled
    remainder (octave removal, the spectrum at the pitch lag through kernel
    K6, the cepstral register) on the combined third only: the clean and
    noise streams contribute just their lag-0 band energies.

    ``frame_loop``: that loop, (state (w, ...), precompute (T, w, ...)) ->
    (state', features (w, T, 42)): a :class:`programs.FeatureProgram` of w
    streams, reused across chunks (one is made for this call when None).

    Returns (states', features (w,T,42), ex (3w,T,22), silence (w,T)).
    """
    w2, t, _ = frames.shape
    w = w2 // 2
    fr = frames.reshape(w, 2, t, FRAME_SIZE)
    frames3 = torch.cat([fr, (fr[:, 0] + fr[:, 1])[:, None]], 1).reshape(3 * w, t, FRAME_SIZE)
    pre, hp_out = precompute_chunk(states.input_mem, states.hp_mem, frames3, lag0=True)

    pre_c = FramePre(*(f[:, 2::3] for f in pre))  # time-major: (T, w, ...)
    st_c = FeatureState(*(a[2::3] for a in states))
    st_c, feats = (frame_loop or FeatureProgram(w, frames.device))(st_c, pre_c)

    # input_mem rolls forward identically for every stream (it is updated
    # unconditionally) — rebuild it for all 3w from the chunk's last
    # filtered frames.
    tail = pre.filtered[-(-PITCH_BUF_SIZE // FRAME_SIZE) :].transpose(0, 1).reshape(3 * w, -1)
    new_mem = torch.cat([states.input_mem, tail], 1)[:, -PITCH_BUF_SIZE:]
    cepstral_mem, pitch_period, pitch_gain = (a.clone() for a in states[2:])
    cepstral_mem[2::3] = st_c.cepstral_mem
    pitch_period[2::3] = st_c.pitch_period
    pitch_gain[2::3] = st_c.pitch_gain
    states = FeatureState(new_mem.contiguous(), hp_out, cepstral_mem, pitch_period, pitch_gain)
    return states, feats, pre.ex.transpose(0, 1), pre.silence[:, 2::3].transpose(0, 1)


def _make_worlds(signal_paths: List[str], noise_paths: List[str], per: int, seed: int, w: int) -> list:
    """``w`` independent simulators: world i draws from its own
    RandomState(seed + 7919 i) and (for i > 0) reads the files in an order
    shuffled by it."""
    sims = []
    for i in range(w):
        rng = np.random.RandomState(seed + 7919 * i)
        sp, np_ = list(signal_paths), list(noise_paths)
        if i > 0:
            rng.shuffle(sp)
            rng.shuffle(np_)
        sims.append(NoiseSimulator(SignalReader(sp, per, rng), SignalReader(np_, per, rng), rng))
    return sims


def _mix_chunk(sims: list, n: int, pool=None):
    """The next ``n`` frames of every world: (frames (w, 2, n, 480) clean
    and noise, cutoffs (w, n) int32, vads (w, n) f32).  Worlds are fully
    independent (own readers, simulator state and RandomState), so they mix
    in parallel on ``pool`` — numpy and the native biquad release the GIL,
    and each world writes a disjoint slice; the draw order within a world
    is unchanged, so the output is bit-identical at any pool size."""
    w = len(sims)
    frames = np.empty((w, 2, n, FRAME_SIZE), np.float32)
    cutoffs = np.empty((w, n), np.int32)
    vads = np.empty((w, n), np.float32)

    def mix(i):
        frames[i, 0], frames[i, 1], _, cutoffs[i], vads[i] = sims[i].next_frames(n)

    if pool is None:
        for i in range(w):
            mix(i)
    else:
        for f in [pool.submit(mix, i) for i in range(w)]:
            f.result()
    return frames, cutoffs, vads


def generate(
    signal_paths: List[str],
    noise_paths: List[str],
    count: int,
    seed: int = 0,
    chunk: int = 625,
    progress=None,
    workers: int = 1,
    timing: dict | None = None,
    device="cuda",
) -> np.ndarray:
    """Generate `count` rows of the 87-column training matrix on ``device``.

    ``workers`` > 1 runs that many independent generator worlds in
    lockstep — each with its own readers (world-shuffled file order),
    simulator and RNG — so the device sees a batch of 3*workers feature
    pipelines per chunk instead of 3.  Each world's rows land in one
    CONTIGUOUS region of the output, preserving the frame continuity the
    trainer's 2000-frame sequence windows rely on (the reference generator
    is one continuous stream, src/training.rs:120-161; W worlds are W
    continuous streams).

    A 1-deep pipeline: the device works on chunk k while the host mixes
    chunk k+1.  Chunk k's readback is queued right behind its work (into
    pinned buffers on a card, with an event), so reading it back after
    chunk k+1 is dispatched waits for chunk k only.  The frame loop is one
    :class:`programs.FeatureProgram` for the whole call.  ``timing``, if
    given, is filled with {"device_s", "host_s"}: wall time spent
    dispatching chunks and waiting for their readback, and in the
    host-side noise simulator.
    """
    device = check_device(device)
    w = max(1, int(workers))
    per = -(-count // w)  # rows per world; the tail of the LAST world is cut
    sims = _make_worlds(signal_paths, noise_paths, per, seed, w)
    states = init_feature_state(3 * w, device)
    width = NB_FEATURES + 2 * NB_BANDS + 1
    out = np.empty((w * per, width), np.float32)

    dev_s = host_s = 0.0
    band = np.arange(NB_BANDS)[None, :]
    # Mix worlds in parallel where the host has the cores for it; on a
    # single-core host a pool is pure overhead.
    pool = None
    n_cores = os.cpu_count() or 1
    if w > 1 and n_cores > 1:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(min(w, n_cores))

    program = FeatureProgram(w, device)
    pin = device.type == "cuda"

    def dispatch(frames):
        """Queue one chunk's work and its readback: (host tensors of
        features, ex and silence, the event that marks the readback done)."""
        nonlocal states
        states, *out = _feature_chunk(
            states, torch.from_numpy(frames.reshape(2 * w, -1, FRAME_SIZE)).to(device), program)
        host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=pin) for o in out]
        for h, o in zip(host, out):
            h.copy_(o, non_blocking=True)
        event = None
        if pin:
            event = torch.cuda.Event()
            event.record()
        return host, event

    def finish(start, n, cutoffs, vads, host, event):
        """Wait for one dispatched chunk's readback and write its n rows."""
        if event is not None:
            event.synchronize()
        feats, ex, sil = (h.numpy() for h in host)
        ex = ex.reshape(w, 3, n, NB_BANDS)

        clean_ex, noise_ex, comb_ex = ex[:, 0], ex[:, 1], ex[:, 2]
        cut = np.where(sil, 0, cutoffs)[..., None]  # silence -> sentinel
        g = np.sqrt((clean_ex + 1e-3) / (comb_ex + 1e-3)).clip(max=1.0)
        g = np.where((clean_ex < 5e-2) & (comb_ex < 5e-2), -1.0, g)
        g = np.where(band[None] < cut, g, -1.0)
        noise_level = np.log10(noise_ex + 1e-2)

        rows = np.concatenate(
            [feats, g, noise_level, vads[..., None]], axis=2
        ).astype(np.float32)
        for i in range(w):
            out[i * per + start : i * per + start + n] = rows[i]
        if progress:
            # per-world ceil rounding can overshoot the request by up to
            # w-1 rows; clamp so the callback never exceeds ``count``
            progress(min((start + n) * w, count))

    try:
        done = 0
        pending = None
        while done < per or pending is not None:
            inflight = None
            if done < per:
                t_host = time.perf_counter()
                n = min(chunk, per - done)
                frames, cutoffs, vads = _mix_chunk(sims, n, pool)
                t_dispatch = time.perf_counter()
                host_s += t_dispatch - t_host
                # only the clean and noise streams cross to the device
                inflight = (done, n, cutoffs, vads, *dispatch(frames))
                dev_s += time.perf_counter() - t_dispatch
                done += n
            if pending is not None:
                t_fin = time.perf_counter()
                finish(*pending)
                dev_s += time.perf_counter() - t_fin
            pending = inflight
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
    if timing is not None:
        timing["device_s"] = dev_s
        timing["host_s"] = host_s
    return out[:count]


def main(argv=None):
    ap = argparse.ArgumentParser(description="Generate denoiser training data")
    ap.add_argument("--signal-glob", action="append", required=True)
    ap.add_argument("--noise-glob", action="append", required=True)
    ap.add_argument("--count", type=int, required=True)
    ap.add_argument("--shuffle", action="store_true")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--workers", type=int, default=1,
        help="parallel generator worlds (device batch = 3*workers); 1 "
        "reproduces the reference's single continuous stream",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    signal_paths = sorted(p for g in args.signal_glob for p in globlib.glob(g))
    noise_paths = sorted(p for g in args.noise_glob for p in globlib.glob(g))
    if args.shuffle:
        rng = np.random.RandomState(args.seed)
        rng.shuffle(signal_paths)
        rng.shuffle(noise_paths)
    print(f"{len(signal_paths)} clean files, {len(noise_paths)} noise files")

    data = generate(
        signal_paths,
        noise_paths,
        args.count,
        seed=args.seed,
        workers=args.workers,
        progress=lambda n: print(f"{n}\r", end="", flush=True),
        device=args.device,
    )

    import h5py

    with h5py.File(args.output, "w") as f:
        f.create_dataset("data", data=data)
    print(f"\nwrote {args.output} ({data.shape[0]} x {data.shape[1]})")


if __name__ == "__main__":
    main()
