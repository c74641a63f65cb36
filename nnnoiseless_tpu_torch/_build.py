"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``,
all started together, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``.  The library's name
carries a hash of the sources, so it is built on first use and rebuilt
whenever a source changes; nothing is built at import.  There is no
fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers, shared memory and spills
)

P = ctypes.c_void_p
I = ctypes.c_int

# C entry points: (argtypes); every one returns cudaGetLastError() as int.
_SIGNATURES = {
    # ds, ds_stride, w0, cand, pidx, batch, t_count, stream
    "nnt_pitch_analysis": (P, I, P, P, P, I, I, P),
    # the same, then the skipped-stage mask, stream
    "nnt_pitch_analysis_skip": (P, I, P, P, P, I, I, I, P),
    # tables: FFT, band corr, band ranges, interp weights, interp bands,
    # dct, tansig; tiled int8 weights, acts (int32), weight bytes;
    # carries in: mem, synth, cmem, hv, hn, hd, lastg, period, pgain;
    # streams: filt, cand; out: packed;
    # carries out: mem, synth, cmem, hv, hn, hd, lastg, period, pgain;
    # batch, t_count, skipped-stage mask, stream
    "nnt_frame_loop": (P,) * 7 + (P, P, I) + (P,) * 9 + (P,) * 2 + (P,) + (P,) * 9
    + (I, I, I, P),
    # windows, cand, pidx, rows, stream
    "nnt_pitch_analysis_stacked": (P, P, P, I, P),
    # tansig, tiled int8 weights, acts, weight bytes; f, hv, hn, hd;
    # out: hv, hn, hd, gains, vad; batch, stream
    "nnt_rnn_step": (P, P, P, I) + (P,) * 4 + (P,) * 5 + (I, P),
    # mem, lag, out, batch, stream
    "nnt_window_at_lag": (P, P, P, I, P),
    # corr, yy, xx, pidx, out, rows, stream
    "nnt_candidates": (P, P, P, P, P, I, P),
    # FFT table, rows in, rows out, rows, stream
    "nnt_rfft960": (P, P, P, I, P),
    "nnt_irfft960": (P, P, P, I, P),
    # xw, wr; out: h, gates; batch, t_count, n, activation code, stream
    "nnt_gru_seq_fwd": (P, P, P, P, I, I, I, I, P),
    # dh, h, gates, wr; out: dxw; batch, t_count, n, activation code, stream
    "nnt_gru_seq_bwd": (P, P, P, P, P, I, I, I, I, P),
    # xw, w_hh, b_hh; out: h, gates; batch, t_count, n; plan (3 ints, host), stream
    "nnt_gru_ra_fwd": (P, P, P, P, P, I, I, I, P, P),
    # dh, h, gates, w_hh; out: dxw, dhw; batch, t_count, n; plan, stream
    "nnt_gru_ra_bwd": (P, P, P, P, P, P, I, I, I, P, P),
}

last_build_seconds = 0.0
last_build_log = ""  # nvcc's output (ptxas resource usage) of the last build


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _run_all(cmds: list) -> list:
    """Run the commands side by side; returns their (cmd, returncode,
    output) in order."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    return [(c, p.returncode, out) for c, p, out in zip(cmds, procs, outs)]


def build() -> pathlib.Path:
    """Compile the kernels if the library for the current sources is
    missing; returns its path."""
    global last_build_seconds, last_build_log
    lib = BUILD_DIR / f"libnnt_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [pathlib.Path(tmpdir) / f"{src.stem}.o" for src in _sources()]
        steps = [_run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                           for src, obj in zip(_sources(), objs)])]
        tmp = pathlib.Path(tmpdir) / lib.name
        if all(rc == 0 for _, rc, _ in steps[0]):
            steps.append(_run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]]))
        for cmd, rc, out in (r for step in steps for r in step):
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
        os.replace(tmp, lib)
    last_build_log = "".join(out for step in steps for _, _, out in step)
    last_build_seconds = time.perf_counter() - t0
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
