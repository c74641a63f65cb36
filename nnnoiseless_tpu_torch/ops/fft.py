"""Windowed real DFT analysis / synthesis: dense bases, and the 960-point
FFT of kernel K2.

The reference runs an unnormalized 960-point real FFT, scales the forward
transform by ``wnorm = 1/sum(w^2)`` and divides the inverse by 2
(src/features.rs:281-298, 263-275).  The plain versions fold the window,
``wnorm``, the hermitian unfold and the /2 into three dense f32 bases built
in f64, the same construction as ``nnnoiseless_tpu/ops/fft.py``.

Kernel K2 (``csrc/fft960.cuh``) computes the same two functions as FFTs
inside its thread block, one warp per window: the real 960-point transform
is a 480-point complex FFT of the even/odd-packed window plus a split step,
and 480 = 15 x 32.  Each lane owns one index n2 of n = 32 n1 + n2, runs a
15-point DFT over n1 in registers (prime-factor 3 x 5, no twiddles),
multiplies by W480^(n2 k1), and the 32-point DFT over the lanes runs as
five radix-2 stages by ``__shfl_xor_sync`` (decimation in frequency, so
lane l ends with bin k1 + 15 bitrev5(l)).  The inverse is the adjoint of
the same stages, in reverse order with conjugate twiddles.
:func:`fft960_table` holds every twiddle the kernel reads, built in f64 and
rounded to f32 once; :func:`rfft960_staged` / :func:`irfft960_staged`
repeat the kernel's stages in plain PyTorch for the tests.
:func:`rfft960` / :func:`irfft960` launch the kernel's transform alone over
rows (``csrc/fft960_kernel.cu``), a probe that nothing on the main path
calls; on CPU tensors they run the dense plain versions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..constants import FRAME_SIZE, FREQ_SIZE, WINDOW_SIZE
from ..tables import VORBIS_WINDOW, WNORM

# Probe launches since the last reset (the plain versions do not count).
launches = 0


@functools.lru_cache(maxsize=1)
def dense_dft_bases():
    """Single-product DFT bases with the window/normalization chain folded in.

    Returns numpy f32 arrays (computed in f64):
      F   (960, 962): spec = w960 @ F  ==  window -> rfft -> *wnorm,
                      packed columns [re(481) | im(481)];
      IV1 (962, 480), IV2 (962, 480): y = x @ [IV1 | IV2]  ==  unnormalized
                      hermitian inverse DFT / 2 * window, split at sample 480
                      (the overlap-add head and tail).
    """
    n = np.arange(WINDOW_SIZE)[:, None]
    k = np.arange(FREQ_SIZE)[None, :]
    theta = 2.0 * np.pi * n * k / WINDOW_SIZE
    win = np.asarray(VORBIS_WINDOW, np.float64)[:, None]
    fwd = np.concatenate(
        [win * WNORM * np.cos(theta), -win * WNORM * np.sin(theta)], axis=1
    )  # (960, 962)

    # inverse: y[n] = 0.5*win[n] * (re0 + re480*(-1)^n
    #                 + sum_{k=1..479} 2*(re_k cos - im_k sin))
    ck = np.full(FREQ_SIZE, 2.0)
    ck[0] = ck[-1] = 1.0
    sk = np.full(FREQ_SIZE, -2.0)
    sk[0] = sk[-1] = 0.0
    theta_kn = (
        2.0
        * np.pi
        * np.arange(FREQ_SIZE)[:, None]
        * np.arange(WINDOW_SIZE)[None, :]
        / WINDOW_SIZE
    )
    winr = 0.5 * np.asarray(VORBIS_WINDOW, np.float64)[None, :]
    inv = np.concatenate(
        [winr * ck[:, None] * np.cos(theta_kn), winr * sk[:, None] * np.sin(theta_kn)],
        axis=0,
    )  # (962, 960)
    f32 = lambda m: np.ascontiguousarray(m, np.float32)
    return (
        f32(fwd),
        f32(inv[:, : WINDOW_SIZE // 2]),
        f32(inv[:, WINDOW_SIZE // 2 :]),
    )


@functools.lru_cache(maxsize=8)
def dft_bases(device: torch.device):
    """(F (960,962), IV (962,960) = [IV1 | IV2]) as tensors on ``device``."""
    fwd, iv1, iv2 = dense_dft_bases()
    return (
        torch.as_tensor(fwd, device=device),
        torch.as_tensor(np.concatenate([iv1, iv2], axis=1), device=device),
    )


def forward_transform(frame: torch.Tensor) -> torch.Tensor:
    """Window a (..., 960) frame -> packed (..., 962) spectrum [re | im],
    ``rfft(frame * window) * wnorm`` as one f32 product with F."""
    return torch.matmul(frame, dft_bases(frame.device)[0])


def inverse_transform(spectrum: torch.Tensor) -> torch.Tensor:
    """Packed (..., 962) spectrum -> windowed (..., 960) frame: the
    hermitian inverse DFT / 2 times the window, one f32 product with IV."""
    return torch.matmul(spectrum, dft_bases(spectrum.device)[1])


# ---------------------------------------------------------------------------
# The FFT of kernel K2 (csrc/fft960.cuh)
# ---------------------------------------------------------------------------

N1, LANES = 15, 32  # 480 = N1 x LANES, n = 32 n1 + n2, k = k1 + 15 k2
_HALF = WINDOW_SIZE // 2  # 480 complex points
# The f32 table the kernel reads (offsets in floats; complex values as
# (re, im) pairs): the analysis window; W480^(n2 k1) at [k1][n2]; the
# radix-2 stages' twiddle of lane l at [stage][l] (1 on a stage's low
# lanes); W960^k at [k1][l] for the split, k = k1 + 15 bitrev5(l); then
# sin(2pi/3), cos(2pi/5), cos(4pi/5), sin(2pi/5), sin(4pi/5), wnorm / 2.
TW_WIN, TW_480, TW_32, TW_SPLIT, TW_CONST = 0, 960, 1920, 2240, 3200
TW_FLOATS = 3208
STAGES = (16, 8, 4, 2, 1)  # lane distance of the forward radix-2 stages


def bitrev5(v):
    """The five-bit reversal of ``v`` (int or int array)."""
    v = np.asarray(v)
    return sum(((v >> b) & 1) << (4 - b) for b in range(5))


def _cis(num, den) -> np.ndarray:
    """exp(-2 pi i num / den) in f64, as an (..., 2) [re, im] array."""
    theta = 2.0 * np.pi * (np.asarray(num, np.float64) % den) / den
    return np.stack([np.cos(theta), -np.sin(theta)], axis=-1)


@functools.lru_cache(maxsize=1)
def fft960_table_f64() -> dict:
    """The twiddles of the kernel's FFT in f64, by name."""
    lanes = np.arange(LANES)
    k1 = np.arange(N1)[:, None]
    stage = []
    for d in STAGES:
        hi = (lanes & d) != 0
        w = _cis(np.where(hi, lanes & (d - 1), 0), 2 * d)
        stage.append(w)
    consts = np.array([
        np.sin(2 * np.pi / 3), np.cos(2 * np.pi / 5), np.cos(4 * np.pi / 5),
        np.sin(2 * np.pi / 5), np.sin(4 * np.pi / 5), 0.5 * float(WNORM), 0.0, 0.0,
    ])
    return {
        "win": np.asarray(VORBIS_WINDOW, np.float64),
        "w480": _cis(k1 * lanes[None, :], _HALF),  # (15, 32, 2)
        "w32": np.stack(stage),  # (5, 32, 2)
        "split": _cis(k1 + N1 * bitrev5(lanes)[None, :], WINDOW_SIZE),  # (15, 32, 2)
        "const": consts,
    }


@functools.lru_cache(maxsize=1)
def fft960_table() -> np.ndarray:
    """The (3208,) f32 table the kernel takes: each entry of
    :func:`fft960_table_f64` rounded to f32 once, at the TW_* offsets."""
    t = fft960_table_f64()
    flat = np.concatenate([t[k].reshape(-1) for k in ("win", "w480", "w32", "split", "const")])
    assert flat.shape == (TW_FLOATS,)
    return flat.astype(np.float32)


@functools.lru_cache(maxsize=8)
def fft960_table_on(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(fft960_table(), device=device)


def _tables_f32():
    t = fft960_table()
    c = lambda off, shape: torch.from_numpy(t[off : off + int(np.prod(shape))].reshape(shape).copy())
    return (
        c(TW_WIN, (WINDOW_SIZE,)), c(TW_480, (N1, LANES, 2)), c(TW_32, (5, LANES, 2)),
        c(TW_SPLIT, (N1, LANES, 2)), c(TW_CONST, (8,)),
    )


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _pfa15(re, im, c, inverse: bool):
    """The 15-point DFT over axis -2 of (..., 15, 32) as 3 x 5 prime
    factors: input n = (5a + 3b) mod 15, output k = (10c + 6d) mod 15."""
    s3, c51, c52, s51, s52 = (float(v) for v in c[:5])
    sg = 1.0 if inverse else -1.0  # sign of the sine terms, e^(sg i theta)
    a3r, a3i = [[None] * 3 for _ in range(5)], [[None] * 3 for _ in range(5)]
    for b in range(5):
        x = [((5 * a + 3 * b) % 15) for a in range(3)]
        x0r, x0i, x1r, x1i, x2r, x2i = (re[..., x[0], :], im[..., x[0], :], re[..., x[1], :],
                                        im[..., x[1], :], re[..., x[2], :], im[..., x[2], :])
        tr, ti = x1r + x2r, x1i + x2i
        mr, mi = x0r - 0.5 * tr, x0i - 0.5 * ti
        dr, di = s3 * (x1r - x2r), s3 * (x1i - x2i)
        # y1 = m + sg i d, y2 = m - sg i d
        a3r[b] = [x0r + tr, mr - sg * di, mr + sg * di]
        a3i[b] = [x0i + ti, mi + sg * dr, mi - sg * dr]
    out_r, out_i = [None] * 15, [None] * 15
    for cc in range(3):
        x = [(a3r[b][cc], a3i[b][cc]) for b in range(5)]
        t1r, t1i = x[1][0] + x[4][0], x[1][1] + x[4][1]
        t2r, t2i = x[2][0] + x[3][0], x[2][1] + x[3][1]
        t3r, t3i = x[1][0] - x[4][0], x[1][1] - x[4][1]
        t4r, t4i = x[2][0] - x[3][0], x[2][1] - x[3][1]
        y0 = (x[0][0] + t1r + t2r, x[0][1] + t1i + t2i)
        a1r, a1i = x[0][0] + c51 * t1r + c52 * t2r, x[0][1] + c51 * t1i + c52 * t2i
        a2r, a2i = x[0][0] + c52 * t1r + c51 * t2r, x[0][1] + c52 * t1i + c51 * t2i
        b1r, b1i = s51 * t3r + s52 * t4r, s51 * t3i + s52 * t4i
        b2r, b2i = s52 * t3r - s51 * t4r, s52 * t3i - s51 * t4i
        ys = [y0,
              (a1r - sg * b1i, a1i + sg * b1r), (a2r - sg * b2i, a2i + sg * b2r),
              (a2r + sg * b2i, a2i - sg * b2r), (a1r + sg * b1i, a1i - sg * b1r)]
        for d in range(5):
            k = (10 * cc + 6 * d) % 15
            out_r[k], out_i[k] = ys[d]
    return torch.stack(out_r, -2), torch.stack(out_i, -2)


def rfft960_staged(frame: torch.Tensor) -> torch.Tensor:
    """The kernel's forward transform, stage by stage in f32 on (R, 960)
    rows: window, 15-point DFTs, W480 twiddles, five radix-2 stages across
    the lanes, the split -> packed (R, 962) ``rfft(frame * window) *
    wnorm``.  For the tests; the CPU path runs :func:`forward_transform`."""
    win, w480, w32, split, c = _tables_f32()
    r = frame.shape[0]
    xw = frame.float() * win
    re = xw[:, 0::2].reshape(r, N1, LANES)  # z[32 n1 + n2]
    im = xw[:, 1::2].reshape(r, N1, LANES)
    re, im = _pfa15(re, im, c, inverse=False)
    re, im = _cmul(re, im, w480[..., 0], w480[..., 1])
    lanes = torch.arange(LANES)
    for s, d in enumerate(STAGES):  # DIF: t = partner +- own, then x twiddle
        sgn = torch.where((lanes & d) != 0, -1.0, 1.0)
        tr, ti = re[..., lanes ^ d] + sgn * re, im[..., lanes ^ d] + sgn * im
        re, im = _cmul(tr, ti, w32[s, :, 0], w32[s, :, 1])
    # lane l holds Z[k1 + 15 bitrev5(l)]; the split pairs Z[k] with Z[480 - k]
    src0 = torch.as_tensor(bitrev5((32 - bitrev5(np.arange(LANES))) & 31))
    pr = torch.cat([re[:, :1, src0], re.flip(1)[:, :-1, :][..., lanes ^ 31]], 1)
    pi = -torch.cat([im[:, :1, src0], im.flip(1)[:, :-1, :][..., lanes ^ 31]], 1)
    sr, si, dr, di = re + pr, im + pi, re - pr, im - pi
    wr, wi = split[..., 0], split[..., 1]
    half = float(c[5])
    xr = half * (sr + (wr * di + wi * dr))
    xi = half * (si - (wr * dr - wi * di))
    k = torch.as_tensor(np.arange(N1)[:, None] + N1 * bitrev5(np.arange(LANES))[None, :]).reshape(-1)
    out = torch.zeros((r, 2 * FREQ_SIZE), dtype=torch.float32)
    out[:, k] = xr.reshape(r, -1)
    out[:, FREQ_SIZE + k] = xi.reshape(r, -1)
    out[:, FRAME_SIZE] = half * (sr[:, 0, 0] - di[:, 0, 0])
    return out


def irfft960_staged(spectrum: torch.Tensor) -> torch.Tensor:
    """The kernel's inverse transform, stage by stage in f32 on packed
    (R, 962) rows: the split (im of bins 0 and 480 read as 0), five
    radix-2 stages in reverse with conjugate twiddles, W480 conjugates,
    inverse 15-point DFTs -> (R, 960) hermitian inverse DFT / 2 x window."""
    win, w480, w32, split, c = _tables_f32()
    r = spectrum.shape[0]
    spec = spectrum.float()
    k = torch.as_tensor(np.arange(N1)[:, None] + N1 * bitrev5(np.arange(LANES))[None, :])
    im_all = torch.cat([spec[:, FREQ_SIZE:], torch.zeros((r, 1))], 1)
    im_all[:, 0] = 0.0
    im_all[:, FRAME_SIZE] = 0.0
    ar, ai = spec[:, k], im_all[:, k]
    br, bi = spec[:, FRAME_SIZE - k], -im_all[:, FRAME_SIZE - k]
    er, ei, dr, di = ar + br, ai + bi, ar - br, ai - bi
    orr, oi = _cmul(dr, di, split[..., 0], -split[..., 1])  # x conj(W960^k)
    re, im = er - oi, ei + orr  # Z' = E + i O
    lanes = torch.arange(LANES)
    for s, d in reversed(list(enumerate(STAGES))):  # adjoint: m = own x conj(w)
        sgn = torch.where((lanes & d) != 0, -1.0, 1.0)
        mr, mi = _cmul(re, im, w32[s, :, 0], -w32[s, :, 1])
        re, im = mr[..., lanes ^ d] + sgn * mr, mi[..., lanes ^ d] + sgn * mi
    re, im = _cmul(re, im, w480[..., 0], -w480[..., 1])
    re, im = _pfa15(re, im, c, inverse=True)  # z'[32 n1 + n2]
    y = torch.stack([re.reshape(r, -1), im.reshape(r, -1)], -1).reshape(r, WINDOW_SIZE)
    return 0.5 * (y * win)


def _check_rows(x: torch.Tensor, width: int, name: str) -> None:
    if x.ndim != 2 or x.shape[1] != width:
        raise ValueError(f"{name} takes (R, {width}) rows, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, got {x.dtype}")


def _probe_cuda(entry: str, x: torch.Tensor, width_out: int) -> torch.Tensor:
    global launches
    if not x.is_contiguous():
        raise ValueError(f"{entry} takes contiguous rows")
    out = torch.empty((x.shape[0], width_out), dtype=torch.float32, device=x.device)
    if x.shape[0]:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(_build.library(), entry)(
            fft960_table_on(x.device).data_ptr(), x.data_ptr(), out.data_ptr(), x.shape[0], stream
        )
        _build.check(err, entry)
        launches += 1
    return out


def rfft960(frame: torch.Tensor) -> torch.Tensor:
    """(R, 960) rows -> packed (R, 962) ``rfft(frame * window) * wnorm``:
    kernel K2's forward FFT alone on CUDA rows, :func:`forward_transform`
    on CPU rows."""
    _check_rows(frame, WINDOW_SIZE, "rfft960")
    if frame.is_cuda:
        return _probe_cuda("nnt_rfft960", frame, 2 * FREQ_SIZE)
    if frame.device.type != "cpu":
        raise ValueError(f"unsupported device {frame.device}")
    return forward_transform(frame)


def irfft960(spectrum: torch.Tensor) -> torch.Tensor:
    """Packed (R, 962) rows -> (R, 960) hermitian inverse DFT / 2 x window:
    kernel K2's inverse FFT alone on CUDA rows, :func:`inverse_transform` on
    CPU rows."""
    _check_rows(spectrum, 2 * FREQ_SIZE, "irfft960")
    if spectrum.is_cuda:
        return _probe_cuda("nnt_irfft960", spectrum, WINDOW_SIZE)
    if spectrum.device.type != "cpu":
        raise ValueError(f"unsupported device {spectrum.device}")
    return inverse_transform(spectrum)
