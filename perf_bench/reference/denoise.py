"""The plain reference of the denoiser: RNNoise's frame (nnnoiseless
src/denoise.rs:95-140, src/features.rs:97-298, src/pitch.rs:63-483,
src/rnn.rs:242-379) in plain PyTorch, for a batch of streams that all start
from a reset.

It imports nothing of the program.  Frame-local work (the HP biquad, the
decimation, the pitch search and its octave-removal candidates, the lag-0
spectrum, band energies and cepstrum) runs for every frame at once; the
carry-dependent rest (the octave choice with the previous period, the
spectrum at the pitch lag, the features, the RNN, the comb filter and the
synthesis) runs frame by frame.  Products are dense matrix products
(DFTs, band sums, the biquad's block form) and 1-D convolutions (the pitch
correlations), so they follow torch's TF32 switches: off for the reference,
on for its control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import tables as tb

_ROWS = 1 << 15  # windows per convolution call


class Tables:
    """The reference's tables as float32 tensors on one device."""

    def __init__(self, device):
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        self.fwd, self.inv = (t(m) for m in tb.dft_bases())
        corr, interp = tb.band_matrices()
        self.corr = t(corr.T)  # (481, 22)
        self.interp = t(interp.T)  # (22, 481)
        self.dct = t(tb.dct_table())
        self.tansig = t(tb.tansig_table())
        self.biquad = tuple(t(m) for m in tb.biquad_block(tb.FRAME))
        self.taper = tb.lpc_taper()


# ---------------------------------------------------------------------------
# bands, activations
# ---------------------------------------------------------------------------


def band_corr(tab: Tables, x, p):
    """Band correlation of packed (..., 962) spectra -> (..., 22)."""
    return torch.matmul(x[..., : tb.FREQ] * p[..., : tb.FREQ] + x[..., tb.FREQ :] * p[..., tb.FREQ :], tab.corr)


def interp_gain(tab: Tables, g):
    """(..., 22) band values -> (..., 962) per-bin gains, re and im alike."""
    half = torch.matmul(g, tab.interp)
    return torch.cat([half, half], dim=-1)


def dct(tab: Tables, x):
    return torch.matmul(x, tab.dct) * tb.DCT_SCALE


def tansig(tab: Tables, x):
    """The table tanh of util.rs:29-53."""
    sign = torch.where(x < 0.0, -1.0, 1.0)
    ax = torch.clamp(torch.nan_to_num(x, nan=0.0).abs(), max=7.99)
    i = torch.floor(0.5 + 25.0 * ax)
    frac = ax - 0.04 * i
    y = tab.tansig[i.to(torch.int64)]
    dy = 1.0 - y * y
    y = sign * (y + frac * dy * (1.0 - y * frac))
    y = torch.where(x > -8.0, y, -1.0)
    return torch.where(x < 8.0, y, 1.0)


def activate(tab: Tables, x, act: int):
    if act == tb.TANH:
        return tansig(tab, x)
    if act == tb.SIGMOID:
        return 0.5 + 0.5 * tansig(tab, 0.5 * x)
    return torch.clamp(x, min=0.0)


# ---------------------------------------------------------------------------
# pitch (frame-local part)
# ---------------------------------------------------------------------------


def lpc4(ac):
    """Order-4 Levinson-Durbin with the reference's early exit (pitch.rs:257-292)."""
    lpc = [torch.zeros_like(ac[0])] * 4
    error = ac[0]
    done = ac[0] == 0.0
    thresh = 0.001 * ac[0]
    for i in range(4):
        rr = ac[i + 1]
        for j in range(i):
            rr = rr + lpc[j] * ac[i - j]
        r = -rr / torch.where(done, torch.ones_like(error), error)
        new = list(lpc)
        new[i] = r
        for j in range((i + 1) // 2):
            new[j], new[i - 1 - j] = new[j] + r * new[i - 1 - j], new[i - 1 - j] + r * new[j]
        lpc = [torch.where(done, o, n) for o, n in zip(lpc, new)]
        error = torch.where(done, error, error - r * r * error)
        done = done | (error < thresh)
    return lpc


def whiten(tab: Tables, x):
    """LPC whitening of (R, 864) decimated windows (pitch.rs:448-483)."""
    n = x.shape[-1]
    ac = [(x * x).sum(-1)] + [(x[:, : n - k] * x[:, k:]).sum(-1) for k in range(1, 5)]
    ac[0] = ac[0] * 1.0001
    for i in range(1, 5):
        ac[i] = ac[i] - ac[i] * tb.LAG_WINDOW[i]
    c = [v * tab.taper[i] for i, v in enumerate(lpc4(ac))]
    taps = [c[0] + 0.8, c[1] + 0.8 * c[0], c[2] + 0.8 * c[1], c[3] + 0.8 * c[2], 0.8 * c[3]]
    y = x
    for j in range(1, 6):
        y = y + taps[j - 1][:, None] * F.pad(x[:, : n - j], (j, 0))
    return y


def sliding_dot(kernel, y, n_lags: int):
    """corr[r, s] = dot(kernel[r], y[r, s : s + len]) for s < n_lags."""
    out = [F.conv1d(y[i : i + _ROWS][None], kernel[i : i + _ROWS, None, :], groups=min(_ROWS, y.shape[0] - i))[0]
           for i in range(0, y.shape[0], _ROWS)]
    return torch.cat(out)[:, :n_lags]


def window_energies(y, length: int, n_lags: int):
    ones = torch.ones((1, 1, length), dtype=y.dtype, device=y.device)
    out = [F.conv1d((y[i : i + _ROWS] ** 2)[:, None], ones)[:, 0] for i in range(0, y.shape[0], _ROWS)]
    return torch.cat(out)[:, :n_lags]


def best_two(xcorr, energies):
    """find_best_pitch (pitch.rs:372-405): the top two lags by
    xcorr^2 / max(1 + energy, 1) over positive xcorr, the earlier lag on a
    tie; sentinels 0 (one qualified) or 1 (none) for the second."""
    qualified = xcorr > 0.0
    neg = torch.full_like(xcorr, float("-inf"))
    ratio = torch.where(qualified, xcorr * xcorr / torch.clamp(1.0 + energies, min=1.0), neg)
    best = torch.argmax(ratio, dim=-1)
    lanes = torch.arange(xcorr.shape[-1], device=xcorr.device)
    ratio2 = torch.where(lanes == best[:, None], neg, ratio)
    second = torch.where((ratio2 > float("-inf")).any(-1), torch.argmax(ratio2, dim=-1),
                         torch.where(qualified.any(-1), 0, 1))
    return best, second


def pitch_search(y, corr, energies):
    """Coarse and fine search (pitch.rs:63-115): 2 * best - offset."""
    x4 = y[:, tb.MAX_DS :: 2][:, : tb.LEN4]
    y4 = y[:, 0::2][:, : tb.LEN4 + tb.N_COARSE]
    best4, second4 = best_two(sliding_dot(x4, y4, tb.N_COARSE), window_energies(y4, tb.LEN4, tb.N_COARSE))
    lags = torch.arange(tb.N_FINE, device=y.device)
    near = ((lags - 2 * best4[:, None]).abs() <= 2) | ((lags - 2 * second4[:, None]).abs() <= 2)
    xcorr = torch.where(near, torch.clamp(corr[:, : tb.N_FINE], min=-1.0), 0.0)
    best, _ = best_two(xcorr, energies[:, : tb.N_FINE])
    at = lambda i: xcorr.gather(1, torch.clamp(i, 0, tb.N_FINE - 1)[:, None])[:, 0]
    a, b, c = at(best - 1), at(best), at(best + 1)
    offset = torch.where(c - a > 0.7 * (b - a), 1, torch.where(a - c > 0.7 * (b - c), -1, 0))
    return 2 * best - torch.where((best > 0) & (best < tb.N_FINE - 1), offset, 0)


def candidates(corr, energies, pitch_idx):
    """The octave-removal candidates of each window (pitch.rs:118-172): the
    (R, 105) lanes [t0, g0, xy0, yy0, t1 (14), xy (14), yy (14), g1 (14),
    corr at c - 1, c, c + 1 for c in (t0, t1_2..t1_15)]."""
    maxp = tb.MAX_DS

    def at(table, t):
        return table.gather(1, torch.clamp(maxp - t, 0, maxp)[:, None])[:, 0]

    corr_at = lambda t: at(corr, t)
    yy_at = lambda t: torch.clamp(at(energies, t), min=0.0)
    t0 = torch.clamp(pitch_idx // 2, max=maxp - 1)
    xx = torch.clamp(energies[:, maxp], min=0.0)
    gain = lambda xy, yy: xy / torch.sqrt(1.0 + xx * yy)
    xy0, yy0 = corr_at(t0), yy_at(t0)
    t1s, xys, yys = [], [], []
    for k in range(2, 16):
        t1 = (2 * t0 + k) // (2 * k)
        if k == 2:
            t1b = torch.where(t1 + t0 > maxp, t0, t0 + t1)
        else:
            t1b = (2 * tb.SECOND_CHECK[k] * t0 + k) // (2 * k)
        t1s.append(t1)
        xys.append((corr_at(t1) + corr_at(t1b)) * 0.5)
        yys.append((yy_at(t1) + yy_at(t1b)) * 0.5)
    cands = [t0] + t1s
    f = lambda vs: [v.to(torch.float32) for v in vs]
    lanes = (f([t0]) + [gain(xy0, yy0), xy0, yy0] + f(t1s) + xys + yys
             + [gain(xy, yy) for xy, yy in zip(xys, yys)]
             + [corr_at(t - 1) for t in cands] + [corr_at(t) for t in cands] + [corr_at(t + 1) for t in cands])
    return torch.stack(lanes, dim=-1)


def pitch_candidates(tab: Tables, hist):
    """(R, 1728) filtered input histories -> (R, 105) candidate lanes."""
    even, odd = hist[:, 0::2], hist[:, 1::2]
    ds = ((F.pad(odd[:, :-1], (1, 0)) + odd) * 0.5 + even) * 0.5  # x[-1] = 0 (pitch.rs:455-458)
    y = whiten(tab, ds)
    corr = sliding_dot(y[:, tb.MAX_DS :], y, tb.N_LAGS)
    energies = window_energies(y, tb.FRAME_DS, tb.N_LAGS)
    pidx = tb.PITCH_MAX_PERIOD - pitch_search(y, corr, energies)
    return candidates(corr, energies, pidx)


def choose_period(cand, last_period, last_gain):
    """The carry-dependent octave choice (pitch.rs:173-221) over k = 2..15
    at once: the last k whose gain beats its threshold, among the k before
    the first candidate below the minimum period.  Returns (period int64,
    gain)."""
    dev = cand.device
    minp = float(tb.MIN_DS)
    k = torch.arange(2, 16, device=dev, dtype=torch.float32)
    t0, g0, xy0, yy0 = cand[:, 0], cand[:, 1], cand[:, 2], cand[:, 3]
    t1, xy, yy, g1 = cand[:, 4:18], cand[:, 18:32], cand[:, 32:46], cand[:, 46:60]
    active = torch.cumprod((t1 >= minp).to(torch.int32), dim=1).bool()
    prev = torch.floor(last_period.to(torch.float32) * 0.5)[:, None]
    adiff = (t1 - prev).abs()
    lg = last_gain[:, None]
    cont = torch.where(adiff <= 1, lg, torch.where((adiff <= 2) & (5.0 * k * k < t0[:, None]), lg * 0.5, 0.0))
    g0c = g0[:, None]
    thresh = torch.where(t1 < 3 * minp, torch.clamp(0.85 * g0c - cont, min=0.4),
                         torch.clamp(0.7 * g0c - cont, min=0.3))
    upd = active & (g1 > thresh)
    pos = torch.arange(1, 15, device=dev)
    last = (upd * pos).amax(dim=1)  # 0: no k updated, else k - 1
    pick = lambda v, v0: torch.where(last > 0, v.gather(1, torch.clamp(last - 1, min=0)[:, None])[:, 0], v0)
    best_xy = torch.clamp(pick(xy, xy0), min=0.0)
    best_yy, t, g = pick(yy, yy0), pick(t1, t0), pick(g1, g0)
    pg = torch.where(best_yy <= best_xy, torch.ones_like(g), best_xy / (best_yy + 1.0))
    lane = lambda off: cand.gather(1, (off + last)[:, None])[:, 0]
    c0, c1, c2 = lane(60), lane(75), lane(90)
    offset = torch.where(c2 - c0 > 0.7 * (c1 - c0), 1.0, torch.where(c0 - c2 > 0.7 * (c1 - c2), -1.0, 0.0))
    period = torch.clamp(2 * t + offset, min=float(tb.PITCH_MIN_PERIOD))
    return period.to(torch.int64), torch.minimum(pg, g)


# ---------------------------------------------------------------------------
# features, RNN, synthesis
# ---------------------------------------------------------------------------


def log_spectrum(ex):
    """Floored log band energies (features.rs:147-158) -> (ly, total energy)."""
    raw = torch.log10(0.01 + ex)
    log_max = torch.full_like(raw[..., 0], -2.0)
    follow = torch.full_like(raw[..., 0], -2.0)
    ly = []
    for i in range(tb.NB_BANDS):
        v = torch.maximum(torch.maximum(raw[..., i], log_max - 7.0), follow - 1.5)
        log_max = torch.maximum(log_max, v)
        follow = torch.maximum(follow - 1.5, v)
        ly.append(v)
    return torch.stack(ly, dim=-1), ex.sum(-1)


class Rnn:
    """The model's six layers (int8 values as float32) and their activations."""

    def __init__(self, tab: Tables, model_path, device):
        params, meta = tb.read_rnn(model_path)
        self.tab, self.meta = tab, meta
        self.p = {layer: {k: torch.as_tensor(v, device=device) for k, v in d.items()} for layer, d in params.items()}

    def dense(self, name, x):
        layer = self.p[name]
        return activate(self.tab, (layer["b"] + x @ layer["w"]) * tb.WEIGHTS_SCALE, self.meta[name][2])

    def gru(self, name, h, x):
        layer, n, act = self.p[name], self.meta[name][1], self.meta[name][2]
        gi = x @ layer["wi"]
        hr = h @ layer["wr"][:, : 2 * n]
        b = layer["b"]
        sig = lambda v: activate(self.tab, v, tb.SIGMOID)
        z = sig(tb.WEIGHTS_SCALE * (b[:n] + gi[:, :n] + hr[:, :n]))
        r = sig(tb.WEIGHTS_SCALE * (b[n : 2 * n] + gi[:, n : 2 * n] + hr[:, n:]))
        hh = activate(self.tab, tb.WEIGHTS_SCALE * (b[2 * n :] + gi[:, 2 * n :] + (r * h) @ layer["wr"][:, 2 * n :]), act)
        return z * h + (1.0 - z) * hh

    def step(self, state, f):
        d = self.dense("input_dense", f)
        hv = self.gru("vad_gru", state[0], d)
        hn = self.gru("noise_gru", state[1], torch.cat([d, hv, f], -1))
        hd = self.gru("denoise_gru", state[2], torch.cat([hv, hn, f], -1))
        return (hv, hn, hd), self.dense("denoise_output", hd), self.dense("vad_output", hv)[:, 0]


class Reference:
    """The plain denoiser for one model on one device."""

    def __init__(self, model_path, device):
        self.device = torch.device(device)
        self.tab = Tables(self.device)
        self.rnn = Rnn(self.tab, model_path, self.device)

    @torch.no_grad()
    def run(self, frames: torch.Tensor, periods: bool = False):
        """(B, T, 480) float32 frames of streams fresh from a reset ->
        (out (B, T, 480), vad (B, T)), and with ``periods`` each frame's
        pitch period (B, T)."""
        tab, dev = self.tab, self.device
        frames = frames.to(dev, torch.float32)
        b, t_count, _ = frames.shape
        W, P, H, Q = tab.biquad
        mem = torch.zeros((b, 2), device=dev)
        filtered = []
        for t in range(t_count):
            x = frames[:, t]
            filtered.append(x + x @ W + mem @ P)
            mem = x @ H + mem @ Q
        full = torch.cat([torch.zeros((b, tb.PITCH_BUF), device=dev), torch.stack(filtered, 1).reshape(b, -1)], 1)
        hist = full.unfold(1, tb.PITCH_BUF, tb.FRAME)[:, 1:]  # (B, T, 1728): frame t's history
        cand = pitch_candidates(tab, hist.reshape(b * t_count, tb.PITCH_BUF)).reshape(b, t_count, -1)
        x_all = hist[..., tb.LAG0 :] @ tab.fwd  # (B, T, 962)
        ex_all = band_corr(tab, x_all, x_all)
        ly, energy = log_spectrum(ex_all)
        ceps_all = dct(tab, ly)
        ceps_all[..., 0] -= 12.0
        ceps_all[..., 1] -= 4.0
        silent_all = energy < 0.04

        z = lambda *s: torch.zeros((b,) + s, device=dev)
        period, pgain = torch.zeros(b, dtype=torch.int64, device=dev), z()
        cmem, lastg, synth = z(tb.CEPS_MEM, tb.NB_BANDS), z(tb.NB_BANDS), z(tb.FRAME)
        state = tuple(z(self.rnn.meta[g][1]) for g in tb.GRUS)
        eye = torch.eye(tb.CEPS_MEM, device=dev) * 1e15
        offs = torch.arange(tb.WINDOW, device=dev)
        rows = torch.arange(b, device=dev)[:, None]
        outs, vads, pers = [], [], []
        for t in range(t_count):
            x, ex, ceps, silent = x_all[:, t], ex_all[:, t], ceps_all[:, t], silent_all[:, t]
            sil = silent[:, None]
            period, pgain = choose_period(cand[:, t], period, pgain)
            pers.append(period)
            start = tb.LAG0 - period[:, None] + offs  # index into frame t's history
            win = full[rows, tb.FRAME * (t + 1) + torch.clamp(start, min=0)]
            p = torch.where(start >= 0, win, 0.0) @ tab.fwd
            ep = band_corr(tab, p, p)
            exp = band_corr(tab, x, p) / torch.sqrt(0.001 + ex * ep)
            fp = dct(tab, exp)[:, : tb.NB_DELTA]
            fp[:, 0] -= 1.3
            fp[:, 1] -= 0.9
            new_cm = torch.cat([ceps[:, None], cmem[:, :-1]], 1)
            c0, c1, c2 = ceps[:, : tb.NB_DELTA], new_cm[:, 1, : tb.NB_DELTA], new_cm[:, 2, : tb.NB_DELTA]
            diff = new_cm[:, :, None, :] - new_cm[:, None, :, :]
            spec_var = ((diff * diff).sum(-1) + eye).min(dim=2).values.sum(-1) / float(tb.CEPS_MEM) - 2.1
            feats = torch.cat([c0 + c1 + c2, ceps[:, tb.NB_DELTA :], c0 - c2, c0 - 2.0 * c1 + c2, fp,
                               (0.01 * (period.to(torch.float32) - 300.0))[:, None], spec_var[:, None]], 1)
            feats = torch.where(sil, 0.0, feats)
            cmem = torch.where(sil[:, :, None], cmem, new_cm)
            new_state, gains, vad = self.rnn.step(state, feats)
            state = tuple(torch.where(sil, old, new) for old, new in zip(state, new_state))
            # the comb filter and its renormalisation (features.rs:223-257)
            gsq, esq = gains * gains, exp * exp
            r = torch.where(exp > gains, 1.0, esq * (1.0 - gsq) / (0.001 + gsq * (1.0 - esq)))
            r = torch.sqrt(torch.clamp(r, 0.0, 1.0)) * torch.sqrt(ex / (1e-8 + ep))
            x1 = x + p * interp_gain(tab, r)
            x1 = x1 * interp_gain(tab, torch.sqrt(ex / (1e-8 + band_corr(tab, x1, x1))))
            g2 = torch.maximum(gains, 0.6 * lastg)
            y = torch.where(sil, x, x1 * interp_gain(tab, g2)) @ tab.inv
            lastg = torch.where(sil, lastg, g2)
            outs.append(y[:, : tb.FRAME] + synth)
            synth = y[:, tb.FRAME :]
            vads.append(torch.where(silent, 0.0, vad))
        out = (torch.stack(outs, 1), torch.stack(vads, 1))
        return (*out, torch.stack(pers, 1)) if periods else out
