"""K6's plain version (ops/window.py::barrel_shift_window, through the
window_at_lag wrapper on CPU tensors) against the JAX package's barrel
shifter and its Pallas kernel in interpret mode, on lags made by numpy from
a seed.  Pure data movement on both sides, so the bar is bit-exact (as
tests/test_ops.py::test_window_at_lag_variants)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnnoiseless_tpu.ops.window import _barrel_shift_window, _pallas_window

from nnnoiseless_tpu_torch.ops import window as win

B = 256  # one Pallas block


def _inputs(max_lag: int, seed: int):
    rng = np.random.RandomState(seed)
    mem = (rng.randn(B, 1728) * 1000).astype(np.float32)
    lag = rng.randint(0, max_lag + 1, size=B).astype(np.int32)
    lag[:3] = [0, max_lag, max_lag // 2]  # both ends of the range
    return mem, lag


def _port(mem, lag):
    before = win.launches
    out = win.window_at_lag(torch.from_numpy(mem), torch.from_numpy(lag))
    assert win.launches == before  # CPU tensors never reach the kernel
    return out.numpy()


@pytest.mark.parametrize("against", ["slice", "barrel", "pallas"])
def test_window_matches_jax(against):
    """Lags in [0, 768], the range a pitch period takes."""
    mem, lag = _inputs(768, seed=21)
    if against == "slice":
        want = np.stack([m[768 - l : 1728 - l] for m, l in zip(mem, lag)])
    elif against == "barrel":
        want = np.asarray(_barrel_shift_window(jnp.asarray(mem), jnp.asarray(lag)))
    else:
        want = np.asarray(_pallas_window(jnp.asarray(mem), jnp.asarray(lag), interpret=True))
    np.testing.assert_array_equal(_port(mem, lag), want)


def test_window_zero_fill_above_768():
    """Lags up to 1023 read zeros before the history's start, as the
    ten-bit barrel shifter does."""
    mem, lag = _inputs(1023, seed=22)
    want = np.asarray(_barrel_shift_window(jnp.asarray(mem), jnp.asarray(lag)))
    got = _port(mem, lag)
    np.testing.assert_array_equal(got, want)
    i = int(np.argmax(lag))
    assert lag[i] == 1023 and not got[i, : 1023 - 768].any()


def test_window_checks_operands():
    mem = torch.zeros((2, 1728))
    with pytest.raises(TypeError):
        win.window_at_lag(mem, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        win.window_at_lag(mem, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        win.window_at_lag(mem.to("meta"), torch.zeros(2, dtype=torch.int32, device="meta"))
