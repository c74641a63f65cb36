"""The port's entry points run on the card unless the caller asks for the
CPU: each defaults to ``device="cuda"``, and without a card it raises
``denoise.check_device``'s error, never running on the CPU instead; with
``device="cpu"`` it runs the plain versions."""

import inspect

import numpy as np
import pytest
import torch

import nnnoiseless_tpu_torch as nt
from nnnoiseless_tpu_torch.tools import trace

_SIG = np.zeros(2 * 480, np.float32)

# name -> (the callable whose signature holds the default, a call)
ENTRY_POINTS = {
    "DenoiseState": (nt.DenoiseState.__init__, lambda **kw: nt.DenoiseState(**kw)),
    "DenoiseState.new": (nt.DenoiseState.new, lambda **kw: nt.DenoiseState.new(**kw)),
    "DenoiseState.from_model": (nt.DenoiseState.from_model,
                                lambda **kw: nt.DenoiseState.from_model(nt.RnnModel.default(), **kw)),
    "StreamBatch": (nt.StreamBatch.__init__, lambda **kw: nt.StreamBatch(2, **kw)),
    "denoise_audio": (nt.denoise_audio, lambda **kw: nt.denoise_audio(_SIG, **kw)),
    "DenoiseSignal": (nt.DenoiseSignal.__init__, lambda **kw: list(nt.DenoiseSignal(_SIG / 32768.0, **kw))),
    "pitch_trace": (trace.pitch_trace, lambda **kw: trace.pitch_trace(_SIG, **kw)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_defaults_to_cuda_and_raises_without_a_card(name):
    holder, call = ENTRY_POINTS[name]
    assert inspect.signature(holder).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_runs_on_the_cpu_when_asked(name):
    _, call = ENTRY_POINTS[name]
    call(device="cpu")


def test_engine_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        nt.Engine(nt.RnnModel.default(), "cuda")
    assert nt.Engine(nt.RnnModel.default(), "cpu").device.type == "cpu"


def test_native_engine_needs_no_device():
    out, _ = nt.DenoiseState(engine="native").process_frame(np.zeros(480, np.float32))
    assert out.shape == (480,)
