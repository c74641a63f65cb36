"""The serving path's programs (nnnoiseless_tpu_torch/programs.py) on the
CPU against the JAX package and against the eager steps they wrap.

On the CPU a program runs the eager step on its static tensors, so its
outputs must equal a loop of the eager step bit for bit.  Against the JAX
package the bars are the reference's own cross-implementation bars (the
golden metric: rel squared error < 1e-4, at most 2 i16 units a sample;
vad within 5e-3, as tests/test_torch_pipeline.py::test_frame_step_matches_jax)
for the per-frame path, and K2's bars (output within 0.01 units, vad
within 1e-5, periods exact, as tests/test_torch_pipeline.py's scan tests)
for the scan engine.

The ``cuda`` cases need a card and skip here: there the programs are CUDA
graphs, held bit-equal to the eager steps on the card, and a capture that
fails must raise.  The file imports JAX only inside the tests that compare
with it, so the ``cuda`` cases run where JAX is not installed::

    NNT_TEST_PLATFORM=cuda python -m pytest tests/test_torch_programs.py -q -m cuda
"""

import numpy as np
import pytest
import torch

import nnnoiseless_tpu_torch as nt
from nnnoiseless_tpu_torch.chunk import precompute_chunk
from nnnoiseless_tpu_torch.constants import FRAME_SIZE
from nnnoiseless_tpu_torch.ops import activations, biquad
from nnnoiseless_tpu_torch.pipeline import FramePre, frame_step, frame_step_hoisted
from nnnoiseless_tpu_torch.programs import StepProgram, leaves
from nnnoiseless_tpu_torch.tables import BIQUAD_HP_A, BIQUAD_HP_B

T_CLIP = 100  # whole frames of the golden clip


def _golden_bars(got, want):
    """The golden metric between two outputs (tests/test_golden.py's
    relative squared error): rel < 1e-4, at most 2 units."""
    got, want = np.asarray(got, np.float64).ravel(), np.asarray(want, np.float64).ravel()
    assert np.sum((want - got) ** 2) / np.sum(got**2) < 1e-4
    assert np.abs(got - want).max() <= 2


def _eager_frames(engine, frames):
    """A loop of the eager pipeline.frame_step at B=1 from a zero carry."""
    carry = nt.init_batch_carry(engine.model.meta, 1, engine.device)
    outs, vads = [], []
    for f in frames:
        carry, out, vad = frame_step(engine.rnn, carry, torch.as_tensor(f[None], device=engine.device),
                                     engine.rnn_weights)
        outs.append(out[0].cpu().numpy())
        vads.append(float(vad[0]))
    return np.stack(outs), np.array(vads)


def _eager_scan(engine, carry, frames):
    """The scan engine as a loop of the eager frame_step_hoisted:
    (out (B, T, 480), vad (B, T), final carry without hp_mem's patch)."""
    pre, _ = precompute_chunk(carry.feat.input_mem, carry.feat.hp_mem, frames, lag0=True)
    outs, vads = [], []
    for t in range(frames.shape[1]):
        carry, out, vad = frame_step_hoisted(engine.rnn, carry, FramePre(*(f[t] for f in pre)),
                                             engine.rnn_weights)
        outs.append(out)
        vads.append(vad)
    return torch.stack(outs, 1), torch.stack(vads, 1), carry


@pytest.fixture(scope="module")
def engine():
    return nt.Engine(nt.RnnModel.default(), "cpu")


@pytest.fixture(scope="module")
def clip_frames(testing_raw):
    return testing_raw[: T_CLIP * FRAME_SIZE].reshape(T_CLIP, FRAME_SIZE)


@pytest.fixture(scope="module")
def per_frame(engine, clip_frames, default_model):
    """The golden clip through the port's DenoiseState.process_frame, a
    loop of the eager frame_step, and the JAX DenoiseState.process_frame
    (its _frame_step_jit)."""
    from nnnoiseless_tpu import DenoiseState as JaxDenoiseState

    state = nt.DenoiseState(engine)
    port = [state.process_frame(f) for f in clip_frames]
    jax_state = JaxDenoiseState(default_model)
    ref = [jax_state.process_frame(f) for f in clip_frames]
    return ((np.stack([o for o, _ in port]), np.array([v for _, v in port])),
            _eager_frames(engine, clip_frames),
            (np.stack([np.asarray(o) for o, _ in ref]), np.array([v for _, v in ref])))


def test_process_frame_equals_the_eager_loop(per_frame):
    (out, vad), (out_e, vad_e), _ = per_frame
    np.testing.assert_array_equal(out, out_e)
    np.testing.assert_array_equal(vad, vad_e)


def test_process_frame_matches_jax_state(per_frame, reference_output):
    """Against the JAX state under the golden bars (measured: rel ~1e-7),
    vad within 5e-3; and the reference oracle itself."""
    (out, vad), _, (out_j, vad_j) = per_frame
    _golden_bars(out, out_j)
    np.testing.assert_allclose(vad, vad_j, rtol=0, atol=5e-3)
    _golden_bars(out.ravel()[FRAME_SIZE:].astype(np.int16), reference_output)


def _interleaved(state, frames):
    """process_frame x10, process_chunk of 20 frames, process_frame x10,
    reset(), process_frame x5: the 45 outputs and vads in order."""
    outs, vads = [], []

    def frame(f):
        o, v = state.process_frame(f)
        outs.append(np.asarray(o))
        vads.append(float(v))

    for f in frames[:10]:
        frame(f)
    o, v = state.process_chunk(frames[10:30])
    outs.extend(np.asarray(o))
    vads.extend(np.asarray(v).tolist())
    for f in frames[30:40]:
        frame(f)
    state.reset()
    for f in frames[:5]:
        frame(f)
    return np.stack(outs), np.array(vads)


def test_interleaved_calls_match_jax_state(engine, clip_frames, default_model):
    """Frames, a chunk, frames, a reset and frames on one state: the
    chunk (the batched engine at B=1) reads the carry the frames left and
    leaves its own for the frames after it, as on the JAX state.  Golden
    bars over the 45 outputs, vad within 5e-3; the 5 frames after the
    reset equal the first 5 bit for bit."""
    from nnnoiseless_tpu import DenoiseState as JaxDenoiseState

    out, vad = _interleaved(nt.DenoiseState(engine), clip_frames)
    out_j, vad_j = _interleaved(JaxDenoiseState(default_model), clip_frames)
    _golden_bars(out, out_j)
    np.testing.assert_allclose(vad, vad_j, rtol=0, atol=5e-3)
    np.testing.assert_array_equal(out[40:], out[:5])


def test_reset_and_carry_assignment(engine, clip_frames):
    """reset() zeroes the static carry in place and reproduces the first
    outputs bit for bit; assigning a saved carry copies it into the same
    static tensors and reproduces the outputs that followed it; the carry
    read is a copy that later frames leave alone."""
    state = nt.DenoiseState(engine)
    static = [id(t) for t in leaves(state.program.carry)]
    first = [state.process_frame(f)[0] for f in clip_frames[:5]]
    saved = state.carry
    kept = [t.clone() for t in leaves(saved)]
    after = [state.process_frame(f)[0] for f in clip_frames[5:10]]
    assert all(torch.equal(a, b) for a, b in zip(leaves(saved), kept))
    state.carry = saved
    np.testing.assert_array_equal([state.process_frame(f)[0] for f in clip_frames[5:10]], after)
    state.reset()
    assert all(float(t.abs().max()) == 0 for t in leaves(state.program.carry))
    np.testing.assert_array_equal([state.process_frame(f)[0] for f in clip_frames[:5]], first)
    assert [id(t) for t in leaves(state.program.carry)] == static


@pytest.mark.parametrize("table", ["biquad_frame", "biquad_chunk", "tansig"])
def test_tables_uploaded_once_per_device(table):
    """The per-frame step's constant tables come back as the same tensor
    object on every call (an upload a call cannot be captured)."""
    a, b = (float(BIQUAD_HP_A[0]), float(BIQUAD_HP_A[1])), (float(BIQUAD_HP_B[0]), float(BIQUAD_HP_B[1]))
    dev = torch.device("cpu")
    get = {
        "biquad_frame": lambda: biquad._linear_tables(*a, *b, FRAME_SIZE, dev),
        "biquad_chunk": lambda: biquad._carry_prop_tables(*a, *b, 120, 12, dev),
        "tansig": lambda: (activations.tansig_table(dev),),
    }[table]
    first, again = get(), get()
    assert all(isinstance(t, torch.Tensor) and t.device == dev for t in first)
    assert all(x is y for x, y in zip(first, again, strict=True))


def test_scan_program_matches_jax_scan_batch(testing_raw, default_model):
    """The scan engine (one program a batch, reused across chunks) on two
    chunks of B=3, T=6 against two chained calls of the JAX _scan_batch
    under K2's bars, and bit-equal to a loop of the eager
    frame_step_hoisted from the same carry."""
    import jax.numpy as jnp

    from nnnoiseless_tpu import init_batch_carry as jax_init
    from nnnoiseless_tpu.denoise import _scan_batch

    b, t = 3, 6
    engine = nt.Engine(nt.RnnModel.default(), "cpu", fused=False)
    frames = testing_raw[: b * 2 * t * FRAME_SIZE].reshape(b, 2 * t, FRAME_SIZE)
    batch = nt.StreamBatch(b, engine, device="cpu")
    carry_j = jax_init(default_model.meta, b)
    for c in range(2):
        chunk = frames[:, c * t : (c + 1) * t]
        carry0 = batch.carry
        out, vad = batch.process_tensor(torch.from_numpy(chunk))
        carry_j, out_j, vad_j = _scan_batch(default_model.params, default_model.meta, carry_j,
                                            jnp.asarray(chunk))
        np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=0.01, rtol=1e-5)
        np.testing.assert_allclose(vad.numpy(), np.asarray(vad_j), atol=1e-5)
        np.testing.assert_array_equal(batch.carry.feat.pitch_period.numpy(),
                                      np.asarray(carry_j.feat.pitch_period))
        out_e, vad_e, carry_e = _eager_scan(engine, carry0, torch.from_numpy(chunk))
        assert torch.equal(out, out_e) and torch.equal(vad, vad_e)
        for name in ("input_mem", "cepstral_mem", "pitch_period", "pitch_gain"):
            assert torch.equal(getattr(batch.carry.feat, name), getattr(carry_e.feat, name))
    assert list(engine.scan_programs) == [b]


def test_scan_trace_and_carry_are_the_callers(testing_raw):
    """return_trace gives each frame's period and gain, and the returned
    carry's tensors are not the program's static ones (a later chunk
    leaves them alone)."""
    b, t = 2, 4
    engine = nt.Engine(nt.RnnModel.default(), "cpu", fused=False)
    frames = torch.from_numpy(testing_raw[: b * t * FRAME_SIZE].reshape(b, t, FRAME_SIZE))
    carry, out, _, (periods, gains) = nt.scan_chunk(engine, nt.init_batch_carry(engine.model.meta, b, "cpu"),
                                                    frames, return_trace=True)
    assert periods.shape == (b, t) and periods.dtype == torch.int32 and gains.shape == (b, t)
    assert torch.equal(periods[:, -1], carry.feat.pitch_period)
    assert torch.equal(gains[:, -1], carry.feat.pitch_gain)
    static = {id(x) for x in leaves(engine.scan_program(b).carry)}
    assert not static & {id(x) for x in leaves(carry)}
    kept = [x.clone() for x in leaves(carry)]
    nt.scan_chunk(engine, carry, frames)
    assert all(torch.equal(x, k) for x, k in zip(leaves(carry), kept))


def _custom_model(seed):
    """A valid model of non-standard topology (a 32-neuron vad GRU) with
    seeded int8-valued weights: the scan engine serves it."""
    from nnnoiseless_tpu_torch.model import LayerMeta, ModelMeta

    rng = np.random.RandomState(seed)
    layers = (
        ("input_dense", 42, 24, 0), ("vad_gru", 24, 32, 1), ("noise_gru", 98, 48, 2),
        ("denoise_gru", 122, 96, 2), ("denoise_output", 96, 22, 1), ("vad_output", 32, 1, 1),
    )
    w = lambda *shape: rng.randint(-40, 41, size=shape).astype(np.float32)
    params = {
        name: ({"wi": w(n_in, 3 * n), "wr": w(n, 3 * n), "b": w(3 * n)} if name.endswith("gru")
               else {"w": w(n_in, n), "b": w(n)})
        for name, n_in, n, _ in layers
    }
    return nt.RnnModel(params, ModelMeta(*(LayerMeta(n_in, n, a) for _, n_in, n, a in layers)))


def test_split_over_the_scan_engine(testing_raw):
    """sharded_process_frames of a model the scan engine serves, over two
    CPU entries for two chunks (the second from the sharded carry), against
    the unsharded scan engine under tests/test_torch_parallel.py's bars
    (out 1.0 unit, vad 1e-3); each shard runs the program of its batch."""
    from nnnoiseless_tpu_torch.parallel import make_mesh, sharded_process_frames

    model = _custom_model(11)
    b, t = 4, 5
    frames = testing_raw[: b * 2 * t * FRAME_SIZE].reshape(b, 2 * t, FRAME_SIZE)
    engine = nt.Engine(model, "cpu")
    assert not engine.two_phase
    carry = nt.init_batch_carry(model.meta, b, "cpu")
    sharded = carry
    mesh = make_mesh(["cpu", "cpu"])
    for c in range(2):
        chunk = frames[:, c * t : (c + 1) * t]
        carry, out, vad = nt.process_frames(engine, carry, chunk)
        sharded, out_s, vad_s = sharded_process_frames(model, sharded, chunk, mesh)
        np.testing.assert_allclose(out_s.numpy(), out.numpy(), atol=1.0)
        np.testing.assert_allclose(vad_s.numpy(), vad.numpy(), atol=1e-3)
    assert list(engine.scan_programs) == [b]


def test_step_program_on_the_cpu_runs_the_step():
    """On the CPU every call runs the step, and nothing is captured."""
    x = torch.zeros(3)
    prog = StepProgram(lambda: x.add_(1.0), [x], "cpu")
    prog()
    prog()
    assert x.tolist() == [2.0, 2.0, 2.0]
    assert prog.graph is None and prog.replays == 0 and prog.captured == {}


# ---- on a card -----------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda_engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return nt.Engine(nt.RnnModel.default(), "cuda")


@pytest.mark.cuda
def test_frame_graph_equals_eager_on_the_card(cuda_engine, clip_frames, reference_output):
    """process_frame replays one graph a call, with K3, K5 and K6 in it,
    bit-equal to the eager frame_step loop on the card, and meets the
    golden bars."""
    state = nt.DenoiseState(cuda_engine)
    out = np.stack([state.process_frame(f)[0] for f in clip_frames])
    out_e, _ = _eager_frames(cuda_engine, clip_frames)
    np.testing.assert_array_equal(out, out_e)
    prog = state.program.program
    assert prog.replays == T_CLIP and prog.warmups == 1
    assert prog.captured == {"K3": 1, "K5": 1, "K6": 1}
    _golden_bars(out.ravel()[FRAME_SIZE:].astype(np.int16), reference_output)


@pytest.mark.cuda
def test_scan_graph_equals_eager_on_the_card(cuda_engine, testing_raw):
    """scan_chunk replays its step graph once a frame, with K5 and K6 in
    it, bit-equal to the eager frame_step_hoisted loop on the card."""
    b, t = 4, 12
    engine = nt.Engine(cuda_engine.model, "cuda", fused=False)
    frames = torch.as_tensor(testing_raw[: b * t * FRAME_SIZE].reshape(b, t, FRAME_SIZE), device="cuda")
    carry = nt.init_batch_carry(engine.model.meta, b, "cuda")
    _, out, vad = nt.scan_chunk(engine, carry, frames)
    out_e, vad_e, _ = _eager_scan(engine, carry, frames)
    assert torch.equal(out, out_e) and torch.equal(vad, vad_e)
    prog = engine.scan_program(b).program
    assert prog.replays == t and prog.captured == {"K5": 1, "K6": 1}


@pytest.mark.cuda
def test_frame_graph_of_a_nonstandard_model_on_the_card(cuda_engine, clip_frames):
    """A model K5 is not built for: its frame step (the plain RNN's
    products and the tansig table) is captured too, bit-equal to eager."""
    engine = nt.Engine(_custom_model(12), "cuda")
    state = nt.DenoiseState(engine)
    out = np.stack([state.process_frame(f)[0] for f in clip_frames[:20]])
    out_e, _ = _eager_frames(engine, clip_frames[:20])
    np.testing.assert_array_equal(out, out_e)
    assert state.program.program.captured == {"K3": 1, "K6": 1}


@pytest.mark.cuda
def test_failed_capture_raises_on_the_card(cuda_engine):
    """A step that reads the device from the host cannot be captured: the
    call raises, and so does the next one; nothing runs it eagerly."""
    x = torch.zeros(4, device="cuda")
    prog = StepProgram(lambda: x.add_(float(x.sum().item()) + 1.0), [x], "cuda")
    for _ in range(2):
        with pytest.raises(RuntimeError):
            prog()
        assert prog.graph is None and prog.replays == 0
    torch.cuda.synchronize()
