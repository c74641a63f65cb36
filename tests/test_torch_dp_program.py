"""The data-parallel train step as a program (nnnoiseless_tpu_torch/
programs.py ``TrainProgram`` over ``training.train.train_step_dp``) on the
CPU, in gloo processes spawned by ``parallel.dryrun.run_ranks``.

``fit(mesh=...)`` runs each step as one call of its ``TrainProgram``; on
the CPU that call is the eager ``train_step_dp`` on the program's static
tensors, so parameters, Adam's state and the history must equal a hand
loop of eager ``train_step_dp`` steps bit for bit.  The bars against the
JAX package's mesh ``fit`` are tests/test_torch_parallel.py's.  The rank
functions live in this module, which imports neither JAX nor the JAX
package, so that a spawned rank never loads them.  The graphs on a card,
over a 1-rank NCCL group, are tests/test_torch_train_program.py's ``cuda``
cases.
"""

import numpy as np
import pytest
import torch

from nnnoiseless_tpu_torch import programs
from nnnoiseless_tpu_torch.constants import NB_BANDS, NB_FEATURES
from nnnoiseless_tpu_torch.parallel import dryrun
from nnnoiseless_tpu_torch.training import network as TN
from nnnoiseless_tpu_torch.training import train as TT

RANK_TIMEOUT = 120.0  # s, as tests/test_torch_parallel.py's spawn tests
N_SEQ, T_SEQ, BATCH, EPOCHS = 16, 24, 8, 2  # 2 steps an epoch, 4 in all
SEED = 3
STEPS = 3  # direct program steps


def _train_data():
    """N_SEQ sequences whose mean gains fall in unequal tertiles, so the
    ranks' sample-weight sums differ."""
    rng = np.random.RandomState(6)
    level = np.array([0.85] * 3 + [0.5] * 4 + [0.15] * 9)[rng.permutation(N_SEQ)]
    gains = np.clip(level[:, None, None] + rng.uniform(-0.1, 0.1, (N_SEQ, T_SEQ, NB_BANDS)), 0, 1)
    gains[rng.rand(*gains.shape) < 0.1] = -1.0
    feats = rng.randn(N_SEQ, T_SEQ, NB_FEATURES)
    vad = (rng.rand(N_SEQ, T_SEQ, 1) > 0.5) * 1.0
    return tuple(a.astype(np.float32) for a in (feats, gains, vad))


def _state(model, opt) -> list:
    """Copies of the parameters and of Adam's state, in parameter order."""
    out = [p.detach().clone() for p in model.parameters()]
    for p in model.parameters():
        out += [opt.state[p][k].clone() for k in ("step", "exp_avg", "exp_avg_sq")]
    return out


def _fit_counted_worker(mesh, arrays, schedule):
    """fit over the mesh with TrainProgram calls and train_step_dp calls
    counted (and whether each step ran inside a program call), then a hand
    loop of eager train_step_dp steps from fit's seed and permutations."""
    calls = {"program": 0, "step": 0, "step_in_program": 0}
    inside = [False]
    real_call, real_step = programs.TrainProgram.__call__, TT.train_step_dp

    def counted_call(self, idx):
        calls["program"] += 1
        inside[0] = True
        try:
            return real_call(self, idx)
        finally:
            inside[0] = False

    def counted_step(*args):
        calls["step"] += 1
        calls["step_in_program"] += inside[0]
        return real_step(*args)

    programs.TrainProgram.__call__, TT.train_step_dp = counted_call, counted_step
    try:
        history: list = []
        params = TT.fit(*arrays, epochs=EPOCHS, batch_size=BATCH, seed=SEED, log_every=100, history=history,
                        lr_schedule=schedule, device="cpu", mesh=mesh)
    finally:
        programs.TrainProgram.__call__, TT.train_step_dp = real_call, real_step

    feats, gains, vad = arrays
    model = TN.init_train_params(torch.Generator().manual_seed(SEED))
    opt = TT.make_optimizer(model, 1e-3, None if schedule is None else EPOCHS * (N_SEQ // BATCH))
    data = {k: torch.as_tensor(v) for k, v in (("features", feats), ("gains", gains), ("vad", vad))}
    seq_w = torch.as_tensor(TN.compute_sample_weights(gains))
    rng, losses = np.random.RandomState(SEED), []
    for _ in range(EPOCHS):
        perm = rng.permutation(N_SEQ)
        for i in range(0, N_SEQ - BATCH + 1, BATCH):
            idx = torch.as_tensor(perm[i : i + BATCH])
            losses.append(float(TT.train_step_dp(model, opt, data, idx, seq_w, mesh)))
    return calls, params, history, TN.numpy_params(model), losses


def _program_worker(mesh, arrays):
    """STEPS steps of a TrainProgram over train_step_dp and STEPS eager
    train_step_dp steps, each from the same seeded parameters and zero Adam
    state, on the same index vectors (with repeats): (equal losses, equal
    parameters and Adam state, program untouched by a capture, Adam's
    update count)."""
    feats, gains, vad = arrays
    data = {k: torch.as_tensor(v) for k, v in (("features", feats), ("gains", gains), ("vad", vad))}
    seq_w = torch.as_tensor(TN.compute_sample_weights(gains))
    rng = np.random.RandomState(SEED + 1)
    idxs = [torch.as_tensor(rng.randint(0, N_SEQ, BATCH)) for _ in range(STEPS)]
    runs = []
    for graphed in (True, False):
        model = TN.init_train_params(torch.Generator().manual_seed(SEED))
        opt = TT.make_optimizer(model, 1e-3, 2 * STEPS)
        step = lambda idx: TT.train_step_dp(model, opt, data, idx, seq_w, mesh)
        prog = programs.TrainProgram(step, model, opt, BATCH) if graphed else None
        losses = torch.stack([(prog(idx) if graphed else step(idx)).clone() for idx in idxs])
        runs.append((losses, _state(model, opt), prog, TT.updates_taken(opt)))
    (l_p, s_p, prog, n_p), (l_e, s_e, _, n_e) = runs
    untouched = prog.program.graph is None and prog.program.replays == 0 and prog.program.warmups == 0
    return (torch.equal(l_p, l_e), all(torch.equal(a, b) for a, b in zip(s_p, s_e)), untouched, n_p, n_e,
            len(set(l_p.tolist())))


@pytest.mark.parametrize("schedule", [None, "cosine"])
def test_fit_dp_runs_one_program_call_a_step(schedule):
    """fit over 2 gloo ranks, 2 epochs of 2 steps: exactly one TrainProgram
    call a step, each step's train_step_dp inside it, and parameters and
    history bit-equal to a hand loop of eager train_step_dp steps from the
    same seed and permutations, on both ranks."""
    ranks = dryrun.run_ranks(2, _fit_counted_worker, _train_data(), schedule, timeout=RANK_TIMEOUT)
    steps = EPOCHS * (N_SEQ // BATCH)
    for calls, params, history, hand, hand_losses in ranks:
        assert calls == {"program": steps, "step": steps, "step_in_program": steps}
        assert [s for s, _ in history] == list(range(steps))
        assert [l for _, l in history] == hand_losses
        assert len(set(hand_losses)) == steps
        for layer, leaves in hand.items():
            for name, w in leaves.items():
                np.testing.assert_array_equal(params[layer][name], w, err_msg=f"{layer}.{name}")
    (p0, h0), (p1, h1) = ((r[1], r[2]) for r in ranks)
    assert h0 == h1
    for layer, leaves in p0.items():
        for name, a in leaves.items():
            np.testing.assert_array_equal(a, p1[layer][name])


def test_dp_program_on_the_cpu_is_the_eager_step():
    """On the CPU a TrainProgram over train_step_dp is the eager step on
    its static tensors (2 gloo ranks, cosine over 6 steps): losses,
    parameters and Adam's state bit for bit, nothing warmed up or
    captured, and Adam counts STEPS updates."""
    for same_loss, same_state, untouched, n_p, n_e, distinct in dryrun.run_ranks(
            2, _program_worker, _train_data(), timeout=RANK_TIMEOUT):
        assert same_loss and same_state and untouched
        assert n_p == n_e == STEPS and distinct == STEPS
