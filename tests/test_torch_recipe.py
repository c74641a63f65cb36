"""Every registered training topology through its recipe
(``training/recipe.py``, ``train.TOPOLOGIES``): ``fit`` asks the recipe for
the model, the optimizer, the sample weights and the params, and nothing
else, so one epoch of ``fit`` must equal, bit for bit, a hand loop of
``train_step_indexed`` built from the recipe alone.  On the CPU, at the
published widths, a few short sequences; the file does not import JAX.
"""

import numpy as np
import pytest
import torch

from nnnoiseless_tpu_torch.training import train as TT

# (features, gains) a frame of each registered topology's rows
ROW_WIDTHS = {"rnnoise-2018": (42, 22), "rnnoise-0.2": (65, 32)}
# the keys each recipe's optimizer adds to its saved param_groups, which a
# checkpoint written before the recipes existed carries
GROUP_KEYS = {"rnnoise-2018": {"base_lr", "cosine_steps"}, "rnnoise-0.2": {"base_lr", "cosine_steps", "lr_decay"}}
N_SEQ, T_SEQ, BATCH, SEED, LR, DECAY = 6, 12, 2, 7, 1e-3, 0.2


def _rows(name: str):
    n_feat, n_gain = ROW_WIDTHS[name]
    rng = np.random.RandomState(3)
    gains = rng.rand(N_SEQ, T_SEQ, n_gain)
    gains[:2] *= 0.3  # unequal tertiles of the mean gain
    gains[rng.rand(*gains.shape) < 0.1] = -1.0
    return tuple(a.astype(np.float32) for a in (
        rng.randn(N_SEQ, T_SEQ, n_feat), gains, rng.rand(N_SEQ, T_SEQ, 1) > 0.5))


def _leaves(tree, path=""):
    """(path, array) of nested numpy params, in key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k], f"{path}/{k}")]
    return [(path, tree)]


def test_every_topology_has_rows_and_keys_here():
    assert set(ROW_WIDTHS) == set(GROUP_KEYS) == set(TT.TOPOLOGIES)


@pytest.mark.parametrize("name", sorted(TT.TOPOLOGIES))
def test_fit_is_a_hand_loop_of_the_recipe(name):
    rows = _rows(name)
    history: list = []
    got = TT.fit(*rows, epochs=1, batch_size=BATCH, learning_rate=LR, lr_decay=DECAY, seed=SEED,
                 topology=name, log_every=100, history=history, device="cpu")

    recipe = TT.TOPOLOGIES[name]
    model = recipe.init(torch.Generator().manual_seed(SEED), recipe.meta)
    opt = recipe.optimizer(model, LR, None, DECAY)
    seq_w = recipe.sample_weights(rows[1], torch.device("cpu"))
    data = {k: torch.as_tensor(v) for k, v in zip(("features", "gains", "vad"), rows)}
    perm = torch.as_tensor(np.random.RandomState(SEED).permutation(N_SEQ))
    losses = [float(TT.train_step_indexed(model, opt, data, perm[i : i + BATCH], seq_w))
              for i in range(0, N_SEQ - BATCH + 1, BATCH)]

    assert history == list(enumerate(losses)) and len(set(losses)) == len(losses)
    want = _leaves(recipe.numpy_params(model))
    assert [p for p, _ in _leaves(got)] == [p for p, _ in want]
    for (path, a), (_, b) in zip(_leaves(got), want):
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("name", sorted(TT.TOPOLOGIES))
def test_saved_param_group_keys_are_the_checkpoint_formats(name, tmp_path):
    recipe = TT.TOPOLOGIES[name]
    model = recipe.init(torch.Generator().manual_seed(SEED), recipe.meta)
    opt = recipe.optimizer(model, LR, None, DECAY)
    rows = _rows(name)
    data = {k: torch.as_tensor(v) for k, v in zip(("features", "gains", "vad"), rows)}
    TT.train_step_indexed(model, opt, data, torch.arange(BATCH), recipe.sample_weights(rows[1], "cpu"))
    (group,) = opt.state_dict()["param_groups"]
    assert set(group) - set(opt.defaults) - {"params"} == GROUP_KEYS[name]
    assert group["cosine_steps"] is None and group["base_lr"] == LR
    assert group.get("lr_decay", DECAY) == DECAY

    path = TT.save_checkpoint(tmp_path, model, opt, 1)
    other = recipe.init(torch.Generator().manual_seed(SEED + 1), recipe.meta)
    other_opt = recipe.optimizer(other, LR, None, DECAY)
    assert TT.restore_checkpoint(path, other, other_opt) == 1 and TT.updates_taken(other_opt) == 1
    for p, q in zip(model.parameters(), other.parameters()):
        assert torch.equal(p, q)
    (restored,) = other_opt.state_dict()["param_groups"]
    assert torch.equal(restored.pop("lr"), group.pop("lr")) and restored == group
