"""The plain reference against the port at a tiny size on the CPU (the
reference itself imports nothing of the port)."""

import numpy as np
import torch

from perf_bench import traffic
from perf_bench.reference import train as ref_train
from perf_bench.reference.denoise import Reference
from perf_bench.tests.conftest import REPO

MODEL = REPO / "perf_bench" / "configs" / "rnnoise-xiph.rnn"
MIX = {"mute_share": 0.5, "mute_seconds": [0.05, 0.1]}


def test_denoiser_agrees_with_the_port():
    from nnnoiseless_tpu_torch.denoise import StreamBatch
    from nnnoiseless_tpu_torch.model import RnnModel

    frames = traffic.make_audio(2, 20 * 480, 5, "cpu", MIX).view(2, 20, 480)
    out, vad = Reference(MODEL, "cpu").run(frames)
    batch = StreamBatch(2, model=RnnModel.from_file(MODEL), device="cpu")
    got_out, got_vad = batch.process_tensor(frames[:, :10])
    more_out, more_vad = batch.process_tensor(frames[:, 10:])  # across chunks
    got_out, got_vad = torch.cat([got_out, more_out], 1), torch.cat([got_vad, more_vad], 1)
    rel = ((got_out - out) ** 2).sum() / (out**2).sum()
    assert rel < 1e-6 and (got_vad - vad).abs().max() < 1e-3
    assert (out.abs().amax(-1) > 0).all(dim=0).sum() > 10  # the frames carry signal


def test_train_steps_agree_with_the_port():
    from nnnoiseless_tpu_torch.training.network import DEFAULT_META, TrainableModel
    from nnnoiseless_tpu_torch.training.train import make_optimizer, train_step_indexed

    data = traffic.make_train_rows(4, 20, 3, "cpu", 0.05, 0.1)
    w = traffic.sample_weights(data["gains"])
    p0 = traffic.init_params(ref_train.leaf_shapes(), 4, "cpu")
    batches = [torch.tensor([0, 2]), torch.tensor([3, 1])]
    losses, grad, p_end = ref_train.train(p0, data, w, batches)
    model = TrainableModel(DEFAULT_META)
    model.load_state_dict(p0)
    opt = make_optimizer(model, 1e-3)
    got = [float(train_step_indexed(model, opt, data, idx, w)) for idx in batches]
    np.testing.assert_allclose(got, losses.numpy(), rtol=1e-5)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), p_end[n].numpy(), rtol=1e-4, atol=1e-6)
    assert all(float(g.abs().max()) > 0 for g in grad.values())
