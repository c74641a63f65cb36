"""Standing benchmark for the training-data generator.

The counterpart of ``nnnoiseless_tpu/tools/datagen_bench.py``: measures
``training.data.generate`` throughput (rows/s) with its host/device timing
split on a synthetic corpus, so that generator regressions show up as a
number instead of a slow training run.  The reference's generator is a
native binary dumping millions of rows (src/training.rs:120-161).

Usage:
    python -m nnnoiseless_tpu_torch.tools.datagen_bench [--rows N]
        [--workers W] [--chunk C] [--workdir DIR] [--device cuda|cpu]

The corpus (18 synthetic voices and 12 synthetic noises, 30 s each, from
examples/train_synthetic.py) is built once in --workdir and
reused across runs.  A warm-up at the same (workers, chunk) shape, which
builds the kernels, is left out of the timing.  Prints one JSON object.
"""

import argparse
import importlib.util
import json
import os
import tempfile
import time

import numpy as np


def _load_synth():
    """examples/train_synthetic.py is a script, not a package module."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    spec = importlib.util.spec_from_file_location(
        "train_synthetic", os.path.join(root, "examples", "train_synthetic.py")
    )
    ts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ts)
    return ts


def build_corpus(workdir: str):
    """WAVs of the synthetic corpus in ``workdir`` (kept if present): 18
    voices of 30 s, the first 6 ``synth_voice``, the rest
    ``synth_voice_varied``; 12 noises of 30 s, the first 5 white, pink,
    band, white, pink, the rest ``synth_noise_varied``.  Returns (voice
    paths, noise paths)."""
    ts = _load_synth()
    os.makedirs(workdir, exist_ok=True)
    rng = np.random.RandomState(0)
    sig_paths, noise_paths = [], []
    for i in range(18):
        p = os.path.join(workdir, f"voice{i}.wav")
        if not os.path.exists(p):
            ts.write_wav(p, ts.synth_voice(rng) if i < 6 else ts.synth_voice_varied(rng))
        sig_paths.append(p)
    kinds = ["white", "pink", "band", "white", "pink"]
    for i in range(12):
        p = os.path.join(workdir, f"noise{i}.wav")
        if not os.path.exists(p):
            ts.write_wav(p, ts.synth_noise(rng, kinds[i]) if i < 5 else ts.synth_noise_varied(rng))
        noise_paths.append(p)
    return sig_paths, noise_paths


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=120_000)
    ap.add_argument("--workers", type=int, default=96)
    ap.add_argument("--chunk", type=int, default=625)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "nnt_datagen_bench"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..denoise import check_device
    from ..training.data import generate

    device = check_device(args.device)
    sig, noise = build_corpus(args.workdir)

    generate(sig, noise, args.workers * args.chunk, seed=99, workers=args.workers,
             chunk=args.chunk, device=device)

    timing = {}
    t0 = time.perf_counter()
    data = generate(sig, noise, args.rows, seed=1, workers=args.workers,
                    chunk=args.chunk, timing=timing, device=device)
    wall = time.perf_counter() - t0
    if data.shape != (args.rows, 87) or not np.isfinite(data).all():
        raise RuntimeError(f"generate gave {data.shape} rows with non-finite values or of the wrong width")
    result = {
        "rows": args.rows, "workers": args.workers, "chunk": args.chunk,
        "voices": len(sig), "noises": len(noise),
        "wall_s": wall, "device_s": timing["device_s"], "host_s": timing["host_s"],
        "rows_per_s": args.rows / wall,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
