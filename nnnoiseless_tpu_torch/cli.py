"""Command-line denoiser, flag-compatible with the reference binary.

    python -m nnnoiseless_tpu_torch.cli INPUT OUTPUT [--wav-in] [--wav-out]
        [--sample-rate RATE] [--channels N] [--model PATH]
        [--engine {torch,native}] [--device DEVICE]

The flags of ``nnnoiseless_tpu/cli.py``, and its behavior (src/nnnoiseless.rs:
230-334): WAV files detected by extension (or forced by flags), raw input
is LE i16 at --sample-rate / --channels, non-48 kHz input is
sinc-resampled, output is always 48 kHz 16-bit, the first output frame is
discarded, and every channel gets its own denoiser state: the channels
form the batch axis of one engine call.  ``--engine torch`` (the default)
runs the batched engine on ``--device`` (default ``cuda``; without a CUDA
card that is an error, never a silent CPU run); ``--engine native`` the
C++ engine on the host.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

import torch

from . import RnnModel, denoise_audio
from .audio_io import read_raw, read_wav, resample_to_48k, write_raw, write_wav


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="nnnoiseless-tpu-torch", description="Remove noise from audio files"
    )
    ap.add_argument("INPUT", help="input audio file")
    ap.add_argument("OUTPUT", help="output audio file")
    ap.add_argument(
        "--wav-in",
        action="store_true",
        help="the input is a wav file (default: detect by filename)",
    )
    ap.add_argument(
        "--wav-out",
        action="store_true",
        help="the output is a wav file (default: detect by filename)",
    )
    ap.add_argument(
        "--sample-rate",
        type=float,
        default=48_000.0,
        help="for raw input, the sample rate of the input (default 48kHz)",
    )
    ap.add_argument(
        "--channels",
        type=int,
        default=1,
        help="for raw input, the number of channels (default 1)",
    )
    ap.add_argument("--model", help="path to a custom model file")
    ap.add_argument(
        "--engine",
        choices=["torch", "native"],
        default="torch",
        help="'torch' = the batched PyTorch engine on --device (default); "
        "'native' = the C++ host engine (no device; best for short single streams)",
    )
    ap.add_argument(
        "--device",
        default="cuda",
        help="torch device of the torch engine (default cuda; cpu runs the "
        "kernels' plain versions)",
    )
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.engine == "torch":
        try:
            device = torch.device(args.device)
        except RuntimeError as e:
            print(f"error: bad --device {args.device!r}: {e}", file=sys.stderr)
            return 1
        if device.type == "cuda" and not torch.cuda.is_available():
            print(f"error: --device {args.device}: no CUDA device is available "
                  "(use --device cpu or --engine native)", file=sys.stderr)
            return 1
    in_wav = args.wav_in or Path(args.INPUT).suffix == ".wav"
    out_wav = args.wav_out or Path(args.OUTPUT).suffix == ".wav"

    try:
        if in_wav:
            samples, rate = read_wav(args.INPUT)
        else:
            samples = read_raw(args.INPUT, args.channels)
            rate = args.sample_rate
    except Exception as e:
        print(f"error: failed to read {args.INPUT}: {e}", file=sys.stderr)
        return 1

    if rate != 48_000:
        samples = resample_to_48k(samples, int(rate))

    if args.engine == "native":
        try:
            from .native import NativeModel, denoise_audio_native, load_library

            load_library()
        except Exception as e:
            print(f"error: native engine unavailable: {e}", file=sys.stderr)
            return 1
        nmodel = None
        if args.model:
            try:
                with open(args.model, "rb") as f:
                    nmodel = NativeModel(f.read())
            except Exception as e:
                print(f"error: failed to load model {args.model}: {e}", file=sys.stderr)
                return 1
        out = np.stack(
            [
                denoise_audio_native(np.ascontiguousarray(samples[:, ch]), nmodel)
                for ch in range(samples.shape[1])
            ],
            axis=1,
        )
    else:
        if args.model:
            try:
                with open(args.model, "rb") as f:
                    model = RnnModel.from_bytes(f.read())
            except Exception as e:
                print(f"error: failed to load model {args.model}: {e}", file=sys.stderr)
                return 1
        else:
            model = RnnModel.default()
        # channels -> batch axis; drop the first frame like the reference.
        out = denoise_audio(samples.T, model, drop_first_frame=True, device=device)
        out = np.atleast_2d(out).T  # (n, channels)

    if out_wav:
        write_wav(args.OUTPUT, out)
    else:
        write_raw(args.OUTPUT, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
