"""Correlation parity checker between two raw i16 audio files.

Equivalent of the reference's examples/corr.rs: computes the normalized
cross-correlation of two little-endian i16 files and exits nonzero when
|corr - 1| > 1e-6 (corr.rs:38-47).  Used to compare this framework's CLI
output against the reference implementation's.

A copy of ``nnnoiseless_tpu/tools/corr.py`` (numpy only).

Usage::

    python -m nnnoiseless_tpu_torch.tools.corr a.raw b.raw [--threshold 1e-6]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def correlation(a: np.ndarray, b: np.ndarray) -> float:
    """Normalized correlation of two equal-length signals (f64 accumulate)."""
    n = min(len(a), len(b))
    a = a[:n].astype(np.float64)
    b = b[:n].astype(np.float64)
    denom = np.sqrt(np.sum(a * a) * np.sum(b * b))
    if denom == 0.0:
        return 1.0 if not (a.any() or b.any()) else 0.0
    return float(np.sum(a * b) / denom)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="correlation between two raw 16-bit LE audio files"
    )
    ap.add_argument("FILE_A")
    ap.add_argument("FILE_B")
    ap.add_argument(
        "--threshold",
        type=float,
        default=1e-6,
        help="fail if |correlation - 1| exceeds this (default 1e-6)",
    )
    args = ap.parse_args(argv)
    a = np.fromfile(args.FILE_A, dtype="<i2")
    b = np.fromfile(args.FILE_B, dtype="<i2")
    if len(a) != len(b):
        print(
            f"warning: lengths differ ({len(a)} vs {len(b)}); comparing prefix",
            file=sys.stderr,
        )
    c = correlation(a, b)
    print(f"correlation: {c}")
    return 0 if abs(c - 1.0) <= args.threshold else 1


if __name__ == "__main__":
    sys.exit(main())
