"""Engine switches, read once when the package is imported.

* ``NNT_FUSED=0`` — serve every model with the scan engine
  (``denoise.scan_chunk``: the lag-0 precompute, then one step a frame of
  ``pipeline.frame_step_hoisted``, a replay of its captured CUDA graph on a
  card) instead of the two-phase engine
  (precompute, then kernel K2).  As ``nnnoiseless_tpu/flags.py`` reads it;
  set the variable before the process imports the package.
"""

from __future__ import annotations

import os

FUSED: bool = os.environ.get("NNT_FUSED", "1") != "0"
