"""Global DSP geometry constants for the 48 kHz noise-suppression pipeline.

These mirror the frame/window/pitch/band geometry of the RNNoise lineage
(reference: nnnoiseless src/lib.rs:36-58).  A copy of
``nnnoiseless_tpu/constants.py``: importing that package would load JAX,
which this package never does.
"""

FRAME_SIZE_SHIFT = 2
FRAME_SIZE = 120 << FRAME_SIZE_SHIFT  # 480 samples = 10 ms @ 48 kHz
WINDOW_SIZE = 2 * FRAME_SIZE          # 960, 50% overlap analysis window
FREQ_SIZE = FRAME_SIZE + 1            # 481 rfft bins of a 960-pt real FFT

PITCH_MIN_PERIOD = 60
PITCH_MAX_PERIOD = 768
PITCH_FRAME_SIZE = 960
PITCH_BUF_SIZE = PITCH_MAX_PERIOD + PITCH_FRAME_SIZE  # 1728

NB_BANDS = 22
CEPS_MEM = 8
NB_DELTA_CEPS = 6
NB_FEATURES = NB_BANDS + 3 * NB_DELTA_CEPS + 2  # 42

# Bark-ish band edges in units of 5 ms-frame bins; scale by 4 (FRAME_SIZE_SHIFT)
# to get 960-pt FFT bin indices (reference: lib.rs EBAND_5MS).
EBAND_5MS = (
    0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 34, 40, 48, 60, 78, 100,
)

# Downsampled-domain pitch geometry (all /2 because the pitch analysis runs on
# a 2x-decimated buffer).
PITCH_BUF_DS = PITCH_BUF_SIZE // 2            # 864
PITCH_FRAME_DS = PITCH_FRAME_SIZE // 2        # 480
PITCH_MAX_DS = PITCH_MAX_PERIOD // 2          # 384
PITCH_MIN_DS = PITCH_MIN_PERIOD // 2          # 30
MAX_PITCH = PITCH_MAX_PERIOD - 3 * PITCH_MIN_PERIOD  # 588: coarse search span

# RNN geometry of the built-in model (custom models may differ; these are the
# defaults used for shape assertions and docs).
INPUT_DENSE_SIZE = 24
VAD_GRU_SIZE = 24
NOISE_GRU_SIZE = 48
DENOISE_GRU_SIZE = 96

WEIGHTS_SCALE = 1.0 / 256.0  # int8 weight dequantization scale
