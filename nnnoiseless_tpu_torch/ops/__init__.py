"""DSP/NN ops of the port: plain PyTorch functions, and the wrappers of the
two CUDA kernels (pitch_kernel.py: K1, frame_kernel.py: K2)."""
