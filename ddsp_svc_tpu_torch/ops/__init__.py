"""DSP functions on tensors and the hand-written CUDA kernels."""
