"""Measurement scripts for the CUDA kernels; each needs the card and nvcc."""
