"""Ops of the PyTorch port: plain tensor functions and the Hopper kernels."""
