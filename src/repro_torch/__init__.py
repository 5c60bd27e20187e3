"""Flex-PE in PyTorch and CUDA: the port of the `repro` package to one
NVIDIA H100. Plain tensor code is PyTorch; the Pallas kernels of the
reference are hand-written CUDA kernels for Hopper under `csrc/`."""
