"""PyTorch/CUDA port of convasr_tpu: the same modules and names, run on an
NVIDIA Hopper card, with the TPU's Pallas kernels rewritten as hand-written
CUDA kernels (csrc/). The JAX package stays the reference it is tested against.
"""
