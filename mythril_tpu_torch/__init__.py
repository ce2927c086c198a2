"""mythril_tpu_torch: the PyTorch/CUDA port of mythril_tpu for NVIDIA Hopper.

It keeps the JAX package's module layout (`parallel/words.py` here mirrors
`mythril_tpu/parallel/words.py`) and its state layouts byte for byte, so the
two can be held against each other leaf by leaf. Every device program of the
JAX package's frontier is a CUDA C++ kernel written for `sm_90a` under
`kernels/`, and each has a plain PyTorch twin beside it (`*_reference`).

The package imports torch and numpy, never jax and nothing of mythril_tpu.
Entry points run on the card unless the caller passes `device="cpu"`.
"""
