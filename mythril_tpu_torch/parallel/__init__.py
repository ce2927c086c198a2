"""Port of mythril_tpu/parallel: the device frontier in PyTorch, with the
hand-written CUDA kernels of ../kernels on the card."""
