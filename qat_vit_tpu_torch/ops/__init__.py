"""int8 serving ops: hand-written CUDA kernels (``csrc/``) behind wrappers
that take their plain PyTorch version on the CPU. Kernels build at first
launch; importing these modules touches neither CUDA nor a compiler."""
