"""Device layer of the port: plan IR, the program the CUDA kernels
interpret, the kernels' plain PyTorch versions and wrappers, and the engine
that stages segments and launches them.

Counterpart of pinot_tpu/ops (jit'd JAX programs); here the device work is
four hand-written CUDA kernels under csrc/.
"""
