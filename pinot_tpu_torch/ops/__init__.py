"""Device layer of the port: plan IR, the program the CUDA kernels
interpret, the kernels' plain PyTorch versions and wrappers, the star-tree
leg, and the engine that stages segments and launches them.

Counterpart of pinot_tpu/ops (jit'd JAX programs); here the device work is
nine hand-written CUDA kernels under csrc/ (K1-K9), and the collective
merge of a mesh engine (collective.py).
"""
