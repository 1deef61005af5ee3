"""PyTorch/CUDA port of the HALDA placement solver.

Beside the JAX package ``distilp_tpu`` (the reference), this package runs the
dense ``halda_solve`` main path on an NVIDIA GPU through hand-written kernels
(``distilp_torch/kernels``). It imports torch, numpy, scipy and pydantic, and
nothing of JAX or of the JAX package.
"""
