"""PyTorch/CUDA port of the SimDIT reproduction (the JAX package
``repro`` is the reference it is held against).

The port mirrors ``repro``'s layout module for module.  Its host cost
model (``core``) is numpy, its grid reductions run in torch on a CUDA
device (``core.gridtorch``), and its hot cycles reduction goes through a
hand-written CUDA kernel (``kernels.reduce``).  Nothing here imports jax
or the ``repro`` package.
"""
