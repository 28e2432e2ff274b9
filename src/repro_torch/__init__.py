"""PyTorch/CUDA port of the SimDIT reproduction (the JAX package
``repro`` is the reference it is held against).

The port mirrors ``repro``'s layout module for module.  Its host cost
model (``core``) is numpy, its grid reductions run in torch on a CUDA
device (``core.gridtorch``), and its hot cycles reduction goes through a
hand-written CUDA kernel (``kernels.reduce``).  The kernel entry point
``kernels.ops`` runs the GEMM, fused add+RMSNorm, BN forward and flash
attention kernels; the model stack (``models``) and its serving loop
(``launch.serve``) run the attention LLMs on them.  Nothing here imports
jax or the ``repro`` package.
"""
