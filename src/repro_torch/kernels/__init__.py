"""Hand-written Hopper kernels of the port, one for each of the six Pallas
kernels of the JAX package (``grid_minmax``, ``matmul``,
``fused_add_rmsnorm``, ``bn_forward``, ``bn_backward``,
``flash_attention``), each beside its plain PyTorch version; the entry
point ``ops``; the autograd functions ``matmul.MatmulFn`` and
``bn.BatchNormFn``; and the model drivers ``forward`` (Qwen3 prefill,
ResNet-50's forward kernel calls) and ``training`` (a ResNet training
step).  Kernels are built on first use on a CUDA device
(``_ext.load_library``); importing this package needs no compiler."""
