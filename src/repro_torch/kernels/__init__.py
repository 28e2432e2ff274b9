"""Hand-written Hopper kernels of the port, one per Pallas kernel of the
JAX package that the port's paths run, each beside its plain PyTorch
version.  Kernels are built on first use on a CUDA device
(``_ext.load_library``); importing this package needs no compiler."""
