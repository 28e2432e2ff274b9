"""The port's model stack: ``common`` (``ModelConfig``, parameter
declaration), ``layers``, ``attention`` and ``transformer.Model`` (the
serving path of the attention architectures, on the kernels of
``kernels.ops``), and ``frontends`` (input stubs and the cost-model
lowering of a configuration to a GEMM + SIMD layer graph,
``frontends.lower_llm``)."""
