"""The port's model stack: ``common`` (``ModelConfig``, parameter
declaration), ``layers``, ``attention``, the mixers ``moe``, ``ssm``
(Mamba2) and ``rglru``, and ``transformer.Model`` (serving and training
of all ten architectures, on the kernels of ``kernels.ops``), and
``frontends`` (input stubs and the cost-model lowering of a
configuration to a GEMM + SIMD layer graph, ``frontends.lower_llm``)."""
