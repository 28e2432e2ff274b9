"""The port's model front-ends: ``common.ModelConfig`` and the cost-model
lowering of a configuration to a GEMM + SIMD layer graph
(``frontends.lower_llm``)."""
