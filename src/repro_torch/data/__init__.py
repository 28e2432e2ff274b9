"""The token pipeline of the port's trainer: an own copy of the JAX
package's ``data/pipeline.py``."""
from .pipeline import PipelineState, TokenPipeline

__all__ = ["PipelineState", "TokenPipeline"]
