"""Counterpart of ``repro.serving`` (see the package docstring of ``repro_torch``):
the LM decode engine, the GNN inference engine and the continuous-batching
tier in front of it."""

from repro_torch.serving.batcher import BatchingSpec, Overloaded, ServingBatcher
from repro_torch.serving.engine import DecodeEngine, Engine, GenerationResult
from repro_torch.serving.gnn import GraphInferenceEngine, GraphServeResult

__all__ = ["BatchingSpec", "DecodeEngine", "Engine", "GenerationResult",
           "GraphInferenceEngine", "GraphServeResult", "Overloaded", "ServingBatcher"]
