"""Counterpart of ``repro.serving`` (see the package docstring of ``repro_torch``):
the GNN inference engine and the continuous-batching tier in front of it."""

from repro_torch.serving.batcher import BatchingSpec, Overloaded, ServingBatcher
from repro_torch.serving.gnn import GraphInferenceEngine, GraphServeResult

__all__ = ["BatchingSpec", "GraphInferenceEngine", "GraphServeResult",
           "Overloaded", "ServingBatcher"]
