"""Counterpart of ``repro.configs`` (see the package docstring of ``repro_torch``)."""
from repro_torch.configs.base import (EmbeddingSpec, GNNConfig, LMConfig,
                                      get_config, list_archs, register)
from repro_torch.configs.reduced import reduced

__all__ = ["EmbeddingSpec", "GNNConfig", "LMConfig", "get_config",
           "list_archs", "register", "reduced"]
