"""Counterpart of ``repro.core`` (see the package docstring of ``repro_torch``)."""
