"""Counterpart of ``repro.graph`` (see the package docstring of ``repro_torch``)."""
