"""Counterpart of ``repro.models`` (see the package docstring of ``repro_torch``)."""
