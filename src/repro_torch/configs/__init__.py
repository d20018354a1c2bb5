"""Counterpart of ``repro.configs`` (see the package docstring of ``repro_torch``)."""
