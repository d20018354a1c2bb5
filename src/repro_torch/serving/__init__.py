"""Counterpart of ``repro.serving`` (see the package docstring of ``repro_torch``)."""
