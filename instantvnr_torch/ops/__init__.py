"""ops: see the package docstring of instantvnr_torch."""
