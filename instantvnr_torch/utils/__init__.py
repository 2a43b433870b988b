"""utils: see the package docstring of instantvnr_torch."""
