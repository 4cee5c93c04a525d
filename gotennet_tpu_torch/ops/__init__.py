"""See the package docstring of gotennet_tpu_torch."""
