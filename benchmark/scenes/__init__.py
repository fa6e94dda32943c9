"""Scene builders, one per configuration kind, found by the configuration
file's ``scene`` name."""
