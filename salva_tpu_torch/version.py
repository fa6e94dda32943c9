"""Version of the salva_tpu_torch package."""

__version__ = "0.1.0"
