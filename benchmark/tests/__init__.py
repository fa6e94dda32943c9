"""Tests of the benchmark (CPU; the `gpu`-marked ones need the card)."""
