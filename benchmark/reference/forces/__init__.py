"""The references of the non-pressure forces, one module each, found by a
configuration's ``forces[].reference`` name."""
