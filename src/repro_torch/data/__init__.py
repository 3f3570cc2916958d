"""Substrate package (port of the JAX package's `data`)."""
