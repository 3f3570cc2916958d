"""Substrate package (port of the JAX package's `checkpoint`)."""
