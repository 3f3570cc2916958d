"""Parallelism substrate (mirror of ``repro.parallel``): the ambient
tensor-parallel context of the serving steps (``tp``).

The JAX package's ``compat`` (jax version shims for meshes and
``shard_map``) has no counterpart: the port's collectives are
``torch.distributed``'s. Its ``hints`` (GSPMD sharding hints) belong to
training on a mesh, which is not ported.
"""
