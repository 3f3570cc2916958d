"""Parallelism substrate (mirror of ``repro.parallel``): the ambient
tensor-parallel context of the serving and training steps (``tp``:
Megatron's collectives, autograd-aware, and ZeRO-3's gathers over the
fsdp axes), the sharding hints of training on a mesh (``hints``: in the
port a check that every rank holds its own rows), and ``ranks`` (spawned
worlds for tests and ``chip_smoke.py``).

The JAX package's ``compat`` (jax version shims for meshes and
``shard_map``) has no counterpart: the port's collectives are
``torch.distributed``'s.
"""
