"""PyTorch/CUDA port of the Sidebar serving path, for NVIDIA Hopper.

The JAX package ``repro`` is the reference this package is held to; the
layout mirrors it module for module (``configs``, ``core``, ``kernels``,
``models``, ``launch``). Nothing here imports JAX or ``repro``.

Entry points (server classes, model ``init``, ``init_cache``) run on
``cuda`` unless the caller passes ``device="cpu"``. On a CPU tensor every
kernel wrapper takes its plain PyTorch version; on a CUDA tensor it
launches the hand-written kernel from ``csrc/`` (built with ``nvcc`` at
first use) or raises.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
