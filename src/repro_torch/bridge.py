"""Convert the JAX package's parameter and cache trees into the port's.

The JAX model stacks its layers on a leading L axis for its scan
(``repro.models.layers.stack_specs``): ``params["blocks"]["dense"][name]``
has shape (L, ...), and the cache is ``{"dense": {"k": (L, B, Hkv, T,
Dh), ...}}``. The port keeps a list of per-layer dicts. The input here
is that tree with every leaf already a numpy array
(``jax.tree.map(np.asarray, tree)``) — this module imports no JAX.

Used by the tests, so both frameworks compute on the same weights: the
port cannot redraw ``jax.random``'s numbers.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no torch view
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _layer(tree, i: int, device):
    if isinstance(tree, dict):
        return {k: _layer(v, i, device) for k, v in tree.items()}
    return _tensor(np.asarray(tree)[i], device)


def params_from_jax(params: dict, device="cpu") -> dict:
    """JAX dense-transformer params (numpy leaves) -> the port's."""
    stack = params["blocks"]["dense"]
    n = np.asarray(stack["attn_norm"]).shape[0]
    return {
        "embed": _tensor(params["embed"], device),
        "final_norm": _tensor(params["final_norm"], device),
        "layers": [_layer(stack, i, device) for i in range(n)],
    }


def cache_from_jax(cache: dict, device="cpu") -> list:
    """JAX slab cache (numpy leaves) -> per-layer dicts."""
    stack = cache["dense"]
    n = np.asarray(stack["k"]).shape[0]
    return [_layer(stack, i, device) for i in range(n)]


def cache_to_numpy(cache: list) -> dict:
    """The port's per-layer cache -> the JAX layout as numpy, for
    comparisons (bf16 leaves as fp32)."""
    def host(t):
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    return {"dense": {k: np.stack([host(layer[k]) for layer in cache])
                      for k in cache[0]}}
