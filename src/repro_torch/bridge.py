"""Convert the JAX package's parameter and cache trees into the port's.

The JAX model stacks each kind of layer on a leading L axis for its
scan (``repro.models.layers.stack_specs``): ``params["blocks"]["dense"]
[name]`` has shape (L_dense, ...) and ``params["blocks"]["moe"][name]``
(L_moe, ...), dense layers first (``_layer_plan``); the cache is
``{"dense": {"k": (L, B, Hkv, T, Dh), ...}, "moe": {...}}`` (MLA leaves:
``c_kv`` (L, B, T, kvr), ``k_rope`` (L, B, T, rope)). The port keeps one
list of per-layer dicts in layer order. The input here is that tree with
every leaf already a numpy array (``jax.tree.map(np.asarray, tree)``) —
this module imports no JAX.

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


# the JAX package's stack names, in layer order
KINDS = ("dense", "moe")


def _depth(tree) -> int:
    """Leading (layer) extent of a stacked subtree."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree).shape[0]


def _unstack(stacks: dict, device) -> list:
    return [_layer(stacks[kind], i, device)
            for kind in KINDS if kind in stacks
            for i in range(_depth(stacks[kind]))]


def params_from_jax(params: dict, device="cpu") -> dict:
    """JAX transformer params (numpy leaves; dense and/or moe stacks) ->
    the port's."""
    unknown = set(params["blocks"]) - set(KINDS)
    if unknown:
        raise NotImplementedError(f"layer stacks {sorted(unknown)} are not "
                                  "ported")
    return {
        "embed": _tensor(params["embed"], device),
        "final_norm": _tensor(params["final_norm"], device),
        "layers": _unstack(params["blocks"], device),
    }


def cache_from_jax(cache: dict, device="cpu") -> list:
    """JAX slab cache (numpy leaves) -> per-layer dicts in layer order."""
    return _unstack(cache, device)


def cache_to_numpy(cache: list, kinds: list[str] | None = None) -> dict:
    """The port's per-layer cache -> the JAX layout as numpy, for
    comparisons (bf16 leaves as fp32). ``kinds`` names each layer's
    stack (``transformer.layer_kinds``); default: all dense."""
    def host(t):
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    kinds = kinds if kinds is not None else ["dense"] * len(cache)
    out = {}
    for kind in KINDS:
        layers = [layer for layer, k in zip(cache, kinds) if k == kind]
        if layers:
            out[kind] = {name: np.stack([host(layer[name])
                                         for layer in layers])
                         for name in layers[0]}
    return out
