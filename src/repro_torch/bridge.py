"""Convert the JAX package's parameter and cache trees into the port's.

The JAX model stacks each kind of layer on a leading L axis for its
scan (``repro.models.layers.stack_specs``): ``params["blocks"]["dense"]
[name]`` has shape (L_dense, ...) and ``params["blocks"]["moe"][name]``
(L_moe, ...), dense layers first (``_layer_plan``); the cache is
``{"dense": {"k": (L, B, Hkv, T, Dh), ...}, "moe": {...}}`` (MLA leaves:
``c_kv`` (L, B, T, kvr), ``k_rope`` (L, B, T, rope)). The VLM nests its
groups as ``blocks["vlm_group"]`` = {"self": (G, n_self, ...) stacks,
"cross": (G, ...) stacks}, and its cache alike. The port keeps one list
of per-layer dicts in layer order (a group's self layers, then its cross
layer). The input here is that tree with every leaf already a numpy
array (``jax.tree.map(np.asarray, tree)``) — this module imports no JAX.

Whisper stacks its ``encoder`` and ``decoder`` layers on a leading L
axis beside ``embed``, ``enc_norm`` and ``dec_norm``; the port keeps two
lists (``models.whisper``), and its decoder cache is the dense one.

The recurrent families: RWKV6 stacks its layers under ``blocks`` and
its state ``{"wkv", "shift_tm", "shift_cm"}`` on a leading L axis; the
Mamba2 hybrid nests its layers as ``groups`` [n_groups][attn_every] and
``tail``, their pre-norms as ``mamba_norm["w"]`` (L, D), keeps one
``shared`` block, and its state as ``{"ssm": {"h", "conv"} (L, ...),
"kv": {"k", "v"} (n_groups, ...)}``. The port keeps per-layer lists
(``models.rwkv_model``, ``models.zamba``); each direction is here.

Used by the tests, so both frameworks compute on the same weights: the
port cannot redraw ``jax.random``'s numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


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
# the VLM's nested stack: [G] groups of n_self dense layers + one cross
VLM_GROUP = "vlm_group"


def _depth(tree) -> int:
    """Leading (layer) extent of a stacked subtree."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree).shape[0]


def _unstack(stacks: dict, device) -> list:
    layers = [_layer(stacks[kind], i, device)
              for kind in KINDS if kind in stacks
              for i in range(_depth(stacks[kind]))]
    group = stacks.get(VLM_GROUP)
    if group is not None:
        for g in range(_depth(group["cross"])):
            own = _map(group["self"], lambda a: np.asarray(a)[g])
            layers += [_layer(own, j, device) for j in range(_depth(own))]
            layers.append(_layer(group["cross"], g, device))
    return layers


def params_from_jax(params: dict, device=None) -> dict:
    """JAX transformer params (numpy leaves; dense and/or moe stacks, or
    the VLM's groups) -> the port's, on ``device`` (``cuda`` unless the
    caller asks for another, as every entry point of the port)."""
    device = resolve_device(device)
    unknown = set(params["blocks"]) - set(KINDS) - {VLM_GROUP}
    if unknown:
        raise NotImplementedError(f"layer stacks {sorted(unknown)} are not "
                                  "ported")
    return {
        "embed": _tensor(params["embed"], device),
        "final_norm": _tensor(params["final_norm"], device),
        "layers": _unstack(params["blocks"], device),
    }


def cache_from_jax(cache: dict, device=None) -> list:
    """JAX slab cache (numpy leaves) -> per-layer dicts in layer order,
    on ``device`` (``cuda`` unless asked otherwise)."""
    return _unstack(cache, resolve_device(device))


def _host(t) -> np.ndarray:
    """A port tensor (bf16 as fp32) or a numpy array, as numpy."""
    if isinstance(t, np.ndarray):
        return t
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def cache_to_numpy(cache: list, kinds: list[str] | None = None) -> dict:
    """The port's per-layer cache -> the JAX layout as numpy, for
    comparisons (bf16 leaves as fp32). ``kinds`` names each layer's
    kind (``transformer.layer_kinds``: "cross" ends a VLM group);
    default: all dense."""
    kinds = kinds if kinds is not None else ["dense"] * len(cache)
    if "cross" in kinds:
        per = kinds.index("cross") + 1
        groups = [cache[g:g + per] for g in range(0, len(cache), per)]
        return {VLM_GROUP: {
            "self": _stack([_stack(grp[:-1]) for grp in groups]),
            "cross": _stack([grp[-1] for grp in groups])}}
    out = {}
    for kind in KINDS:
        layers = [layer for layer, k in zip(cache, kinds) if k == kind]
        if layers:
            out[kind] = {name: np.stack([_host(layer[name])
                                         for layer in layers])
                         for name in layers[0]}
    return out


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _stack(layers: list) -> dict:
    """Per-layer dicts -> one dict of (L, ...) numpy stacks."""
    return {name: (_stack([layer[name] for layer in layers])
                   if isinstance(layers[0][name], dict)
                   else np.stack([_host(layer[name]) for layer in layers]))
            for name in layers[0]}


def rwkv_params_from_jax(params: dict, device=None) -> dict:
    """JAX RWKV6 params (numpy leaves) -> the port's (``layers`` a list),
    on ``device`` (``cuda`` unless asked otherwise)."""
    device = resolve_device(device)
    blocks = params["blocks"]
    return {"embed": _tensor(params["embed"], device),
            "final_norm": _tensor(params["final_norm"], device),
            "layers": [_layer(blocks, i, device)
                       for i in range(_depth(blocks))]}


def rwkv_params_to_numpy(params: dict) -> dict:
    """The port's RWKV6 params -> the JAX layout as numpy."""
    return {"embed": _host(params["embed"]),
            "final_norm": _host(params["final_norm"]),
            "blocks": _stack(params["layers"])}


def zamba_params_from_jax(params: dict, device=None) -> dict:
    """JAX Mamba2-hybrid params (numpy leaves) -> the port's: the nested
    ``groups`` and the ``tail`` unstacked into one list in layer order,
    each layer with its ``mamba_norm``; the one ``shared`` block as it
    is. On ``device`` (``cuda`` unless asked otherwise)."""
    device = resolve_device(device)
    groups = [_map(params["groups"], lambda a: np.asarray(a)[g])
              for g in range(_depth(params["groups"]))]
    layers = [_layer(group, j, device)
              for group in groups for j in range(_depth(group))]
    if "tail" in params:
        layers += [_layer(params["tail"], i, device)
                   for i in range(_depth(params["tail"]))]
    norms = np.asarray(params["mamba_norm"]["w"])
    for i, layer in enumerate(layers):
        layer["mamba_norm"] = _tensor(norms[i], device)
    return {"embed": _tensor(params["embed"], device),
            "final_norm": _tensor(params["final_norm"], device),
            "layers": layers,
            "shared": _map(params["shared"], lambda a: _tensor(a, device))}


def zamba_params_to_numpy(params: dict, attn_every: int) -> dict:
    """The port's Mamba2-hybrid params -> the JAX layout as numpy
    (``groups`` [n_groups][attn_every], ``tail`` when the depth leaves
    one)."""
    layers = [{k: v for k, v in layer.items() if k != "mamba_norm"}
              for layer in params["layers"]]
    n_groups = len(layers) // attn_every
    out = {"embed": _host(params["embed"]),
           "final_norm": _host(params["final_norm"]),
           "mamba_norm": {"w": np.stack([_host(layer["mamba_norm"])
                                         for layer in params["layers"]])},
           "groups": _stack([_stack(layers[g * attn_every:
                                           (g + 1) * attn_every])
                             for g in range(n_groups)]),
           "shared": _map(params["shared"], _host)}
    if len(layers) > n_groups * attn_every:
        out["tail"] = _stack(layers[n_groups * attn_every:])
    return out


def state_from_jax(state: dict, device=None):
    """A recurrent family's JAX state (numpy leaves) -> the port's: each
    dict of (L, ...) stacks becomes a list of per-layer dicts (RWKV6's
    whole state; the hybrid's ``ssm`` and ``kv``). On ``device``
    (``cuda`` unless asked otherwise)."""
    device = resolve_device(device)
    if all(isinstance(v, dict) for v in state.values()):
        return {k: state_from_jax(v, device) for k, v in state.items()}
    return [_layer(state, i, device) for i in range(_depth(state))]


def state_to_numpy(state):
    """The port's recurrent state -> the JAX layout as numpy (bf16
    leaves as fp32)."""
    if isinstance(state, dict):
        return {k: state_to_numpy(v) for k, v in state.items()}
    return _stack(state)


def whisper_params_from_jax(params: dict, device=None) -> dict:
    """JAX whisper params (numpy leaves) -> the port's: the ``encoder``
    and ``decoder`` stacks unstacked into lists in layer order. On
    ``device`` (``cuda`` unless asked otherwise)."""
    device = resolve_device(device)
    out = {name: _tensor(params[name], device)
           for name in ("embed", "enc_norm", "dec_norm")}
    for stack in ("encoder", "decoder"):
        out[stack] = [_layer(params[stack], i, device)
                      for i in range(_depth(params[stack]))]
    return out


def whisper_params_to_numpy(params: dict) -> dict:
    """The port's whisper params -> the JAX layout as numpy (bf16 leaves
    as fp32)."""
    out = {name: _host(params[name])
           for name in ("embed", "enc_norm", "dec_norm")}
    for stack in ("encoder", "decoder"):
        out[stack] = _stack(params[stack])
    return out


def lenet_params_from_jax(params: dict, device=None) -> dict:
    """JAX LeNet params (numpy leaves: OIHW convolutions, (in, out)
    products) -> the port's ``models.lenet`` params, on ``device``
    (``cuda`` unless asked otherwise). The layouts are the same, so each
    array is copied as it is."""
    device = resolve_device(device)
    return {name: _tensor(a, device) for name, a in params.items()}
