"""LeNet-style CIFAR-10 CNN, the paper's own workload (§5.2, Figure 4)
(port of ``repro.models.lenet``).

Two convolutions (each followed by an activation and 2x2 max pooling)
and three fully connected layers with activations between them, the
PyTorch CIFAR-10 tutorial's network as the paper adapted it. The
paper's figures run it through ``core.engine`` in every mode.

``to_layer_graphs`` emits the static/flexible IR: one ``LayerGraph``
whose static ops are the convolutions, the flatten and the products
(the paper's S1..S5 once FLEXIBLE_DMA segments it) and whose flexible
ops are the activations and the pools. NCHW activations, OIHW
convolution weights, (in, out) product weights: the JAX package's
layouts, so ``bridge.lenet_params_from_jax`` copies arrays as they are.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.modes import FlexibleOp, LayerGraph, StaticOp
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import dot

Tensor = torch.Tensor

# conv(3->6, k5) pool conv(6->16, k5) pool fc(400->120) fc(120->84)
# fc(84->10)
CONV1 = dict(cin=3, cout=6, k=5)
CONV2 = dict(cin=6, cout=16, k=5)
FC1 = (16 * 5 * 5, 120)
FC2 = (120, 84)
FC3 = (84, 10)
IMG = 32


def init(generator: torch.Generator, device=None,
         dtype: torch.dtype = torch.float32) -> dict:
    """Random weights at the JAX package's scales (unit normals over the
    square root of the fan-in), drawn from ``generator`` on its own
    device and placed on ``device`` (``cuda`` unless asked otherwise)."""
    dev = resolve_device(device)

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=dtype,
                        device=generator.device)
        return (w / math.sqrt(fan_in)).to(dev)

    def conv_w(c):
        return normal((c["cout"], c["cin"], c["k"], c["k"]),
                      c["cin"] * c["k"] * c["k"])

    return {
        "conv1": conv_w(CONV1),
        "conv2": conv_w(CONV2),
        "fc1": normal(FC1, FC1[0]),
        "fc2": normal(FC2, FC2[0]),
        "fc3": normal(FC3, FC3[0]),
    }


def _conv(w: Tensor, x: Tensor) -> Tensor:
    return F.conv2d(x, w)     # NCHW / OIHW, stride 1, VALID


def _pool(x: Tensor) -> Tensor:
    return F.max_pool2d(x, 2, 2)


def _flatten(w_unused: Tensor, x: Tensor) -> Tensor:
    return x.reshape(x.shape[0], -1)


def _fc(w: Tensor, x: Tensor) -> Tensor:
    return dot(x, w, x.dtype)


def forward(params: dict, x: Tensor, activation, *, pool=_pool) -> Tensor:
    """Plain forward (the oracle the engine's modes are held to)."""
    x = pool(activation(_conv(params["conv1"], x)))
    x = pool(activation(_conv(params["conv2"], x)))
    x = x.reshape(x.shape[0], -1)
    x = activation(_fc(params["fc1"], x))
    x = activation(_fc(params["fc2"], x))
    return _fc(params["fc3"], x)


def _conv_flops(c, hout: int, wout: int, batch: int) -> int:
    return 2 * batch * c["cout"] * c["cin"] * c["k"] * c["k"] * hout * wout


def to_layer_graphs(batch: int, activation: str = "relu",
                    itemsize: int = 4) -> list[LayerGraph]:
    """The paper's Figure-4 decomposition as engine IR (one task; the
    engine segments it per execution mode)."""
    h1 = IMG - CONV1["k"] + 1            # 28
    p1 = h1 // 2                          # 14
    h2 = p1 - CONV2["k"] + 1              # 10
    p2 = h2 // 2                          # 5

    ops = (
        StaticOp("conv1", _conv, (batch, CONV1["cout"], h1, h1),
                 flops=_conv_flops(CONV1, h1, h1, batch),
                 weight_bytes=CONV1["cout"] * CONV1["cin"] * 25 * itemsize),
        FlexibleOp(activation, (batch, CONV1["cout"], h1, h1)),
        FlexibleOp("max_pool", (batch, CONV1["cout"], p1, p1)),
        StaticOp("conv2", _conv, (batch, CONV2["cout"], h2, h2),
                 flops=_conv_flops(CONV2, h2, h2, batch),
                 weight_bytes=CONV2["cout"] * CONV2["cin"] * 25 * itemsize),
        FlexibleOp(activation, (batch, CONV2["cout"], h2, h2)),
        FlexibleOp("max_pool", (batch, CONV2["cout"], p2, p2)),
        StaticOp("flatten", _flatten, (batch, FC1[0]), flops=0,
                 weight_bytes=0),
        StaticOp("fc1", _fc, (batch, FC1[1]),
                 flops=2 * batch * FC1[0] * FC1[1],
                 weight_bytes=FC1[0] * FC1[1] * itemsize),
        FlexibleOp(activation, (batch, FC1[1])),
        StaticOp("fc2", _fc, (batch, FC2[1]),
                 flops=2 * batch * FC2[0] * FC2[1],
                 weight_bytes=FC2[0] * FC2[1] * itemsize),
        FlexibleOp(activation, (batch, FC2[1])),
        StaticOp("fc3", _fc, (batch, FC3[1]),
                 flops=2 * batch * FC3[0] * FC3[1],
                 weight_bytes=FC3[0] * FC3[1] * itemsize),
    )
    return [LayerGraph("lenet", ops, (batch, 3, IMG, IMG), itemsize)]


def engine_params(params: dict) -> dict:
    """Model params keyed by the LayerGraph's StaticOp names, on the
    params' device."""
    return {
        "conv1": params["conv1"],
        "conv2": params["conv2"],
        "flatten": torch.zeros((), device=params["conv1"].device),
        "fc1": params["fc1"],
        "fc2": params["fc2"],
        "fc3": params["fc3"],
    }


def register_pooling(table) -> None:
    """The pooling layers are flexible (host) ops in the paper's
    Figure 4."""
    if "max_pool" not in table:
        table.register("max_pool", _pool)
