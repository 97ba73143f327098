"""Camera response function (CRF) tone-mapper MLPs.

Port of benerf_tpu/models/crf.py: an MLP 1 -> width -> ... -> 1 with ReLU
hidden activations and a final sigmoid; Xavier weights with zero biases for
the color mapper and ones for the luminance mapper (reference
model/component.py:38-149).
"""

from __future__ import annotations

import torch

from benerf_tpu_torch.models.nerf import xavier_uniform


def init_params(generator, hidden: int = 0, width: int = 128,
                bias_init: float = 0.0, device=None, dtype=torch.float32):
    """CRF MLP params: [1->width, (width->width)*hidden, width->1]."""
    sizes = [1, width] + [width] * hidden + [1]
    layers = [
        {"w": xavier_uniform(generator, (sizes[i], sizes[i + 1]), device, dtype),
         "b": torch.full((sizes[i + 1],), bias_init, device=device, dtype=dtype)}
        for i in range(len(sizes) - 1)
    ]
    return {"layers": layers}


def apply(params, x):
    """(..., 1) -> (..., 1) tone-mapped value in (0,1) (sigmoid output)."""
    h = x
    layers = params["layers"]
    for layer in layers[:-1]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    h = h @ layers[-1]["w"] + layers[-1]["b"]
    return torch.sigmoid(h)
