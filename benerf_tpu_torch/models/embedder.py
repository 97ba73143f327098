"""Sinusoidal positional encoding (NeRF-style) + BARF coarse-to-fine weights.

Port of benerf_tpu/models/embedder.py. Output layout matches the reference
embedder: [x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...] with
fk = 2**k and the identity block present iff include_input. For the default
config: positions L=10 -> 63 channels, view dirs L=4 -> 27 channels.

BARF weights each frequency band k by (1 - cos(pi clamp(alpha - k, 0, 1)))/2,
the per-band weighting of the BARF paper (the JAX package documents why this
differs from the reference's reshape).
"""

from __future__ import annotations

import math

import torch


def positional_encoding(x, num_freqs: int, include_input: bool = True):
    """(..., D) -> (..., D*(2*num_freqs (+1))) sin/cos features."""
    parts = [x] if include_input else []
    for k in range(num_freqs):
        b = x * (2.0 ** k)
        parts.append(torch.sin(b))
        parts.append(torch.cos(b))
    return torch.cat(parts, dim=-1)


def barf_c2f_weights(step, max_iter, num_freqs, start, end, device=None,
                     dtype=torch.float32):
    """Per-frequency-band BARF weights in [0,1], shape (num_freqs,).

    step: an int, or a 0-d tensor on `device` (the train step's own counter,
    which a step captured in a CUDA graph advances on the card)."""
    step = torch.as_tensor(step, dtype=dtype, device=device)
    progress = step / max_iter
    alpha = (progress - start) / (end - start) * num_freqs
    k = torch.arange(num_freqs, dtype=dtype, device=step.device)
    return (1.0 - torch.cos(math.pi * torch.clamp(alpha - k, 0.0, 1.0))) / 2.0


def apply_barf_weights(encoded, weights, include_input: bool, input_dims: int = 3):
    """Scale the sin/cos blocks of `positional_encoding` output by per-band w.

    encoded: (..., C) with C = input_dims*(2L (+1)); weights: (L,).
    """
    num_freqs = weights.shape[0]
    offset = input_dims if include_input else 0
    head = encoded[..., :offset]
    bands = encoded[..., offset:]
    shaped = bands.reshape(bands.shape[:-1] + (num_freqs, 2 * input_dims))
    shaped = shaped * weights[:, None]
    return torch.cat([head, shaped.reshape(bands.shape)], dim=-1)
