"""The random draws of a train step and of a rendered chunk, worked out
again from the seed.

Each (entropy..., consumer) stream is a torch.Generator on the device,
seeded through numpy's SeedSequence over the entropy ints, one state per
consumer in the listed order: the port's documented per-step streams.
Every draw is made in float32 and widened to float64 afterwards, since the
stream of a draw depends on its dtype.
"""

from __future__ import annotations

import numpy as np
import torch

STEP_CONSUMERS = ("window", "ray_evt", "ray_rgb", "z_evt", "z_rgb",
                  "pdf_evt", "pdf_rgb", "noise_evt_c", "noise_evt_f",
                  "noise_rgb_c", "noise_rgb_f")
CHUNK_CONSUMERS = ("z", "pdf", "noise_c", "noise_f")


def generators(entropy, names, device) -> dict:
    states = np.random.SeedSequence([int(e) for e in entropy]).generate_state(
        len(names), np.uint64)
    gens = {}
    for name, s in zip(names, states):
        g = torch.Generator(device=device)
        g.manual_seed(int(s) & 0x7FFF_FFFF_FFFF_FFFF)
        gens[name] = g
    return gens


def uniform(g, shape):
    return torch.rand(shape, generator=g, device=g.device,
                      dtype=torch.float32).double()


def normal(g, shape):
    return torch.randn(shape, generator=g, device=g.device,
                       dtype=torch.float32).double()


def sorted_uniform(g, shape, n):
    """n ascending order statistics of uniforms per row: normalized
    partial sums of n + 1 exponentials."""
    e = -torch.log1p(-uniform(g, tuple(shape) + (n + 1,)))
    c = torch.cumsum(e, dim=-1)
    return c[..., :-1] / c[..., -1:]


def subset(g, n, k, top_k: bool):
    """k distinct indices of n: the head of a uniform permutation, or the
    k largest of n uniforms."""
    if top_k:
        return torch.topk(torch.rand(n, generator=g, device=g.device), k).indices
    return torch.randperm(n, generator=g, device=g.device)[:k]
