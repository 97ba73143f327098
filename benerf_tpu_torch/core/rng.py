"""Per-step random draws from explicit torch.Generators.

Port of benerf_tpu/core/rng.py. The JAX package folds the step into one
root key and splits a subkey per named consumer; here each (seed, step,
consumer) triple seeds its own torch.Generator on the step's device, through
numpy's SeedSequence so nearby seeds give unrelated streams. torch and JAX
streams differ, so parity tests inject draws instead of seeds. A re-seeded
generator restarts its stream, so a persistent set re-seeded before each
step draws what a new set would.
"""

from __future__ import annotations

import numpy as np
import torch

CONSUMERS = (
    "window",      # event time-window placement
    "ray_evt",     # event-camera ray subset
    "ray_rgb",     # rgb-camera ray subset
    "z_evt",       # stratified coarse depths (event branch)
    "z_rgb",
    "pdf_evt",     # fine-sample uniforms
    "pdf_rgb",
    "noise_evt_c",  # sigma noise, event coarse
    "noise_evt_f",
    "noise_rgb_c",
    "noise_rgb_f",
)


def generators(entropy, names, device, out=None) -> dict:
    """{name: torch.Generator on `device`}, seeded from the ints `entropy`
    through numpy's SeedSequence, one stream per name. out: such a dict to
    re-seed in place instead of making new generators."""
    states = np.random.SeedSequence(list(entropy)).generate_state(
        len(names), np.uint64)
    gens = {} if out is None else out
    for name, s in zip(names, states):
        if out is None:
            gens[name] = torch.Generator(device=device)
        gens[name].manual_seed(int(s) & 0x7FFF_FFFF_FFFF_FFFF)
    return gens


def step_generators(seed: int, step: int, device, out=None) -> dict:
    """{consumer: torch.Generator on `device`} for one train step; with
    `out` (an earlier call's dict) its generators are re-seeded in place,
    so a CUDA graph that registered them draws this step's streams."""
    return generators((seed, step), CONSUMERS, device, out)
