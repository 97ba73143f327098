"""Per-step random draws from explicit torch.Generators.

Port of benerf_tpu/core/rng.py. The JAX package folds the step into one
root key and splits a subkey per named consumer; here each (seed, step,
consumer) triple seeds its own torch.Generator on the step's device, through
numpy's SeedSequence so nearby seeds give unrelated streams. torch and JAX
streams differ, so parity tests inject draws instead of seeds.
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


def step_generators(seed: int, step: int, device) -> dict:
    """{consumer: torch.Generator on `device`} for one train step."""
    states = np.random.SeedSequence([seed, step]).generate_state(
        len(CONSUMERS), np.uint64)
    gens = {}
    for name, s in zip(CONSUMERS, states):
        g = torch.Generator(device=device)
        g.manual_seed(int(s) & 0x7FFF_FFFF_FFFF_FFFF)
        gens[name] = g
    return gens
