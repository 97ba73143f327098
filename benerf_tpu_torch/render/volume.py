"""Volume rendering: raw MLP outputs -> composited rgb/depth/acc maps.

Port of benerf_tpu/render/volume.py (reference NeRF.raw2output):
  dists_k = z_{k+1} - z_k (last gets 1e10), scaled by |rays_d|;
  rgb = sigmoid(raw[..., :C]);
  alpha_k = 1 - exp(-relu(sigma_raw_k + noise_k) * dists_k);
  weights = alpha * cumprod_exclusive(1 - alpha + 1e-10);
  rgb_map = sum_k w_k rgb_k;  depth = sum w z;  disp = 1/max(1e-10, depth/acc).

Reference quirk kept: Gaussian sigma noise is on at train AND eval whenever
a generator is given (the reference's raw_noise_std flag is dead). Random
draws come from explicit torch.Generators; tests inject the values instead.
"""

from __future__ import annotations

import torch


def exclusive_cumprod_one_minus(alpha, eps=1e-10):
    """cumprod([1, 1-a_0+eps, ...])[:-1] along the sample axis (last)."""
    t = torch.cumprod(1.0 - alpha + eps, dim=-1)
    return torch.cat([torch.ones_like(t[..., :1]), t[..., :-1]], dim=-1)


def composite(raw, z_vals, rays_d, channels: int, noise_std: float = 1.0,
              generator=None, noise=None):
    """Alpha compositing along each ray.

    raw (..., S, channels+1); z_vals (..., S); rays_d (..., 3).
    generator: torch.Generator for the sigma noise (None -> deterministic);
    noise: explicit (..., S) sigma-noise values (overrides generator).
    """
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)

    rgb = torch.sigmoid(raw[..., :channels])
    sigma_raw = raw[..., channels]
    if noise is not None:
        sigma_raw = sigma_raw + noise
    elif generator is not None and noise_std > 0.0:
        sigma_raw = sigma_raw + torch.randn(
            sigma_raw.shape, generator=generator, device=sigma_raw.device,
            dtype=sigma_raw.dtype) * noise_std

    sigma = torch.relu(sigma_raw)
    alpha = 1.0 - torch.exp(-sigma * dists)
    weights = alpha * exclusive_cumprod_one_minus(alpha)

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(depth_map / acc_map, min=1e-10)
    return {
        "rgb_map": rgb_map,
        "disp_map": disp_map,
        "acc_map": acc_map,
        "weights": weights,
        "depth_map": depth_map,
        "sigma": sigma,
    }


def stratified_z(generator, n_rays, n_samples, near=0.0, far=1.0, t_rand=None,
                 device=None, dtype=torch.float32):
    """Stratified depth samples in [near, far], always perturbed (the
    reference ignores its perturb flag). generator None and t_rand None ->
    the unperturbed linspace; t_rand (n_rays, n_samples) injects draws."""
    if t_rand is not None:
        device, dtype = t_rand.device, t_rand.dtype
    t = torch.linspace(0.0, 1.0, n_samples, device=device, dtype=dtype)
    z = (near * (1.0 - t) + far * t).expand(n_rays, n_samples)
    if generator is None and t_rand is None:
        return z
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    upper = torch.cat([mids, z[..., -1:]], dim=-1)
    lower = torch.cat([z[..., :1], mids], dim=-1)
    if t_rand is None:
        t_rand = torch.rand(z.shape, generator=generator, device=device,
                            dtype=dtype)
    return lower + (upper - lower) * t_rand
