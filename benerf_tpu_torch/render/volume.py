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


class _PositiveCumprod(torch.autograd.Function):
    """torch.cumprod along the last axis of inputs with no zero, with the
    gradient torch's own backward takes for such inputs (the reversed
    cumulative sum of output x cotangent, over the input). torch's backward
    first asks the host whether an input is zero, a device-to-host read
    that a CUDA graph cannot capture."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return (out * g).flip(-1).cumsum(-1).flip(-1).div(x)


def exclusive_cumprod_one_minus(alpha, eps=1e-10):
    """cumprod([1, 1-a_0+eps, ...])[:-1] along the sample axis (last).
    alpha lies in [0, 1], so no factor is below eps: none is zero."""
    t = _PositiveCumprod.apply(1.0 - alpha + eps)
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
        sigma_raw = sigma_raw + sigma_noise(generator, sigma_raw.shape,
                                            noise_std, sigma_raw.device,
                                            sigma_raw.dtype)

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
        t_rand = stratified_draws(generator, n_rays, n_samples, device, dtype)
    return lower + (upper - lower) * t_rand


def stratified_draws(generator, n_rays, n_samples, device, dtype):
    """The (n_rays, n_samples) uniforms stratified_z draws from `generator`
    (a sharded step draws them whole and injects its rows as t_rand)."""
    return torch.rand((n_rays, n_samples), generator=generator, device=device,
                      dtype=dtype)


def sigma_noise(generator, shape, noise_std, device, dtype):
    """The sigma noise composite draws from `generator` (a sharded step
    draws it whole and injects its rows as `noise`)."""
    return torch.randn(shape, generator=generator, device=device,
                       dtype=dtype) * noise_std
