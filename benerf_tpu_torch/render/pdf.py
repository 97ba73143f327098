"""Inverse-CDF hierarchical ("fine") sampling.

Port of benerf_tpu/render/pdf.py (reference sample_pdf): build a
piecewise-constant pdf over coarse bins from compositing weights, invert its
CDF at uniform samples and interpolate bin edges linearly. The JAX package
gathers with one-hot matmuls (fast on the TPU's matrix unit); here
torch.searchsorted and gather do the same on the card. Samples are constants
for autograd: callers detach them.
"""

from __future__ import annotations

import torch


def sample_pdf(bins, weights, n_samples: int, generator=None, u=None,
               sorted_draws: bool = False):
    """Draw n_samples per ray from the histogram defined by (bins, weights).

    bins (..., B) bin edges; weights (..., B-1) unnormalized bin masses.
    u: optional (..., n_samples) injected uniforms. Else, with a generator:
    iid uniforms, or with sorted_draws their ascending order statistics
    (normalized partial sums of exponentials), so the output is ascending
    per ray. No generator and no u: the deterministic linspace grid.
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (...,B)

    shape = cdf.shape[:-1]
    if u is None:
        kw = dict(device=cdf.device, dtype=cdf.dtype)
        if generator is None:
            u = torch.linspace(0.0, 1.0, n_samples, **kw).expand(
                shape + (n_samples,))
        elif sorted_draws:
            u = sorted_uniforms(generator, shape, n_samples, **kw)
        else:
            u = torch.rand(shape + (n_samples,), generator=generator, **kw)
    u = u.contiguous()

    # count of cdf entries <= u
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def sorted_uniforms(generator, shape, n_samples: int, device, dtype):
    """shape + (n_samples,) ascending order statistics of iid uniforms
    (normalized partial sums of exponentials), drawn from `generator`:
    sample_pdf's sorted draws (a sharded step draws them whole and injects
    its rows)."""
    e = -torch.log1p(-torch.rand(tuple(shape) + (n_samples + 1,),
                                 generator=generator, device=device,
                                 dtype=dtype))
    c = torch.cumsum(e, dim=-1)
    return c[..., :-1] / c[..., -1:]


def merge_sorted(a, b):
    """Merge two per-ray ascending arrays (..., S1), (..., S2) ->
    (..., S1+S2), equal to sorting their concatenation. Each element's
    output position is its own index plus its rank in the other array; ties
    break a-before-b. Values only (no gradient path)."""
    a, b = a.contiguous(), b.contiguous()
    S1, S2 = a.shape[-1], b.shape[-1]
    pos_a = torch.arange(S1, device=a.device) + torch.searchsorted(b, a)
    pos_b = torch.arange(S2, device=a.device) + torch.searchsorted(
        a, b, right=True)
    out = torch.empty(a.shape[:-1] + (S1 + S2,), device=a.device, dtype=a.dtype)
    out.scatter_(-1, pos_a, a)
    out.scatter_(-1, pos_b, b)
    return out
