"""The NeRF MLP and the hierarchical volume renderer.

MLP: inputs are the positional encodings [x, sin(2^k x), cos(2^k x)]_k of
the point (10 bands, 63 rows) and of the ray's unit direction (4 bands, 27
rows); 8 ReLU layers of width 256, the point's encoding joined again to the
input of the layer after the fifth (a skip); then alpha (no activation),
a feature layer (no activation), a ReLU layer of width 128 over the feature
and the direction's encoding, and the colour head. The weights come in the
layout the benchmark makes them in: per layer `w` (fan_in, fan_out) and
`b`, the skip layer's weight split by rows into `w_pe` and `w_h`, the
views layer's into `w_feat` and `w_pe`.

Renderer: 64 stratified depths in [0, 1] along the NDC ray, each jittered
in its stratum; raw -> alpha = 1 - exp(-relu(sigma + noise) * dist), dist
the gap to the next depth (1e10 after the last) times |d|; weights = alpha
times the product of (1 - alpha + 1e-10) over the earlier samples; colour
= sigmoid(raw rgb) summed by weight. Then 64 more depths by inverting the
CDF of the coarse weights of the inner bins (plus 1e-5 each) at sorted
uniforms, the fine network evaluated at all 128 depths in order.
"""

from __future__ import annotations

import torch

from benchmark.reference import draws as draws_mod
from benchmark.reference import geometry

LAST_EDGE = 1e-3


def encode(x, bands):
    parts = [x]
    for k in range(bands):
        parts += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(parts, -1)


def mlp(p, pts, views, samples):
    """raw (n, C + 1) = [rgb logits, sigma] at n = rays x samples points,
    ray-major; views (rays, 3) unit directions."""
    pe = encode(pts, 10)
    h = pe
    for layer in p["pts"]:
        if "w_pe" in layer:
            h = pe @ layer["w_pe"] + h @ layer["w_h"] + layer["b"]
        else:
            h = h @ layer["w"] + layer["b"]
        h = torch.relu(h)
    alpha = h @ p["alpha"]["w"] + p["alpha"]["b"]
    feat = h @ p["feature"]["w"] + p["feature"]["b"]
    vpe = torch.repeat_interleave(encode(views, 4), samples, dim=0)
    hv = torch.relu(feat @ p["views"]["w_feat"] + vpe @ p["views"]["w_pe"]
                    + p["views"]["b"])
    rgb = hv @ p["rgb"]["w"] + p["rgb"]["b"]
    return torch.cat([rgb, alpha], -1)


def composite(raw, z, d, noise):
    """-> (rgb (R, C), weights (R, S), rays at the last sample's jump (R,));
    raw (R, S, C + 1). The last sample's interval is 1e10 long, so its
    alpha jumps from 0 to 1 as its sigma + noise crosses 0: a ray whose
    value there lies within LAST_EDGE of 0 is marked, as a rounding can
    switch its last sample on or off."""
    dist = torch.cat([z[:, 1:] - z[:, :-1],
                      torch.full_like(z[:, :1], 1e10)], -1)
    dist = dist * torch.linalg.norm(d, dim=-1, keepdim=True)
    sigma = torch.relu(raw[..., -1] + noise)
    edge = torch.abs(raw[:, -1, -1] + noise[:, -1]) < LAST_EDGE
    alpha = 1.0 - torch.exp(-sigma * dist)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
    w = alpha * trans
    rgb = torch.sum(w[..., None] * torch.sigmoid(raw[..., :-1]), dim=-2)
    return rgb, w, edge


def invert_cdf(edges, w, u):
    """Depths at the uniforms u (R, N) of the piecewise-constant density
    over the bins between edges (R, B) with masses w (R, B - 1), and per
    ray whether a depth lies in a bin whose share of the mass is within
    0.1% of 1e-5, where the method's rule for near-empty bins (a share
    under 1e-5 places the depth at the bin's lower edge) jumps: there a
    rounding of the weights moves the depth by up to a bin."""
    w = w + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    hi = torch.searchsorted(cdf, u.contiguous(), right=True)
    lo = torch.clamp(hi - 1, min=0)
    hi = torch.clamp(hi, max=cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(-1, lo), cdf.gather(-1, hi)
    e0, e1 = edges.gather(-1, lo), edges.gather(-1, hi)
    share = c1 - c0
    near = (torch.abs(share - 1e-5) <= 1e-8).any(-1)
    span = torch.where(share < 1e-5, torch.ones_like(c0), share)
    return e0 + (u - c0) / span * (e1 - e0), near


def render_rays(coarse, fine, families, S, N, noise_std):
    """Render ray families through one coarse and one fine pass.

    families: list of dicts {o, d (world rays, R x 3), H, W, focal, gens
    (z, pdf, noise_c, noise_f generators)}. -> list of (rgb_coarse (R, C),
    rgb_fine (R, C), rays at a jump of the method (R,): fine depths at
    invert_cdf's, or a last sample at composite's)."""
    vds, ds, zs, os_ = [], [], [], []
    for f in families:
        vds.append(f["d"] / torch.linalg.norm(f["d"], dim=-1, keepdim=True))
        o, d = geometry.to_ndc(f["H"], f["W"], f["focal"], f["o"], f["d"])
        R = o.shape[0]
        t = torch.linspace(0.0, 1.0, S, dtype=o.dtype, device=o.device)
        mid = 0.5 * (t[1:] + t[:-1])
        lo, hi = torch.cat([t[:1], mid]), torch.cat([mid, t[-1:]])
        zs.append(lo + (hi - lo) * draws_mod.uniform(f["gens"]["z"], (R, S)))
        os_.append(o)
        ds.append(d)

    def run(params, zlist):
        pts = torch.cat([o[:, None] + d[:, None] * z[..., None]
                         for o, d, z in zip(os_, ds, zlist)]).reshape(-1, 3)
        raw = mlp(params, pts, torch.cat(vds), zlist[0].shape[1])
        return torch.split(raw.reshape(-1, zlist[0].shape[1], raw.shape[-1]),
                           [z.shape[0] for z in zlist])

    out, z_all, unsure = [], [], []
    for f, raw, z, d in zip(families, run(coarse, zs), zs, ds):
        noise = draws_mod.normal(f["gens"]["noise_c"], z.shape) * noise_std
        rgb_c, w, edge = composite(raw, z, d, noise)
        with torch.no_grad():
            u = draws_mod.sorted_uniform(f["gens"]["pdf"], (z.shape[0],), N)
            extra, near = invert_cdf(0.5 * (z[:, 1:] + z[:, :-1]),
                                     w[:, 1:-1], u)
            z_all.append(torch.sort(torch.cat([z, extra], -1), -1).values)
        out.append(rgb_c)
        unsure.append(near | edge)
    result = []
    for f, raw, z, d, rgb_c, near in zip(families, run(fine, z_all), z_all, ds,
                                         out, unsure):
        noise = draws_mod.normal(f["gens"]["noise_f"], z.shape) * noise_std
        rgb_f, _, edge = composite(raw, z, d, noise)
        result.append((rgb_c, rgb_f, near | edge))
    return result


def render_chunk(coarse, fine, pose, K, H, W, idx, gens, S, N, noise_std):
    """(rgb (R, C) of the fine pass, rays at a jump of the method (R,)) at
    flat pixels idx of one frame."""
    o, d = geometry.pixel_rays(idx, W, K, pose.expand(idx.shape[0], 3, 4))
    fam = dict(o=o, d=d, H=H, W=W, focal=K[0, 0], gens=gens)
    with torch.no_grad():
        return render_rays(coarse, fine, [fam], S, N, noise_std)[0][1:]
