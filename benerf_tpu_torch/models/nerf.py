"""NeRF MLP as a parameter dict of tensors + functional apply.

Port of benerf_tpu/models/nerf.py, same parameter layout (the JAX pytree):
  - 8 trunk layers of width 256 with ReLU; the skip concat of the positional
    encoding feeds layer 5, stored split as `w_pe` (63, W) and `w_h` (W, W);
  - viewdir branch: alpha head 256->1, feature 256->256, views layer over
    concat(feature, view PE) stored split as `w_feat` (W, W/2) and `w_pe`
    (27, W/2), then the rgb head 128->channels;
  - output = concat([rgb, alpha_raw]) per sample point;
  - weights are (fan_in, fan_out) Xavier-uniform, biases zero.

`apply` is the plain PyTorch version of the fused CUDA kernels K1/K2
(ops/fused_mlp.py): the CPU path, and what chip_smoke.py holds the kernels
against on the card. Its matmuls run in the operands' dtype (true fp32, or
fp64 in the float64 parity tests); on the card TF32 must stay off.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from benerf_tpu_torch.models import embedder

Params = Dict[str, Any]


def xavier_uniform(generator, shape, device=None, dtype=torch.float32):
    fan_in, fan_out = shape[0], shape[1]
    a = (6.0 / (fan_in + fan_out)) ** 0.5
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return u * (2.0 * a) - a


def init_params(
    generator,
    depth: int = 8,
    width: int = 256,
    input_ch: int = 63,
    input_ch_views: int = 27,
    channels: int = 3,
    skips=(4,),
    use_viewdirs: bool = True,
    device=None,
    dtype=torch.float32,
) -> Params:
    """Initialize one NeRF MLP (coarse or fine) from a torch.Generator that
    lives on `device`."""

    def xavier(shape):
        return xavier_uniform(generator, shape, device, dtype)

    def zeros(n):
        return torch.zeros((n,), device=device, dtype=dtype)

    layers = []
    for i in range(depth):
        if i > 0 and (i - 1) in skips:
            # one Xavier draw over the concatenated fan-in, split
            full = xavier((input_ch + width, width))
            layers.append({"w_pe": full[:input_ch].contiguous(),
                           "w_h": full[input_ch:].contiguous(),
                           "b": zeros(width)})
        else:
            in_dim = input_ch if i == 0 else width
            layers.append({"w": xavier((in_dim, width)), "b": zeros(width)})

    params: Params = {"pts": layers}
    if use_viewdirs:
        params["feature"] = {"w": xavier((width, width)), "b": zeros(width)}
        params["alpha"] = {"w": xavier((width, 1)), "b": zeros(1)}
        full = xavier((width + input_ch_views, width // 2))
        params["views"] = {
            "w_feat": full[:width].contiguous(),
            "w_pe": full[width:].contiguous(),
            "b": zeros(width // 2),
        }
        params["rgb"] = {"w": xavier((width // 2, channels)),
                         "b": zeros(channels)}
    else:
        params["output"] = {"w": xavier((width, channels + 1)),
                            "b": zeros(channels + 1)}
    return params


def apply(
    params: Params,
    pts,
    viewdirs=None,
    *,
    num_freqs: int = 10,
    num_freqs_views: int = 4,
    barf_weights=None,
    barf_weights_views=None,
    compute_dtype=None,
):
    """Evaluate the MLP at sample points.

    Args:
      pts: (..., S, 3) sample positions (any leading batch dims).
      viewdirs: (..., 3) unit view directions, broadcast over S; or None.
      barf_weights[_views]: optional (L,) coarse-to-fine weights.
      compute_dtype: optional dtype for matmul inputs (torch.bfloat16);
        results are cast back to the input dtype.
    Returns:
      (..., S, channels+1) raw [rgb..., sigma_raw].
    """
    in_shape = pts.shape
    x = pts.reshape(-1, in_shape[-1])

    pe = embedder.positional_encoding(x, num_freqs,
                                      include_input=barf_weights is None)
    if barf_weights is not None:
        pe = embedder.apply_barf_weights(pe, barf_weights, include_input=False)
        pe = torch.cat([x, pe], dim=-1)  # input rows first, then the bands

    def mm(a, w):
        if compute_dtype is not None:
            return (a.to(compute_dtype) @ w.to(compute_dtype)).to(x.dtype)
        return a @ w

    h = pe
    for layer in params["pts"]:
        if "w_pe" in layer:
            h = mm(pe, layer["w_pe"]) + mm(h, layer["w_h"]) + layer["b"]
        else:
            h = mm(h, layer["w"]) + layer["b"]
        h = torch.relu(h)

    if "views" not in params:
        out = mm(h, params["output"]["w"]) + params["output"]["b"]
        return out.reshape(in_shape[:-1] + (out.shape[-1],))

    alpha = mm(h, params["alpha"]["w"]) + params["alpha"]["b"]
    feat = mm(h, params["feature"]["w"]) + params["feature"]["b"]

    v = viewdirs.reshape(-1, viewdirs.shape[-1])
    vpe = embedder.positional_encoding(
        v, num_freqs_views, include_input=barf_weights_views is None
    )
    if barf_weights_views is not None:
        vpe = embedder.apply_barf_weights(vpe, barf_weights_views,
                                          include_input=False)
        vpe = torch.cat([v, vpe], dim=-1)
    # broadcast the per-ray view PE over its samples
    samples = x.shape[0] // v.shape[0]
    vpe = torch.repeat_interleave(vpe, samples, dim=0)

    hv = mm(feat, params["views"]["w_feat"]) + mm(vpe, params["views"]["w_pe"])
    hv = torch.relu(hv + params["views"]["b"])
    rgb = mm(hv, params["rgb"]["w"]) + params["rgb"]["b"]
    out = torch.cat([rgb, alpha], dim=-1)
    return out.reshape(in_shape[:-1] + (out.shape[-1],))
