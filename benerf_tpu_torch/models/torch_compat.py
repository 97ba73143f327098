"""Convert PyTorch-reference NeRF and CRF weights to the port's param trees.

Port of benerf_tpu/models/torch_compat.py: used by cli/test.py to import
reference .tar checkpoints (reference test.py:98-107 naming) and by parity
tests to load recorded reference weights.

torch nn.Linear stores weight as (out, in); the port's layout (that of the
JAX package, models/nerf.py) is (in, out), so every matrix transposes. The
skip layer and the views layer are split into pairs at the same columns as
the JAX function (concat order [input_pts, h], reference model/nerf.py:98;
[feature, input_views], model/nerf.py:103). Every leaf is a contiguous
copy on `device` (default: the card, raising without one; see
benerf_tpu_torch.resolve_device), converted on the CPU and moved once.
"""

from __future__ import annotations

import numpy as np
import torch

from benerf_tpu_torch import resolve_device


def _getter(sd, prefix):
    def get(name):
        v = sd[prefix + name]
        return torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v.detach().cpu())
    return get


def _to(tree, device):
    """Every leaf a contiguous copy on `device` (none shares the state
    dict's memory)."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.contiguous().to(device, copy=True)


def nerf_params_from_state_dict(sd: dict, prefix: str = "", depth: int = 8,
                                input_ch: int = 63, width: int = 256,
                                skips=(4,), device=None):
    """sd maps '<prefix>pts_linears.0.weight' etc. to numpy arrays or CPU
    tensors -> the port's NeRF param tree on `device`."""
    device = resolve_device(device)
    get = _getter(sd, prefix)

    layers = []
    for i in range(depth):
        w = get(f"pts_linears.{i}.weight")  # (out, in)
        b = get(f"pts_linears.{i}.bias")
        if i > 0 and (i - 1) in skips:
            layers.append({"w_pe": w[:, :input_ch].T, "w_h": w[:, input_ch:].T,
                           "b": b})
        else:
            layers.append({"w": w.T, "b": b})

    params = {"pts": layers}
    if prefix + "views_linears.0.weight" in sd:
        vw = get("views_linears.0.weight")  # (width/2, width + views_ch)
        params["feature"] = {"w": get("feature_linear.weight").T,
                             "b": get("feature_linear.bias")}
        params["alpha"] = {"w": get("alpha_linear.weight").T,
                           "b": get("alpha_linear.bias")}
        params["views"] = {"w_feat": vw[:, :width].T, "w_pe": vw[:, width:].T,
                           "b": get("views_linears.0.bias")}
        params["rgb"] = {"w": get("rgb_linear.weight").T,
                         "b": get("rgb_linear.bias")}
    else:
        params["output"] = {"w": get("output_linear.weight").T,
                            "b": get("output_linear.bias")}
    return _to(params, device)


def crf_params_from_state_dict(sd: dict, prefix: str = "", device=None):
    """A ColorToneMapper.mlp_gray / LuminanceToneMapper.mlp_luminance
    nn.Sequential state dict (reference component.py:48-58,126-135: Linear
    layers at even indices, ReLU between) -> models/crf.py params on
    `device`."""
    device = resolve_device(device)
    get = _getter(sd, prefix)
    idxs = sorted(
        {int(k[len(prefix):].split(".")[0]) for k in sd if k.startswith(prefix)}
    )
    layers = [{"w": get(f"{i}.weight").T, "b": get(f"{i}.bias")} for i in idxs]
    return _to({"layers": layers}, device)
