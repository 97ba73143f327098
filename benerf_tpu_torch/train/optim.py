"""Optimizer: the reference's five Adams as one torch.optim.Adam with one
parameter group per collection.

Port of benerf_tpu/train/optim.py (reference model/optimize.py:36-55 and
train.py:343-394): groups {nerf (coarse + fine), knots, transform, rgb_crf,
event_crf}, each Adam with torch's default betas and eps (which optax's adam
matches) and its own exponential decay. Before update i each group's lr is
set to lr0 * rate^(i / (lrate_decay * 1000)) — the JAX package's documented
lr(i) choice (the reference steps with lr(i-1)) — after a linear 0 -> lr0
ramp of `pose_lrate_warmup` updates on knots and transform, as
optax.join_schedules does. A disabled group is not in the optimizer: it is
never stepped and has no Adam state (optax.set_to_zero).

Each group's lr is a 0-d float32 tensor on the parameters' device that
set_learning_rates overwrites in place, so a step captured in a CUDA graph
(train/step.py make_multi_step) reads the current value at every replay.
On the card the Adam is built capturable (its per-parameter `step` lives on
the card too); torch's capturable Adam takes no CPU tensors, so on the CPU
it is not. Both run Adam's update; they round its scalar factors in
different orders.
"""

from __future__ import annotations

import torch

from benerf_tpu_torch.models.bridge import tree_leaves

GROUPS = ("nerf", "knots", "transform", "rgb_crf", "event_crf")
_COLLECTIONS = {"nerf": ("nerf", "nerf_fine"), "knots": ("knots",),
                "transform": ("transform",), "rgb_crf": ("rgb_crf",),
                "event_crf": ("event_crf",)}


def _group_settings(cfg):
    """group -> (enabled, lr0, decay rate, warmup updates)."""
    w = cfg.pose_lrate_warmup
    return {
        "nerf": (cfg.optimize_nerf, cfg.lrate, cfg.decay_rate, 0),
        "knots": (cfg.optimize_pose, cfg.pose_lrate, cfg.decay_rate_pose, w),
        "transform": (cfg.optimize_trans, cfg.transform_lrate,
                      cfg.decay_rate_transform, w),
        "rgb_crf": (cfg.optimize_rgb_crf, cfg.rgb_crf_lrate,
                    cfg.decay_rate_rgb_crf, 0),
        "event_crf": (cfg.optimize_event_crf, cfg.event_crf_lrate,
                      cfg.decay_rate_event_crf, 0),
    }


def learning_rate(group, step: int) -> float:
    """lr of an optimizer param group before update `step`."""
    lr0, warmup = group["lr0"], group["warmup"]
    if step < warmup:
        return lr0 * step / warmup
    return lr0 * group["rate"] ** ((step - warmup) / group["decay_steps"])


def build_optimizer(cfg, params):
    """torch.optim.Adam over the enabled groups of the train-state params,
    capturable on the card."""
    groups = []
    device = params["knots"].device
    for name, (enabled, lr0, rate, warmup) in _group_settings(cfg).items():
        if not enabled:
            continue
        leaves = [t for c in _COLLECTIONS[name] for t in tree_leaves(params[c])]
        groups.append({"params": leaves, "name": name,
                       "lr": torch.tensor(lr0, dtype=torch.float32, device=device),
                       "lr0": lr0, "rate": rate, "warmup": warmup,
                       "decay_steps": cfg.lrate_decay * 1000})
    return torch.optim.Adam(groups, capturable=device.type == "cuda")


def set_learning_rates(optimizer, step: int) -> None:
    """Write each group's lr before update `step` into its tensor."""
    for group in optimizer.param_groups:
        group["lr"].fill_(learning_rate(group, step))
