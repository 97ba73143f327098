"""The BeNeRF train step: event window + ETA, spline poses, both ray
families' coarse+fine render, both losses, backward, five Adam groups.

Port of benerf_tpu/train/step.py. The loss keeps the JAX package's split:
loss_fn(params, batch, draws, step) is a pure function of the `draws` dict,
and draw_fn(generators) makes that dict from the step's torch.Generators,
so parity tests inject recorded draws and compare loss and gradients
through the production code path. PyTorch runs eagerly: the JAX package's
jit and lax.scan of steps become a Python call per step.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from benerf_tpu_torch.core import rng as rng_mod
from benerf_tpu_torch.data import events as events_mod
from benerf_tpu_torch.geometry import spline as spline_mod
from benerf_tpu_torch.models import crf as crf_mod
from benerf_tpu_torch.models import nerf as nerf_mod
from benerf_tpu_torch.models.bridge import tree_leaves
from benerf_tpu_torch.render import renderer as renderer_mod
from benerf_tpu_torch.train import loss as loss_mod
from benerf_tpu_torch.train import optim as optim_mod


class SceneBatch(NamedTuple):
    """Device-resident training data for one scene (static across steps)."""

    events: events_mod.EventArrays
    image_flat: torch.Tensor   # (H*W, C) observed blurry image
    rgb_exp_ts: torch.Tensor   # (2,) normalized exposure interval
    K_rgb: torch.Tensor        # (3,3)
    K_evt: torch.Tensor        # (3,3)
    img_remap: Optional[torch.Tensor] = None  # (H*W, 2) undistort LUT
    evt_remap: Optional[torch.Tensor] = None


class TrainState(NamedTuple):
    params: Any                  # dict of collections of leaf tensors
    optimizer: torch.optim.Optimizer
    step: int


def build_params(cfg, seed: int = 0, init_knots=None, init_transform=None,
                 device="cpu"):
    """All trainable collections (reference Model.build_network): knots ~
    U(0, 0.01), transform = 0, NeRF MLPs Xavier/zero, CRFs Xavier with zero
    (rgb) / one (event) biases. Every leaf requires grad."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    params = {
        "nerf": nerf_mod.init_params(g, depth=cfg.netdepth, width=cfg.netwidth,
                                     channels=cfg.channels, device=device),
        "nerf_fine": nerf_mod.init_params(g, depth=cfg.netdepth_fine,
                                          width=cfg.netwidth_fine,
                                          channels=cfg.channels, device=device),
        # copies: the optimizer updates the leaves in place
        "knots": (torch.as_tensor(init_knots, dtype=torch.float32,
                                  device=device).clone()
                  if init_knots is not None
                  else torch.rand((4, 6), generator=g, device=device) * 0.01),
        "transform": (torch.as_tensor(init_transform, dtype=torch.float32,
                                      device=device).reshape(6).clone()
                      if init_transform is not None
                      else torch.zeros((6,), device=device)),
        "rgb_crf": crf_mod.init_params(g, cfg.rgb_crf_net_hidden,
                                       cfg.rgb_crf_net_width, bias_init=0.0,
                                       device=device),
        "event_crf": crf_mod.init_params(g, cfg.event_crf_net_hidden,
                                         cfg.event_crf_net_width,
                                         bias_init=1.0, device=device),
    }
    for t in tree_leaves(params):
        t.requires_grad_(True)
    return params


def init_state(cfg, seed: int = 0, device="cpu", params=None, **kw) -> TrainState:
    params = params if params is not None else build_params(
        cfg, seed, device=device, **kw)
    return TrainState(params, optim_mod.build_optimizer(cfg, params), 0)


def _apply_crf(crf_params, x):
    """Elementwise 1->1 CRF applied per channel."""
    return crf_mod.apply(crf_params, x.reshape(-1, 1)).reshape(x.shape)


def make_loss_fn(cfg, H: int, W: int):
    """(loss_fn, draw_fn) for one iteration.

    loss_fn(params, batch, draws, step) -> (total, metrics);
    draw_fn(generators) -> draws (step_generators' dict in, window bounds,
    ray subsets and per-family generators out).
    """
    settings = renderer_mod.RenderSettings.from_config(cfg)
    H_evt, W_evt = cfg.event_height, cfg.event_width
    hw_rgb, hw_evt = H * W, H_evt * W_evt
    n_evt_rays = cfg.sampling_event_rays
    n_rgb_rays = cfg.sampling_rgb_rays // cfg.num_interpolated_pose
    n_poses = cfg.num_interpolated_pose

    def rand_subset(g, n, k):
        """k distinct pixel indices out of n: a slice of a uniform
        permutation (reference randperm), or with fast_ray_sampling the
        top-k of iid uniforms."""
        if cfg.fast_ray_sampling:
            return torch.topk(torch.rand(n, generator=g, device=g.device), k).indices
        return torch.randperm(n, generator=g, device=g.device)[:k]

    def draw_fn(gens):
        draws = {}
        if cfg.event_time_window:
            draws["low_t"], draws["up_t"] = events_mod.sample_time_window(
                gens["window"], cfg.accumulate_time_length,
                cfg.random_sampling_window, device=gens["window"].device)
        else:
            draws["window_gen"] = gens["window"]
        draws["ray_idx_evt"] = rand_subset(gens["ray_evt"], hw_evt, n_evt_rays)
        draws["ray_idx_rgb"] = rand_subset(gens["ray_rgb"], hw_rgb, n_rgb_rays)
        for fam in ("evt", "rgb"):
            draws[f"keys_{fam}"] = {
                "z": gens[f"z_{fam}"], "pdf": gens[f"pdf_{fam}"],
                "noise_c": gens[f"noise_{fam}_c"],
                "noise_f": gens[f"noise_{fam}_f"],
            }
        return draws

    def loss_fn(params, batch: SceneBatch, draws, step):
        # 1. event window + ETA
        if cfg.event_time_window:
            low_t, up_t = draws["low_t"], draws["up_t"]
            eta, eta_overflow = events_mod.eta_time_window(
                batch.events, hw_evt, low_t, up_t, cap=cfg.event_window_cap)
        else:
            eta, low_t, up_t = events_mod.eta_count_window(
                batch.events, hw_evt, draws["window_gen"],
                cfg.accumulate_time_length, cfg.random_sampling_window)
            eta_overflow = torch.zeros((), dtype=torch.int64,
                                       device=eta.device)

        # 2. spline poses
        knots = params["knots"]
        evt_poses = spline_mod.interpolate_poses(knots, low_t, up_t, 2, cfg.traj)
        rgb_knots = knots + params["transform"][None, :]
        rgb_poses = spline_mod.interpolate_poses(
            rgb_knots, batch.rgb_exp_ts[0], batch.rgb_exp_ts[1], n_poses,
            cfg.traj)

        # 3-4. both families through one joint coarse+fine pass
        ray_idx_evt, ray_idx_rgb = draws["ray_idx_evt"], draws["ray_idx_rgb"]
        ret_evt, ret_rgb = renderer_mod.render_pose_families_with_ray_idx(
            params["nerf"], params["nerf_fine"],
            [
                dict(poses=evt_poses, ray_idx=ray_idx_evt, K=batch.K_evt,
                     H=H_evt, W=W_evt, keys=draws["keys_evt"],
                     remap=batch.evt_remap),
                dict(poses=rgb_poses, ray_idx=ray_idx_rgb, K=batch.K_rgb,
                     H=H, W=W, keys=draws["keys_rgb"], remap=batch.img_remap),
            ],
            settings, step=step,
        )

        metrics = {}
        total = torch.zeros((), device=knots.device, dtype=knots.dtype)

        # 5. event loss on the window endpoints
        if cfg.event_loss:
            fine, coarse = ret_evt["rgb_map"], ret_evt["rgb0"]
            b1_f, b2_f = fine[:n_evt_rays], fine[n_evt_rays:]
            b1_c, b2_c = coarse[:n_evt_rays], coarse[n_evt_rays:]
            if cfg.optimize_event_crf:
                b1_f, b2_f, b1_c, b2_c = (_apply_crf(params["event_crf"], b)
                                          for b in (b1_f, b2_f, b1_c, b2_c))
            eta_target = eta[ray_idx_evt][:, None]
            kw = dict(dataset=cfg.dataset, channels=cfg.channels,
                      event_threshold=cfg.event_threshold,
                      coeff_syn=cfg.event_coeff_syn,
                      coeff_real=cfg.event_coeff_real)
            ev_fine = loss_mod.event_loss_term(b1_f, b2_f, eta_target, **kw)
            ev_coarse = loss_mod.event_loss_term(b1_c, b2_c, eta_target, **kw)
            metrics["event_loss_fine"] = ev_fine
            metrics["event_loss_coarse"] = ev_coarse
            metrics["event_loss"] = ev_fine + ev_coarse
            total = total + ev_fine + ev_coarse

        # 6. blur-synthesis rgb loss
        if cfg.rgb_loss:
            rgb_fine, rgb_coarse = ret_rgb["rgb_map"], ret_rgb["rgb0"]
            if cfg.optimize_rgb_crf:
                rgb_fine = _apply_crf(params["rgb_crf"], rgb_fine)
                rgb_coarse = _apply_crf(params["rgb_crf"], rgb_coarse)
            target = batch.image_flat[ray_idx_rgb]
            rgb_fine_l = loss_mod.blur_rgb_loss_term(rgb_fine, target, cfg.rgb_coeff)
            rgb_coarse_l = loss_mod.blur_rgb_loss_term(rgb_coarse, target,
                                                       cfg.rgb_coeff)
            metrics["rgb_loss_fine"] = rgb_fine_l
            metrics["rgb_loss_coarse"] = rgb_coarse_l
            metrics["rgb_loss"] = rgb_fine_l + rgb_coarse_l
            total = total + rgb_fine_l + rgb_coarse_l

        metrics["eta_window_overflow"] = eta_overflow
        metrics["loss"] = total
        return total, metrics

    return loss_fn, draw_fn


def make_train_step(cfg, H: int, W: int):
    """step_fn(state, batch, seed) -> (state, metrics): one full iteration,
    with its draws made from (seed, state.step)."""
    loss_fn, draw_fn = make_loss_fn(cfg, H, W)

    def step_fn(state: TrainState, batch: SceneBatch, seed: int):
        params = state.params
        device = params["knots"].device
        draws = draw_fn(rng_mod.step_generators(seed, state.step, device))
        leaves = tree_leaves(params)
        for t in leaves:
            t.grad = None
        total, metrics = loss_fn(params, batch, draws, state.step)
        total.backward()
        with torch.no_grad():
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["grad_norm_knots"] = torch.linalg.norm(params["knots"].grad)
            nerf_grads = [t.grad for c in ("nerf", "nerf_fine")
                          for t in tree_leaves(params[c])]
            metrics["grad_norm_nerf"] = torch.sqrt(
                sum(torch.sum(g * g) for g in nerf_grads))
        optim_mod.set_learning_rates(state.optimizer, state.step)
        state.optimizer.step()
        return TrainState(params, state.optimizer, state.step + 1), metrics

    return step_fn
