"""One BeNeRF train step and Adam, in float64.

A step, from the seed and the step's index:
  1. the event window: [low, low + L] with low ~ U(0, 1 - L) (or a slot
     k L, k uniform, without random placement), clipped to 1; the
     polarities of the events with low <= t <= up (inclusive) summed per
     pixel (ETA);
  2. the poses: 2 event poses at the window's ends on the knots' spline,
     P rgb poses over the exposure on the spline of knots + transform;
  3. pixel subsets of both sensors, the same for every pose of a family;
  4. both families rendered through one coarse and one fine pass;
  5. the event loss, coarse and fine: the difference of log brightness
     (luma for 3 channels; log(x + 1e-9) on BeNeRF scenes, the lin-log map
     on E2NeRF ones) between the window's ends against ETA x threshold
     (mean squared error x coeff_syn), or with threshold -1 both
     normalised over the rays (x coeff_real); the blur loss, coarse and
     fine: the mean over the P poses against the blurry pixels, x
     rgb_coeff;
  6. the gradient of their sum, and Adam (beta 0.9 / 0.999, eps 1e-8) on
     each enabled group with lr0 x rate^(i / (lrate_decay x 1000)) before
     update i, after a linear warm-up of pose_lrate_warmup updates on the
     knots and the transform.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import draws as draws_mod
from benchmark.reference import geometry
from benchmark.reference import render

GRAY = (0.299, 0.587, 0.114)
BETAS, EPS = (0.9, 0.999), 1e-8

# group -> (enable flag, collections, lr0 key, rate key, warm-up)
GROUPS = {
    "nerf": ("optimize_nerf", ("nerf", "nerf_fine"), "lrate", "decay_rate", False),
    "knots": ("optimize_pose", ("knots",), "pose_lrate", "decay_rate_pose", True),
    "transform": ("optimize_trans", ("transform",), "transform_lrate",
                  "decay_rate_transform", True),
    "rgb_crf": ("optimize_rgb_crf", ("rgb_crf",), "rgb_crf_lrate",
                "decay_rate_rgb_crf", False),
    "event_crf": ("optimize_event_crf", ("event_crf",), "event_crf_lrate",
                  "decay_rate_event_crf", False),
}


def leaves(tree, prefix=""):
    """[(path, tensor)] of a tree of dicts and lists, keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def event_window(c, gens, events, hw):
    L = c["accumulate_time_length"]
    g = gens["window"]
    if c["random_sampling_window"]:
        low = torch.rand((), generator=g, device=g.device) * (1.0 - L)
    else:
        slots = max(int((1.0 - L) // L), 1)
        low = torch.randint(0, slots, (), generator=g,
                            device=g.device).to(torch.float32) * L
    up = torch.clamp(low + L, max=1.0)
    pix, ts, pol = events
    inside = ((ts >= low) & (ts <= up)).to(pol.dtype)
    eta = torch.zeros(hw, dtype=pol.dtype, device=pol.device).index_add_(
        0, pix, pol * inside)
    return eta.double(), low.double(), up.double()


def crf(p, x):
    h = x.reshape(-1, 1)
    for layer in p["layers"][:-1]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    h = h @ p["layers"][-1]["w"] + p["layers"][-1]["b"]
    return torch.sigmoid(h).reshape(x.shape)


def bright_log(x, dataset):
    if dataset in ("BeNeRF_Blender", "BeNeRF_Unreal"):
        return torch.log(x + 1e-9)
    c = x * 255.0
    return torch.where(c < 20.0, math.log(20.0 + 1e-9) / 20.0 * c,
                       torch.log(c + 1e-9))


def event_term(c, start, end, eta):
    if c["channels"] == 3:
        gray = torch.tensor(GRAY, dtype=start.dtype, device=start.device)
        start = (start * gray).sum(-1, keepdim=True)
        end = (end * gray).sum(-1, keepdim=True)
    diff = bright_log(end, c["dataset"]) - bright_log(start, c["dataset"])
    if c["event_threshold"] > 0:
        return torch.mean((diff - eta * c["event_threshold"]) ** 2) * c["event_coeff_syn"]
    dn = diff / (torch.linalg.norm(diff, dim=0, keepdim=True) + 1e-9)
    en = eta / (torch.linalg.norm(eta, dim=0, keepdim=True) + 1e-9)
    return torch.mean((dn - en) ** 2) * c["event_coeff_real"]


def loss(c, params, scene, seed, step):
    """The step's total loss (float64, differentiable in params) and its
    terms."""
    device = params["knots"].device
    gens = draws_mod.generators((seed, step), draws_mod.STEP_CONSUMERS, device)
    if not c["event_time_window"] or c.get("use_barf_c2f"):
        raise NotImplementedError("the reference covers time windows without BARF")
    H, W, He, We = scene["H"], scene["W"], scene["H_evt"], scene["W_evt"]
    eta, low, up = event_window(c, gens, scene["events"], He * We)
    n_evt = c["sampling_event_rays"]
    P = c["num_interpolated_pose"]
    n_rgb = c["sampling_rgb_rays"] // P
    top = c.get("fast_ray_sampling", False)
    idx_e = draws_mod.subset(gens["ray_evt"], He * We, n_evt, top)
    idx_r = draws_mod.subset(gens["ray_rgb"], H * W, n_rgb, top)
    knots = params["knots"]
    exp_ts = scene["rgb_exp_ts"]
    poses_e = geometry.spline_poses(knots, low, up, 2)
    poses_r = geometry.spline_poses(knots + params["transform"][None], exp_ts[0],
                                    exp_ts[1], P)

    def family(poses, idx, K, h, w, fam):
        R = idx.shape[0]
        o, d = geometry.pixel_rays(idx.repeat(poses.shape[0]), w, K,
                                   torch.repeat_interleave(poses, R, dim=0))
        return dict(o=o, d=d, H=h, W=w, focal=K[0, 0],
                    gens={"z": gens[f"z_{fam}"], "pdf": gens[f"pdf_{fam}"],
                          "noise_c": gens[f"noise_{fam}_c"],
                          "noise_f": gens[f"noise_{fam}_f"]})

    fams = [family(poses_e, idx_e, scene["K_evt"], He, We, "evt"),
            family(poses_r, idx_r, scene["K_rgb"], H, W, "rgb")]
    (ec, ef, _), (rc, rf, _) = render.render_rays(
        params["nerf"], params["nerf_fine"], fams, c["N_samples"],
        c["N_importance"], c.get("sigma_noise_std", 1.0))
    terms = {}
    if c["event_loss"]:
        tgt = eta[idx_e][:, None]
        for name, m in (("event_fine", ef), ("event_coarse", ec)):
            if c["optimize_event_crf"]:
                m = crf(params["event_crf"], m)
            terms[name] = event_term(c, m[:n_evt], m[n_evt:], tgt)
    if c["rgb_loss"]:
        target = scene["image"][idx_r]
        for name, m in (("rgb_fine", rf), ("rgb_coarse", rc)):
            if c["optimize_rgb_crf"]:
                m = crf(params["rgb_crf"], m)
            synth = m.reshape(P, n_rgb, -1).mean(0)
            terms[name] = torch.mean((synth - target) ** 2) * c["rgb_coeff"]
    return sum(terms.values()), terms


def learning_rate(c, group, i):
    flag, _, lr_key, rate_key, warm = GROUPS[group]
    lr0, w = c[lr_key], c.get("pose_lrate_warmup", 0) if warm else 0
    if i < w:
        return lr0 * i / w
    return lr0 * c[rate_key] ** ((i - w) / (c["lrate_decay"] * 1000))


def trained_paths(c, params):
    """{path: group} of the leaves Adam updates."""
    out = {}
    for group, (flag, colls, *_rest) in GROUPS.items():
        if c[flag]:
            for coll in colls:
                for path, _ in leaves(params[coll], "/" + coll):
                    out[path] = group
    return out


def gradient(c, tree, scene, seed, i, groups):
    """(loss, {path: gradient}) of step i at the leaves of `tree` (which
    require grad), for the leaves in `groups`."""
    total, _ = loss(c, tree, scene, seed, i)
    flat = dict(leaves(tree))
    names = [k for k in flat if k in groups]
    grads = torch.autograd.grad(total, [flat[k] for k in names],
                                allow_unused=True)
    return float(total.detach()), {
        k: (torch.zeros_like(flat[k]) if g is None else g.detach())
        for k, g in zip(names, grads)}


def run_steps(c, params, scene, seed, n_steps):
    """n_steps steps from params (a tree of float64 leaves, copied here)
    -> (losses [n_steps], each step's gradient [{path: tensor}], params
    after {path: tensor})."""
    p = {k: v for k, v in leaves(params)}
    tree = rebuild(params, {k: v.detach().clone().requires_grad_(True)
                             for k, v in p.items()})
    groups = trained_paths(c, tree)
    m = {k: torch.zeros_like(v) for k, v in leaves(tree) if k in groups}
    v2 = {k: torch.zeros_like(v) for k, v in leaves(tree) if k in groups}
    losses, grads_by_step = [], []
    flat = dict(leaves(tree))
    for i in range(n_steps):
        total, grads = gradient(c, tree, scene, seed, i, groups)
        grads_by_step.append(grads)
        losses.append(total)
        t = i + 1
        with torch.no_grad():
            for k, g in grads.items():
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                lr = learning_rate(c, groups[k], i)
                mh = m[k] / (1 - BETAS[0] ** t)
                vh = v2[k] / (1 - BETAS[1] ** t)
                flat[k].sub_(lr * mh / (vh.sqrt() + EPS))
    return losses, grads_by_step, {k: v.detach() for k, v in leaves(tree)}


def rebuild(tree, by_path, prefix=""):
    """A tree shaped like `tree` with the leaf at each path from by_path."""
    if isinstance(tree, dict):
        return {k: rebuild(tree[k], by_path, f"{prefix}/{k}") for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rebuild(v, by_path, f"{prefix}/{i}")
                          for i, v in enumerate(tree))
    return by_path[prefix]
