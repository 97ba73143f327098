"""Hierarchical coarse+fine volume renderer (the forward graph).

Port of benerf_tpu/render/renderer.py (reference Graph.render): rays ->
{rgb_map, disp_map, acc_map, rgb0, disp0, acc0, sigma}. The train step
renders two ray families per iteration (event rays and rgb rays); they are
concatenated along the ray axis right before each MLP call, so a step makes
one coarse and one fine MLP call (one K1 launch each on the card), and split
right after. Per-ray numerics equal rendering each family alone.

Random draws: each family's `keys` dict holds torch.Generators ("z", "pdf",
"noise_c", "noise_f") or injected values ("z_u", "pdf_u", "noise_c_vals",
"noise_f_vals"), as the JAX package's keys dict holds PRNG keys or values.
Injected "pdf_u" rows are sorted with the coarse depths, as in the JAX
package; with "pdf_u_sorted" set they are ascending (the generator's own
draws, as a sharded step injects them) and merged like drawn ones.

Under a mesh (parallel/mesh.py) the rays of every family are this rank's
share; `mesh` only picks the MLP's route, as the JAX package's shard_map
region does (ops/mlp.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from benerf_tpu_torch.models import embedder
from benerf_tpu_torch.ops import mlp as mlp_ops
from benerf_tpu_torch.render import pdf as pdfm
from benerf_tpu_torch.render import rays as raysm
from benerf_tpu_torch.render import volume


@dataclass(frozen=True)
class RenderSettings:
    """Static rendering configuration."""

    n_samples: int = 64
    n_importance: int = 64
    channels: int = 3
    multires: int = 10
    multires_views: int = 4
    use_viewdirs: bool = True
    ndc: bool = True
    near: float = 0.0
    far: float = 1.0
    sigma_noise_std: float = 1.0  # reference quirk: on at train AND eval
    use_pallas: bool = True  # the JAX name: False runs the plain MLP route
    compute_dtype: str = "float32"
    use_barf_c2f: bool = False
    barf_c2f_start: float = 0.1
    barf_c2f_end: float = 0.5
    max_iter: int = 80000

    @classmethod
    def from_config(cls, cfg) -> "RenderSettings":
        return cls(
            n_samples=cfg.N_samples,
            n_importance=cfg.N_importance,
            channels=cfg.channels,
            multires=cfg.multires,
            multires_views=cfg.multires_views,
            use_viewdirs=cfg.use_viewdirs,
            ndc=cfg.ndc,
            sigma_noise_std=cfg.sigma_noise_std,
            use_pallas=cfg.use_pallas,
            compute_dtype=cfg.compute_dtype,
            use_barf_c2f=cfg.use_barf_c2f,
            barf_c2f_start=cfg.barf_c2f_start,
            barf_c2f_end=cfg.barf_c2f_end,
            max_iter=cfg.max_iter,
        )


def _barf_weights(settings: RenderSettings, step, device):
    if not settings.use_barf_c2f or step is None:
        return None, None
    kw = dict(max_iter=settings.max_iter, start=settings.barf_c2f_start,
              end=settings.barf_c2f_end, device=device)
    return (embedder.barf_c2f_weights(step, num_freqs=settings.multires, **kw),
            embedder.barf_c2f_weights(step, num_freqs=settings.multires_views,
                                      **kw))


def render_ray_families(nerf_params, nerf_fine_params, families,
                        settings: RenderSettings, step=None, mesh=None):
    """Render several independent ray batches through ONE coarse+fine pass.

    families: list of dicts {rays_o (R,3), rays_d (R,3), H, W, focal, keys}.
    Returns a list of per-family output dicts.
    """
    keys_list = [f.get("keys") or {} for f in families]
    device = families[0]["rays_o"].device

    viewdirs_l, rays_d_l, z_vals_l, rays_o_l, pts_l = [], [], [], [], []
    for f, keys in zip(families, keys_list):
        rays_o, rays_d = f["rays_o"], f["rays_d"]
        vd = (rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
              if settings.use_viewdirs else None)
        if settings.ndc:
            rays_o, rays_d = raysm.ndc_rays(f["H"], f["W"], f["focal"], 1.0,
                                            rays_o, rays_d)
        z_vals = volume.stratified_z(
            keys.get("z"), rays_o.shape[0], settings.n_samples,
            settings.near, settings.far, t_rand=keys.get("z_u"),
            device=rays_o.device, dtype=rays_o.dtype,
        )
        viewdirs_l.append(vd)
        rays_d_l.append(rays_d)
        rays_o_l.append(rays_o)
        z_vals_l.append(z_vals)
        pts_l.append(rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None])

    bw, bwv = _barf_weights(settings, step, device)

    def run_split(params, pts_list):
        return mlp_ops.mlp_forward_families(
            params, list(zip(pts_list, viewdirs_l)),
            num_freqs=settings.multires,
            num_freqs_views=settings.multires_views,
            barf_weights=bw, barf_weights_views=bwv,
            use_pallas=settings.use_pallas,
            compute_dtype=settings.compute_dtype, mesh=mesh,
        )

    raws = run_split(nerf_params, pts_l)

    outs, coarse_l, z_all_l, fine_pts_l = [], [], [], []
    for i, keys in enumerate(keys_list):
        z_vals, rays_d = z_vals_l[i], rays_d_l[i]
        coarse = volume.composite(
            raws[i], z_vals, rays_d, settings.channels,
            noise_std=settings.sigma_noise_std, generator=keys.get("noise_c"),
            noise=keys.get("noise_c_vals"),
        )
        coarse_l.append(coarse)
        outs.append({k: coarse[k] for k in ("rgb_map", "disp_map", "acc_map")})
        if settings.n_importance > 0:
            z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
            injected_u = keys.get("pdf_u")
            z_samples = pdfm.sample_pdf(
                z_mid, coarse["weights"][..., 1:-1], settings.n_importance,
                generator=keys.get("pdf"), u=injected_u,
                sorted_draws=injected_u is None,
            ).detach()  # reference: z_samples.detach()
            if injected_u is None or keys.get("pdf_u_sorted"):
                # both inputs ascending: a linear merge instead of a sort
                z_all = pdfm.merge_sorted(z_vals, z_samples)
            else:
                z_all, _ = torch.sort(torch.cat([z_vals, z_samples], -1), -1)
            fine_pts_l.append(rays_o_l[i][..., None, :]
                              + rays_d[..., None, :] * z_all[..., :, None])
            z_all_l.append(z_all)

    if settings.n_importance > 0:
        raws_fine = run_split(nerf_fine_params, fine_pts_l)
        for i, keys in enumerate(keys_list):
            coarse = coarse_l[i]
            fine = volume.composite(
                raws_fine[i], z_all_l[i], rays_d_l[i], settings.channels,
                noise_std=settings.sigma_noise_std,
                generator=keys.get("noise_f"), noise=keys.get("noise_f_vals"),
            )
            outs[i].update(
                rgb0=coarse["rgb_map"], disp0=coarse["disp_map"],
                acc0=coarse["acc_map"], sigma=fine["sigma"],
                rgb_map=fine["rgb_map"], disp_map=fine["disp_map"],
                acc_map=fine["acc_map"],
            )
    return outs


def render_rays(nerf_params, nerf_fine_params, rays_o, rays_d,
                settings: RenderSettings, H: int, W: int, focal, keys=None,
                step=None):
    """Render one batch of (R, 3) world-space rays through the coarse+fine
    pipeline; H, W, focal drive the NDC warp of their camera. keys as in
    render_ray_families (None: the deterministic variant). Returns the
    per-ray maps; rgb0/disp0/acc0 are the coarse outputs."""
    return render_ray_families(
        nerf_params, nerf_fine_params,
        [dict(rays_o=rays_o, rays_d=rays_d, H=H, W=W, focal=focal, keys=keys)],
        settings, step=step)[0]


def _pose_family(poses, ray_idx, K, H, W, keys, remap):
    """Every pose sees the same pixel subset; rows pose-major:
    [pose0 x all idx, pose1 x all idx, ...] (the loss slicing relies on it)."""
    P, R = poses.shape[0], ray_idx.shape[0]
    idx_tiled = ray_idx.repeat(P)                          # (P*R,)
    poses_tiled = torch.repeat_interleave(poses, R, dim=0)  # (P*R,3,4)
    rays_o, rays_d = raysm.rays_from_flat_idx(idx_tiled, W, K, poses_tiled,
                                              remap)
    return dict(rays_o=rays_o, rays_d=rays_d, H=H, W=W, focal=K[0, 0],
                keys=keys)


def render_poses_with_ray_idx(nerf_params, nerf_fine_params, poses, ray_idx,
                              K, H: int, W: int, settings: RenderSettings,
                              keys=None, remap=None, step=None):
    """Every pose (P, 3, 4) sees the same pixel subset ray_idx (R,); rows
    pose-major: [pose0 x all idx, pose1 x all idx, ...]."""
    fam = _pose_family(poses, ray_idx, K, H, W, keys, remap)
    return render_ray_families(nerf_params, nerf_fine_params, [fam],
                               settings, step=step)[0]


def render_pose_families_with_ray_idx(nerf_params, nerf_fine_params,
                                      fam_specs, settings: RenderSettings,
                                      step=None, mesh=None):
    """Training-path rendering of several (poses, ray_idx) families through
    one joint coarse+fine pass. fam_specs: list of dicts {poses (P,3,4),
    ray_idx (R,), K, H, W, keys, remap}. Rows pose-major per family. mesh:
    the step's RayMesh, whose rank's pixels ray_idx are."""
    fams = [
        _pose_family(s["poses"], s["ray_idx"], s["K"], s["H"], s["W"],
                     s.get("keys"), s.get("remap"))
        for s in fam_specs
    ]
    return render_ray_families(nerf_params, nerf_fine_params, fams, settings,
                               step=step, mesh=mesh)
