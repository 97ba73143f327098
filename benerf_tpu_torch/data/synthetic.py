"""Synthetic BeNeRF-format scene generator.

The port's copy of benerf_tpu/data/synthetic.py: numpy, as there, except
the spline poses, which come from the port's geometry/spline on CPU float32
tensors (the JAX writer evaluates its float32 jax.numpy spline), and the
PNGs, which data/png.py writes.

No dataset ships with this container, so tests, benchmarks, and end-to-end
demos generate a physically consistent miniature scene: an analytic radiance
field (a sinusoid-textured back wall plus opaque Gaussian blobs) volume-
rendered along a known cubic-B-spline camera trajectory; the blurry input
image is the exposure-time average and the event stream is ESIM-style
per-pixel log-intensity threshold crossings between consecutive virtual
frames.

The wall texture is band-limited (sums of sinusoids) so the scene carries
real high-frequency content: the exposure average is *measurably* blurry
(target pixel sweep is calibrated — see `write_benerf_blender_scene`'s
`target_blur_px`), edges fire plentiful events, and a NeRF with standard
positional encoding can represent it. This is what makes deblurring PSNR a
meaningful recovery metric rather than a no-op.

`write_benerf_blender_scene` serializes it in the exact on-disk layout of the
BeNeRF_Blender datasets (images/*.png + images_test/*.png + events/events.npy
rows [x,y,t,p] + poses_ts.txt; reference load_data.py:12-28,92-96,
295-299), so the real dataset loaders are exercised end-to-end.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

import torch

from benerf_tpu_torch.data import png
from benerf_tpu_torch.geometry import spline as spline_mod


def _spline_poses(knots, us) -> np.ndarray:
    """(T, 3, 4) float32 poses of the cubic spline at times `us`, on CPU
    float32 tensors."""
    return spline_mod.cubic_bspline_pose(
        torch.as_tensor(np.asarray(knots), dtype=torch.float32),
        torch.as_tensor(np.asarray(us), dtype=torch.float32)).numpy()


@dataclass
class BlobScene:
    # foreground occluders
    centers: np.ndarray    # (K,3)
    scales: np.ndarray     # (K,)
    colors: np.ndarray     # (K,3)
    densities: np.ndarray  # (K,)
    # textured back wall (the high-frequency content)
    wall_z: float = -4.0
    wall_thickness: float = 0.07
    wall_density: float = 45.0
    wall_base: np.ndarray = field(default_factory=lambda: np.full(3, 0.55))
    wall_freqs: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    wall_phases: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    wall_amps: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    background: np.ndarray = field(default_factory=lambda: np.zeros(3))


def make_scene(seed: int = 0, n_blobs: int = 8, n_waves: int = 3,
               freq_scale: float = 1.0) -> BlobScene:
    """Opaque foreground blobs in front of a sinusoid-textured wall.

    Wave frequencies target a ~8-16 px period at the demo focal length
    (focal 90, wall depth 4 -> ~0.044 world units / px), i.e. content the
    blur sweep visibly destroys but PE(L=10) easily represents.

    freq_scale: multiply the wall frequencies — at production focal
    lengths (e.g. tanabata's 541.85) pass ~focal/90 so the texture period
    stays 8-16 *pixels* and the blur sweep destroys comparable content
    (otherwise the blurry input of a long-focal scene is unrealistically
    sharp: 42 dB at 15 px blur in PROTOCOL_r05).
    """
    rng = np.random.default_rng(seed)
    centers = np.stack(
        [
            rng.uniform(-1.2, 1.2, n_blobs),
            rng.uniform(-0.9, 0.9, n_blobs),
            rng.uniform(-3.6, -2.3, n_blobs),
        ],
        axis=-1,
    )
    scales = rng.uniform(0.10, 0.28, n_blobs)
    colors = rng.uniform(0.15, 1.0, (n_blobs, 3))
    densities = rng.uniform(25.0, 60.0, n_blobs)

    freqs = freq_scale * rng.uniform(9.0, 18.0, (n_waves, 2)) * rng.choice(
        [-1.0, 1.0], (n_waves, 2)
    )
    phases = rng.uniform(0.0, 2 * np.pi, (n_waves, 2))
    amps = rng.uniform(0.08, 0.16, (n_waves, 1)) * rng.uniform(
        0.6, 1.0, (n_waves, 3)
    )
    return BlobScene(
        centers, scales, colors, densities,
        wall_freqs=freqs, wall_phases=phases, wall_amps=amps,
    )


def wall_texture(scene: BlobScene, x, y):
    """(..., 3) albedo of the wall at world (x, y)."""
    tex = np.broadcast_to(
        scene.wall_base, np.shape(x) + (3,)
    ).astype(np.float64).copy()
    for m in range(len(scene.wall_freqs)):
        fx, fy = scene.wall_freqs[m]
        px, py = scene.wall_phases[m]
        tex = tex + scene.wall_amps[m] * (
            np.sin(fx * x + px) * np.sin(fy * y + py)
        )[..., None]
    return np.clip(tex, 0.02, 1.0)


def field_at(scene: BlobScene, pts: np.ndarray):
    """sigma (..., ) and rgb (..., 3) of the analytic field at pts (..., 3)."""
    d2 = np.sum(
        (pts[..., None, :] - scene.centers) ** 2, axis=-1
    )  # (..., K)
    g = np.exp(-0.5 * d2 / scene.scales**2)  # (..., K)
    sigma = np.sum(scene.densities * g, axis=-1)

    g_wall = np.exp(
        -0.5 * ((pts[..., 2] - scene.wall_z) / scene.wall_thickness) ** 2
    )
    sigma = sigma + scene.wall_density * g_wall
    tex = wall_texture(scene, pts[..., 0], pts[..., 1])

    wsum = np.sum(g, axis=-1, keepdims=True) + g_wall[..., None] + 1e-9
    rgb = (g @ scene.colors + g_wall[..., None] * tex) / wsum
    return sigma, np.clip(rgb, 0.0, 1.0)


def render_frame(scene, pose, H, W, K, n_samples=160, near=1.0, far=8.0,
                 row_chunk=64):
    """Reference-convention volume render of the analytic field (numpy).

    pose: (3,4) camera-to-world, OpenGL-style look-down--z like the training
    renderer (render/rays.py). Rows are processed in chunks: field_at
    broadcasts a (rows, W, S, K, 3) float64 intermediate, which at
    production resolutions (600x400x160) would be ~15 GB per op unchunked.
    """
    i, j = np.meshgrid(np.arange(W), np.arange(H))
    dirs = np.stack(
        [(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1], -np.ones_like(i)],
        axis=-1,
    )  # (H,W,3)
    rays_d_full = dirs @ pose[:3, :3].T
    rays_o = pose[:3, 3]

    z = np.linspace(near, far, n_samples)
    dz_base = np.diff(z, append=z[-1] + (z[-1] - z[-2]))

    out = np.empty((H, W, 3))
    for r0 in range(0, H, row_chunk):
        rays_d = rays_d_full[r0 : r0 + row_chunk]
        pts = rays_o + rays_d[..., None, :] * z[:, None]  # (h,W,S,3)
        sigma, rgb = field_at(scene, pts)
        dz = dz_base * np.linalg.norm(rays_d, axis=-1)[..., None]
        alpha = 1.0 - np.exp(-sigma * dz)
        trans = np.cumprod(1.0 - alpha + 1e-10, axis=-1)
        trans = np.concatenate(
            [np.ones_like(trans[..., :1]), trans[..., :-1]], -1
        )
        w = alpha * trans
        out[r0 : r0 + row_chunk] = np.sum(w[..., None] * rgb, axis=-2)
    return np.clip(out, 0.0, 1.0)


def lin_log_np(gray01, thres: float = 20.0):
    """E2NeRF sensor response: linear below thres (0..255 scale), log above
    (reference utils/math_utils.py:7-16). gray01 in [0,1]."""
    c = gray01 * 255.0
    lin_slope = np.log(thres + 1e-9) / thres
    return np.where(c < thres, lin_slope * c, np.log(c + 1e-9))


def events_from_frames(frames, t_lo, t_hi, threshold=0.1, eps=1e-9, seed=0,
                       brightness="log"):
    """ESIM-style event synthesis from a frame stack (F,H,W,3).

    Per pixel, events fire whenever the brightness signal crosses multiples
    of the threshold from a per-pixel reference level; timestamps land
    uniformly inside each inter-frame interval. Returns (N,4) [x,y,t,p],
    unsorted (callers sort by t).

    brightness: "log" (BeNeRF_* sensor model, safe_log) or "lin_log"
    (E2NeRF_* sensor model — matches the loss's brightness map so the
    synthesized events are physically consistent with the lin_log loss
    branch, reference train.py:230-262).
    """
    rng = np.random.default_rng(seed)
    gray = frames @ np.array([0.299, 0.587, 0.114])
    if brightness == "lin_log":
        logi = lin_log_np(gray)
    else:
        logi = np.log(gray + eps)
    F = logi.shape[0]
    times = np.linspace(t_lo, t_hi, F)
    ref = logi[0].copy()
    out = []
    for f in range(1, F):
        delta = logi[f] - ref
        n = np.floor(np.abs(delta) / threshold).astype(int)
        ys, xs = np.nonzero(n)
        if len(ys) == 0:
            continue
        cnts = n[ys, xs]
        pols = np.sign(delta[ys, xs])
        xs_r = np.repeat(xs, cnts).astype(np.float64)
        ys_r = np.repeat(ys, cnts).astype(np.float64)
        pol_r = np.repeat(pols, cnts)
        tt = rng.uniform(times[f - 1], times[f], len(xs_r))
        out.append(np.stack([xs_r, ys_r, tt, pol_r], axis=-1))
        ref[ys, xs] += pols * cnts * threshold
    if not out:
        return np.zeros((0, 4))
    return np.concatenate(out, axis=0)


def make_trajectory(seed=0, rot_scale=0.05, trans_scale=0.01):
    """Random smooth se(3) knots [w|u] (the GT trajectory to recover).

    Rotation-dominant by construction: real exposure-time camera shake is
    fractions of a degree to a few degrees of rotation with millimetre
    translation. (An earlier version used trans_scale=0.25, which — after
    the pixel-sweep calibration in `calibrated_trajectory` rescaled it —
    produced multi-unit translation arcs whose image motion was cancelled
    by compensating rotation: a screw trajectory no optimizer starting at
    zero could recover, and no real camera produces.)
    """
    rng = np.random.default_rng(seed)
    scales = np.array([rot_scale] * 3 + [trans_scale] * 3)
    base = rng.normal(size=(1, 6))
    deltas = np.cumsum(rng.normal(size=(4, 6)), axis=0)
    return ((base + deltas) * scales).astype(np.float32)


def _pixel_sweep(knots, K, wall_z, n_images, n_samples=9):
    """Max image-plane displacement (px) of wall points within ONE exposure."""
    xs = np.linspace(-0.8, 0.8, 4)
    grid = np.stack(np.meshgrid(xs, xs), -1).reshape(-1, 2)
    pts3 = np.concatenate(
        [grid, np.full((len(grid), 1), wall_z)], axis=-1
    )  # (N,3)
    worst = 0.0
    for i in range(n_images):
        us = np.linspace(i / n_images, (i + 1) / n_images, n_samples)
        poses = _spline_poses(knots, us)
        uv = []
        for p in poses:
            pc = (pts3 - p[:3, 3]) @ p[:3, :3]  # world -> camera
            z = np.maximum(-pc[:, 2], 1e-6)
            uv.append(
                np.stack(
                    [K[0, 0] * pc[:, 0] / z, K[1, 1] * pc[:, 1] / z], axis=-1
                )
            )
        uv = np.stack(uv)  # (S,N,2)
        d = np.ptp(uv, axis=0)  # (N,2) per-point sweep
        worst = max(worst, float(np.hypot(d[:, 0], d[:, 1]).max()))
    return worst


def calibrated_trajectory(seed, K, wall_z=-4.0, n_images=1,
                          target_blur_px=6.0, rot_scale=0.05,
                          trans_scale=0.01):
    """Knots rescaled so the worst single-exposure pixel sweep ~ target_blur_px.

    Random-walk knot shapes give a different trajectory per seed; rescaling
    the whole se(3) vector (rotation AND translation contribute blur) pins the
    *magnitude* so quality metrics are comparable across seeds. Two fixpoint
    passes converge to ~1% (exp of a scaled tangent is near-linear here).
    The rot/trans ratio keeps the shake rotation-dominant (see
    make_trajectory) so the calibrated magnitude stays physically plausible
    and within optimization reach of the near-zero reference init.
    """
    knots = make_trajectory(seed, rot_scale=rot_scale,
                            trans_scale=trans_scale)
    for _ in range(2):
        sweep = _pixel_sweep(knots, K, wall_z, n_images)
        if sweep < 1e-9:
            break
        knots = (knots * (target_blur_px / sweep)).astype(np.float32)
    return knots


def _generate_scene_core(
    outdir, H, W, focal, n_virtual, threshold, seed, n_images,
    target_blur_px, brightness="log", wall_freq_scale=1.0,
):
    """Shared generation for all on-disk formats: render virtual frames
    along the calibrated GT spline, write blurry inputs + sharp GT PNGs,
    synthesize events. Returns (gt dict, events (N,4) [x,y,t,p] sorted by t,
    ts (n_images+1,))."""
    scene = make_scene(seed, freq_scale=wall_freq_scale)
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float64)
    knots = calibrated_trajectory(
        seed, K, wall_z=scene.wall_z, n_images=n_images,
        target_blur_px=target_blur_px,
    )

    ts = np.linspace(0.0, 1000.0 * n_images, n_images + 1)

    os.makedirs(os.path.join(outdir, "images"), exist_ok=True)
    os.makedirs(os.path.join(outdir, "images_test"), exist_ok=True)
    os.makedirs(os.path.join(outdir, "events"), exist_ok=True)

    all_events = []
    gt = {"scene": scene, "knots": knots, "K": K, "poses_ts": ts}
    for idx in range(n_images):
        u_lo = idx / n_images
        u_hi = (idx + 1) / n_images
        us = np.linspace(u_lo, u_hi, n_virtual)
        poses = _spline_poses(knots, us)
        frames = np.stack(
            [render_frame(scene, p, H, W, K) for p in poses], axis=0
        )
        blurry = frames.mean(axis=0)
        sharp = frames[len(frames) // 2]
        png.write(os.path.join(outdir, "images", f"{idx:03d}.png"),
                  (np.clip(blurry, 0, 1) * 255).astype(np.uint8))
        png.write(os.path.join(outdir, "images_test", f"{idx:03d}.png"),
                  (np.clip(sharp, 0, 1) * 255).astype(np.uint8))
        ev = events_from_frames(frames, ts[idx], ts[idx + 1], threshold,
                                seed=seed + idx, brightness=brightness)
        if len(ev):
            all_events.append(ev)
        gt[f"frames_{idx}"] = frames

    events = (
        np.concatenate(all_events, axis=0)
        if all_events
        else np.zeros((0, 4))
    )
    events = events[events[:, 2].argsort()]
    return gt, events, ts


def _write_gt_sidecars(outdir, gt, ts, events, meta):
    """gt_trajectory.npz + scene_meta.json (shared by all formats)."""
    import json

    np.savez(
        os.path.join(outdir, "gt_trajectory.npz"),
        knots=gt["knots"],
        t_lo=np.float64(ts[0]),
        t_hi=np.float64(ts[-1]),
        plane_depth=np.float64(abs(gt["scene"].wall_z)),
    )
    meta = dict(meta)
    meta["n_events"] = int(len(events))
    with open(os.path.join(outdir, "scene_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)


def write_benerf_blender_scene(
    outdir: str,
    H: int = 80,
    W: int = 80,
    focal: float = 90.0,
    n_virtual: int = 17,
    threshold: float = 0.1,
    seed: int = 0,
    n_images: int = 2,
    target_blur_px: float = 6.0,
    wall_freq_scale: float = 1.0,
):
    """Write a BeNeRF_Blender-format scene directory; returns ground truth.

    Timeline: poses_ts.txt has n_images+1 stamps (ms-style units); image i's
    exposure spans [ts[i], ts[i+1]] (load_data.py:92-96). The camera follows
    a cubic spline over the whole timeline whose magnitude is calibrated so
    each exposure sweeps ~target_blur_px pixels of image motion.
    """
    gt, events, ts = _generate_scene_core(
        outdir, H, W, focal, n_virtual, threshold, seed, n_images,
        target_blur_px, brightness="log", wall_freq_scale=wall_freq_scale,
    )
    np.save(os.path.join(outdir, "events", "events.npy"), events)
    np.savetxt(os.path.join(outdir, "poses_ts.txt"), ts)
    # Ground-truth trajectory + provenance sidecars (synthetic scenes only;
    # real datasets have neither — see datasets.load_scene)
    _write_gt_sidecars(outdir, gt, ts, events, {
        "scene_format_version": 2,
        "format": "BeNeRF_Blender",
        "seed": seed, "H": H, "W": W, "focal": focal,
        "n_images": n_images, "n_virtual": n_virtual,
        "event_threshold": threshold,
        "target_blur_px": target_blur_px,
        "wall_freq_scale": wall_freq_scale,
    })
    return gt


def write_e2nerf_synthetic_scene(
    outdir: str,
    H: int = 80,
    W: int = 80,
    focal: float = 90.0,
    n_virtual: int = 17,
    threshold: float = 0.2,
    seed: int = 0,
    target_blur_px: float = 6.0,
    index: int = 0,
):
    """Write an E2NeRF_Synthetic-format scene; returns ground truth.

    On-disk contract (reference load_data.py:112-119,308-317): events live
    in events/r_{2*index}/v2e-dvs-events.txt rows [t, x, y, p] with p in
    {0,1} and t in units where t*1e19 is the raw timestamp; the exposure
    interval is the first..last event time of that same file (no
    poses_ts.txt). Events are synthesized in lin_log brightness space with
    the E2NeRF contrast threshold 0.2 so they are physically consistent
    with the lin_log loss branch (train.py:230-262, math_utils.py:7-16).
    """
    gt, events, ts = _generate_scene_core(
        outdir, H, W, focal, n_virtual, threshold, seed, n_images=1,
        target_blur_px=target_blur_px, brightness="lin_log",
    )
    evdir = os.path.join(outdir, "events", f"r_{2 * index}")
    os.makedirs(evdir, exist_ok=True)
    # rows [t, x, y, p]: t scaled so loader's t*1e19 recovers ms-style
    # stamps; p stored {0,1} (loader maps 2p-1)
    rows = np.stack(
        [events[:, 2] / 1e19, events[:, 0], events[:, 1],
         (events[:, 3] > 0).astype(np.float64)],
        axis=-1,
    )
    np.savetxt(os.path.join(evdir, "v2e-dvs-events.txt"), rows,
               fmt="%.18e %d %d %d")
    _write_gt_sidecars(outdir, gt, ts, events, {
        "scene_format_version": 2,
        "format": "E2NeRF_Synthetic",
        "seed": seed, "H": H, "W": W, "focal": focal,
        "n_images": 1, "n_virtual": n_virtual,
        "event_threshold": threshold,
        "target_blur_px": target_blur_px,
        "brightness": "lin_log",
    })
    return gt


def write_e2nerf_real_scene(
    outdir: str,
    H: int = 80,
    W: int = 80,
    focal: float = 90.0,
    n_virtual: int = 17,
    threshold: float = 0.2,
    seed: int = 0,
    target_blur_px: float = 6.0,
):
    """Write an E2NeRF_Real-format scene; returns ground truth.

    On-disk contract (reference load_data.py:106-110,301-306): events as a
    torch tensor events/events.pt rows [x, y, t, p] (p ±1), exposure bounds
    in exposure_start_ts.txt / exposure_end_ts.txt. The real-data loss
    branch is threshold -1 (L2-normalized event loss, train.py:263-296);
    the events themselves are synthesized in lin_log space at a nominal
    contrast threshold (the loss never sees it — only directions). The
    sharp GT (images_test/) and gt_trajectory.npz are generator sidecars
    the real datasets lack; loaders ignore images_test for E2NeRF_Real and
    the quality harness reads it directly.
    """
    gt, events, ts = _generate_scene_core(
        outdir, H, W, focal, n_virtual, threshold, seed, n_images=1,
        target_blur_px=target_blur_px, brightness="lin_log",
    )
    torch.save(torch.from_numpy(events.astype(np.float64)),
               os.path.join(outdir, "events", "events.pt"))
    np.savetxt(os.path.join(outdir, "exposure_start_ts.txt"),
               np.array([ts[0]]))
    np.savetxt(os.path.join(outdir, "exposure_end_ts.txt"),
               np.array([ts[-1]]))
    _write_gt_sidecars(outdir, gt, ts, events, {
        "scene_format_version": 2,
        "format": "E2NeRF_Real",
        "seed": seed, "H": H, "W": W, "focal": focal,
        "n_images": 1, "n_virtual": n_virtual,
        "event_threshold": threshold,
        "target_blur_px": target_blur_px,
        "brightness": "lin_log",
    })
    return gt
