"""Dataset loaders for the 4+1 formats of the reference (load_data.py;
format matrix in SURVEY.md §2.2), and the scene container.

Port of benerf_tpu/data/datasets.py. Loading is host-side numpy: PNG images
through data/png.py (other image formats through a lazy imageio import),
events from events.npy (BeNeRF_Blender / Unreal), events.pt through
torch.load (E2NeRF_Real), v2e text files (E2NeRF_Synthetic) or an h5 file
(TUM_VIE, lazy h5py). Timestamp normalization follows load_data.py:354-386:
event ts -> [0,1] over the (shifted) event range, the image exposure mapped
into the same unit interval. The returned SceneData holds numpy arrays and
the events on the device (the card unless the caller asks otherwise).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from benerf_tpu_torch.data import events as events_mod
from benerf_tpu_torch.data import png

# Pose recentering and render paths are part of the data-loading surface,
# as in the JAX package.
from benerf_tpu_torch.geometry.camera_paths import (  # noqa: F401
    recenter_poses,
    regenerate_pose,
    spherify_path,
    spiral_path,
)


@dataclass
class SceneData:
    events: events_mod.EventArrays  # normalized ts, sorted, on the device
    image: np.ndarray               # (1, H, W, C) the blurry input
    imgtest: Optional[np.ndarray]   # (1, H, W, C) sharp GT or None
    rgb_exp_ts: np.ndarray          # (2,) normalized exposure [start, end]
    poses: Optional[np.ndarray] = None     # loaded rgb poses (loadpose)
    ev_poses: Optional[np.ndarray] = None  # loaded event poses
    trans: Optional[np.ndarray] = None     # loaded rgb<->event se(3) (loadtrans)
    raw_events: Optional[dict] = None      # un-normalized {x,y,ts,pol} (debug)
    gt_knots: Optional[np.ndarray] = None  # (4,6) GT spline knots (synthetic)
    gt_exp_us: Optional[np.ndarray] = None  # (2,) exposure in GT spline time
    gt_plane_depth: Optional[float] = None  # dominant scene depth


def random_scene(cfg, n_events: int, seed: int = 0, device=None) -> SceneData:
    """A scene of the config's image and event sizes made from a seed:
    `n_events` events of random pixel, time and polarity, and a random
    blurry image (the JAX package's bench.py scene). No ground truth.
    device: where the events live (None: the card, see
    events.prepare)."""
    rng = np.random.default_rng(seed)
    events = events_mod.prepare(
        rng.integers(0, cfg.event_width, n_events),
        rng.integers(0, cfg.event_height, n_events),
        np.sort(rng.random(n_events)).astype(np.float32),
        rng.choice([-1.0, 1.0], n_events), width=cfg.event_width,
        device=device)
    image = rng.random((1, int(cfg.rgb_height), int(cfg.rgb_width),
                        cfg.channels))
    return SceneData(events=events, image=image, imgtest=None,
                     rgb_exp_ts=np.array([0.35, 0.65]))


def _imread(path: str) -> np.ndarray:
    img = png.read(path)
    if img.ndim == 3:
        img = img[..., :3]
    return (img / 255.0).astype(np.float64)


def _list_images(d: str):
    return [
        os.path.join(d, f)
        for f in sorted(os.listdir(d))
        if f.lower().endswith(("jpg", "png"))
    ]


def load_image_stack(datadir: str, sub: str, gray: bool, index: int):
    files = _list_images(os.path.join(datadir, sub))
    img = _imread(files[index])
    if gray:
        if img.ndim == 3:  # tolerate RGB files in gray configs
            img = img @ np.array([0.299, 0.587, 0.114])
        img = img[..., None]
    return img[None]  # (1,H,W,C)


def load_timestamps(datadir: str, cfg):
    """Exposure + (shifted) event range for the selected image
    (load_data.py:89-139): (img_ts_start, img_ts_end, evt_ts_start,
    evt_ts_end) in raw dataset time units."""
    ds = cfg.dataset
    if ds in ("BeNeRF_Blender", "BeNeRF_Unreal"):
        ts = np.loadtxt(os.path.join(datadir, "poses_ts.txt"))
        img_s, img_e = ts[:-1][cfg.index], ts[1:][cfg.index]
    elif ds == "TUM_VIE":
        stamps = np.loadtxt(os.path.join(datadir, "image_timestamps.txt"))
        expos = np.loadtxt(os.path.join(datadir, "image_exposures.txt"))
        img_s = (stamps - 0.5 * expos)[cfg.index]
        img_e = (stamps + 0.5 * expos)[cfg.index]
    elif ds == "E2NeRF_Real":
        # atleast_1d: a single-image scene loads as a 0-d array
        starts = np.atleast_1d(
            np.loadtxt(os.path.join(datadir, "exposure_start_ts.txt")))
        ends = np.atleast_1d(
            np.loadtxt(os.path.join(datadir, "exposure_end_ts.txt")))
        img_s, img_e = starts[cfg.index], ends[cfg.index]
    elif ds == "E2NeRF_Synthetic":
        txt = np.loadtxt(os.path.join(
            datadir, "events", f"r_{cfg.index * 2}", "v2e-dvs-events.txt"))
        img_s = int(txt[0, 0] * 1e19)   # load_data.py:116-119 scale quirk
        img_e = int(txt[-1, 0] * 1e19)
    else:
        raise ValueError(f"cannot load timestamps for dataset {ds!r}")

    evt_s = img_s - cfg.event_shift_start * 1e3  # load_data.py:129-137
    evt_e = img_e + cfg.event_shift_end * 1e3
    return img_s, img_e, evt_s, evt_e


def _load_tum_vie_events(path: str, evt_ts_start, evt_ts_end):
    import h5py

    with h5py.File(path, "r") as f:
        g = f["events"]
        t = g["t"]
        # chunked range scan (the file can be huge), load_data.py:328-351
        chunk = 500_000
        parts = []
        for i in range(0, len(t), chunk):
            tt = t[i:i + chunk]
            sel = np.where((tt >= evt_ts_start) & (tt <= evt_ts_end))[0]
            if len(sel):
                parts.append((i + sel[0], i + sel[-1] + 1))
        if not parts:
            raise ValueError(f"{path}: no events in [{evt_ts_start}, "
                             f"{evt_ts_end}]")
        lo, hi = parts[0][0], parts[-1][1]
        ev = np.stack([g["x"][lo:hi], g["y"][lo:hi], g["t"][lo:hi],
                       g["p"][lo:hi]], axis=-1).astype(np.float64)
    # 0 means negative polarity in TUM-VIE (model/nerf.py:194-196)
    ev[:, 3] = np.where(ev[:, 3] == 0, -1.0, ev[:, 3])
    return ev


def load_events_raw(datadir: str, cfg, evt_ts_start, evt_ts_end):
    """Raw event table (N,4) [x, y, t, p] cropped to the shifted range
    (load_data.py:292-351)."""
    ds = cfg.dataset
    eventdir = os.path.join(datadir, "events")
    if ds in ("BeNeRF_Blender", "BeNeRF_Unreal", "E2NeRF_Real"):
        if ds == "E2NeRF_Real":
            import torch

            ev = torch.load(os.path.join(eventdir, "events.pt"),
                            map_location="cpu").numpy()
        else:
            ev = np.load(os.path.join(eventdir, "events.npy"))
        keep = (ev[:, 2] >= evt_ts_start) & (ev[:, 2] <= evt_ts_end)
        return ev[keep]
    if ds == "E2NeRF_Synthetic":
        txt = np.loadtxt(os.path.join(eventdir, f"r_{cfg.index * 2}",
                                      "v2e-dvs-events.txt"))  # rows [t, x, y, p]
        return np.stack(
            [txt[:, 1], txt[:, 2], txt[:, 0] * 1e19, 2.0 * txt[:, 3] - 1.0],
            axis=-1,
        )  # load_data.py:308-317 (t scaled, p -> +-1)
    if ds == "TUM_VIE":
        return _load_tum_vie_events(os.path.join(eventdir, "events.h5"),
                                    evt_ts_start, evt_ts_end)
    raise ValueError(f"unknown dataset {ds!r}")


def load_scene(datadir: str, cfg, device=None) -> SceneData:
    """Full scene load (reference load_data(), load_data.py:262-388), the
    events on `device` (None: the card; raises without one)."""
    datadir = os.path.expanduser(datadir)
    gray = cfg.channels == 1
    has_gt = cfg.dataset in ("BeNeRF_Blender", "BeNeRF_Unreal",
                             "E2NeRF_Synthetic")

    image = load_image_stack(datadir, "images", gray, cfg.index)
    imgtest = (load_image_stack(datadir, "images_test", gray, cfg.index)
               if has_gt else None)

    img_s, img_e, evt_s, evt_e = load_timestamps(datadir, cfg)
    ev = load_events_raw(datadir, cfg, evt_s, evt_e)
    event_arrays = events_mod.prepare_raw(
        ev[:, 0], ev[:, 1], ev[:, 2], ev[:, 3], width=cfg.event_width,
        t_lo=evt_s, t_hi=evt_e, device=device)

    rgb_exp_ts = np.array(
        [(img_s - evt_s) / (evt_e - evt_s), (img_e - evt_s) / (evt_e - evt_s)],
        np.float32,
    )  # load_data.py:384-386

    # ground-truth trajectory sidecar: written by the synthetic scene
    # writers only; enables the in-train pose-recovery metrics
    gt_knots = gt_exp_us = gt_plane_depth = None
    gt_path = os.path.join(datadir, "gt_trajectory.npz")
    if os.path.exists(gt_path):
        with np.load(gt_path) as gt:
            gt_knots = gt["knots"].astype(np.float32)
            t0, t1 = float(gt["t_lo"]), float(gt["t_hi"])
            if "plane_depth" in gt:
                gt_plane_depth = float(gt["plane_depth"])
        gt_exp_us = np.array(
            [(img_s - t0) / (t1 - t0), (img_e - t0) / (t1 - t0)], np.float32)

    poses = ev_poses = trans = None
    if cfg.loadpose:
        poses, ev_poses = _load_camera_poses(
            datadir, image.shape[1], image.shape[2],
            cubic="cubic" in cfg.model, index=cfg.index)
    elif cfg.loadtrans:
        trans = np.load(os.path.join(datadir, "trans.npy")).astype(np.float32)

    return SceneData(
        events=event_arrays, image=image, imgtest=imgtest,
        rgb_exp_ts=rgb_exp_ts, poses=poses, ev_poses=ev_poses, trans=trans,
        gt_knots=gt_knots, gt_exp_us=gt_exp_us, gt_plane_depth=gt_plane_depth,
    )


def _load_camera_poses(datadir, H, W, cubic, index):
    """poses_bounds(_events).npy loading + recentering (load_data.py:58-82,
    366-377)."""
    suffix = "_cubic" if cubic else ""
    poses_arr = np.load(os.path.join(datadir, f"poses_bounds{suffix}.npy"))
    ev_arr = np.load(os.path.join(datadir, f"poses_bounds{suffix}_events.npy"))

    def unpack(arr):
        p = arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
        p[:2, 4, :] = np.array([H, W]).reshape([2, 1])
        p = np.concatenate([p[:, 1:2, :], -p[:, 0:1, :], p[:, 2:, :]], 1)
        return np.moveaxis(p, -1, 0).astype(np.float32)

    poses, ev_poses = unpack(poses_arr), unpack(ev_arr)
    n = 4 if cubic else 2
    both = np.concatenate(
        (poses[index:index + 2], ev_poses[index:index + 2]), axis=0)
    both = recenter_poses(both)
    return both[0:n], both[n:2 * n]
