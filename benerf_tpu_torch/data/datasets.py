"""Scene data container.

Port of the SceneData dataclass of benerf_tpu/data/datasets.py. The loaders
of the on-disk formats are not ported yet; callers build a SceneData in
memory, or take `random_scene`'s from a seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from benerf_tpu_torch.data import events as events_mod


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
