"""Event-stream operations: windowing + polarity accumulation (ETA maps).

Port of benerf_tpu/data/events.py (reference model/nerf.py:160-205 and
utils/event_utils.py:246-276): per train iteration a contiguous window of
the normalized-time stream is selected, by TIME or by COUNT; the window's
polarities are scatter-added into an (H*W,) "ETA" map with index_add_ on
the device; the window's (start, end) times parameterize the spline poses.
Windows are built on the device from index arithmetic (no .item() sync).
Raw ingest goes through the port's copy of the JAX package's host C++
engine (data/_native.py, csrc/events.cpp); the other host-side helpers (the
TUM-VIE h5 slicer, visualization and the accumulation oracle) are numpy, as
in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benerf_tpu_torch import resolve_device
from benerf_tpu_torch.data import _native


class EventArrays(NamedTuple):
    """Device-resident, time-sorted event stream (normalized ts in [0,1])."""

    pix_idx: torch.Tensor  # (N,) int64 = y * W + x
    ts: torch.Tensor       # (N,) float
    pol: torch.Tensor      # (N,) float (+-1 typically)

    @property
    def num(self) -> int:
        return self.pix_idx.shape[0]


def prepare(x, y, ts, pol, width: int, device=None,
            dtype=torch.float32) -> EventArrays:
    """Host-side: sort by time, flatten pixels, move to `device` (None: the
    card, see resolve_device). ts must already be in [0,1]."""
    device = resolve_device(device)
    ts = np.asarray(ts)
    order = np.argsort(ts, kind="stable")
    pix = np.asarray(y).astype(np.int64) * width + np.asarray(x).astype(np.int64)
    return EventArrays(
        pix_idx=torch.as_tensor(pix[order], device=device),
        ts=torch.as_tensor(ts[order], device=device, dtype=dtype),
        pol=torch.as_tensor(np.asarray(pol)[order], device=device, dtype=dtype),
    )


def prepare_raw(x, y, t_raw, pol, width: int, t_lo: float, t_hi: float,
                device=None) -> EventArrays:
    """One-pass ingest of a RAW stream through the host C++ engine
    (_native.prepare_events: crop to [t_lo, t_hi], normalize time to [0,1]
    over that range, flatten, stable time-sort, in float64), then move to
    `device` (None: the card, see resolve_device)."""
    device = resolve_device(device)
    pix, ts, pp = _native.prepare_events(x, y, t_raw, pol, width, t_lo, t_hi)
    return EventArrays(
        pix_idx=torch.as_tensor(pix.astype(np.int64), device=device),
        ts=torch.as_tensor(ts, device=device),
        pol=torch.as_tensor(pp, device=device),
    )


def _scatter(pol, pix, hw):
    return torch.zeros(hw, device=pol.device, dtype=pol.dtype).index_add_(
        0, pix, pol)


def accumulate_all(events: EventArrays, hw: int):
    """Scatter-add every event's polarity into a flat (H*W,) map."""
    return _scatter(events.pol, events.pix_idx, hw)


def _as_scalar(t, like):
    return torch.as_tensor(t, device=like.device, dtype=like.dtype).reshape(1)


def eta_time_window(events: EventArrays, hw: int, low_t, up_t, cap: int = 0):
    """ETA map for the events with low_t <= ts <= up_t (inclusive ends).

    cap == 0: mask the full stream + one scatter (O(N)).
    cap > 0: the stream is time-sorted, so searchsorted finds the window
    start and a fixed `cap` events from there (start clamped to N - cap) are
    masked and scattered. Exact while no window holds more than `cap` events;
    returns (eta, overflow) where overflow counts dropped events.
    """
    ts = events.ts
    low = _as_scalar(low_t, ts)
    up = _as_scalar(up_t, ts)
    if cap and cap < events.num:
        lo = torch.searchsorted(ts, low)
        start = torch.clamp(lo, max=events.num - cap)
        idx = start + torch.arange(cap, device=ts.device)
        w_ts = ts[idx]
        pix, pol = events.pix_idx[idx], events.pol[idx]
        mask = (w_ts >= low) & (w_ts <= up)
        hi = torch.searchsorted(ts, up, right=True)
        overflow = torch.clamp(hi - lo - cap, min=0)[0]
    else:
        pix, pol = events.pix_idx, events.pol
        mask = (ts >= low) & (ts <= up)
        overflow = torch.zeros((), dtype=torch.int64, device=ts.device)
    return _scatter(pol * mask.to(pol.dtype), pix, hw), overflow


def window_cap(ts_sorted, window_len: float, *, grid: int = 4096,
               safety: float = 1.10, round_to: int = 1024) -> int:
    """Static upper bound on events inside ANY time window of `window_len`
    (host-side numpy, for eta_time_window(cap=...)): over-cover each grid
    cell by one spacing, apply a safety factor, round up."""
    ts = np.asarray(ts_sorted)
    n = ts.shape[0]
    if n == 0 or window_len >= 1.0:
        return n
    lows = np.linspace(0.0, 1.0 - window_len, grid)
    delta = lows[1] - lows[0] if grid > 1 else 0.0
    lo = np.searchsorted(ts, lows, side="left")
    hi = np.searchsorted(ts, lows + window_len + delta, side="right")
    m = int(np.ceil(int((hi - lo).max()) * safety))
    m = ((m + round_to - 1) // round_to) * round_to
    return min(m, n)


def sample_time_window(generator, window_len: float,
                       random_placement: bool = True, device=None):
    """Window [low, low+window_len] on the unit interval, as 0-d tensors on
    `device` (None: the generator's).

    random_placement: low ~ U(0, 1-window_len); else low = k*window_len with
    k ~ U{0..(1-w)//w - 1} (reference model/nerf.py:165-169).
    """
    if device is None:
        device = generator.device
    if random_placement:
        low = torch.rand((), generator=generator, device=device) * (1.0 - window_len)
    else:
        n_slots = int((1.0 - window_len) // window_len)
        k = torch.randint(0, max(n_slots, 1), (), generator=generator,
                          device=device)
        low = k.to(torch.float32) * window_len
    return low, torch.clamp(low + window_len, max=1.0)


def eta_count_window(events: EventArrays, hw: int, generator, frac: float,
                     random_placement: bool = True):
    """COUNT-mode window: a contiguous slice of round(N*frac) events.
    Returns (eta, t_start, t_end)."""
    n = events.num
    n_window = int(round(n * frac))
    dev = events.ts.device
    if random_placement:
        start = torch.randint(0, max(n - n_window, 1), (), generator=generator,
                              device=dev)
    else:
        n_slots = max((n - n_window) // max(n_window, 1), 1)
        start = torch.randint(0, n_slots, (), generator=generator,
                              device=dev) * n_window
    idx = start + torch.arange(n_window, device=dev)
    ts = events.ts[idx]
    eta = _scatter(events.pol[idx], events.pix_idx[idx], hw)
    return eta, ts[0], ts[n_window - 1]


class EventSlicer:
    """Time-window access into a TUM-VIE-format event h5 file (an open
    h5py.File; h5py stays the caller's import).

    File layout: groups events/{p,x,y,t} plus an ms_to_idx array mapping
    milliseconds to event indices such that t[ms_to_idx[ms]] >= ms*1000 and
    t[ms_to_idx[ms]-1] < ms*1000, with optional t_offset (reference
    utils/event_utils.py:11-102). The conservative ms window is refined
    with searchsorted over the in-window slice.
    """

    def __init__(self, h5f):
        self.h5f = h5f
        self.events = {k: h5f[f"events/{k}"] for k in ("p", "x", "y", "t")}
        self.ms_to_idx = np.asarray(h5f["ms_to_idx"], dtype="int64")
        self.t_offset = int(h5f["t_offset"][()]) if "t_offset" in h5f else 0
        self.t_final = int(self.events["t"][-1]) + self.t_offset

    def get_start_time_us(self) -> int:
        return self.t_offset

    def get_final_time_us(self) -> int:
        return self.t_final

    def ms2idx(self, t_ms: int):
        if t_ms < 0 or t_ms >= len(self.ms_to_idx):
            return None
        return int(self.ms_to_idx[t_ms])

    def get_events(self, t_start_us: int, t_end_us: int):
        """{p,x,y,t} arrays with t_start_us <= t < t_end_us, or None when
        the window leaves the recording."""
        if t_start_us >= t_end_us:
            raise ValueError(f"empty window [{t_start_us}, {t_end_us})")
        t_start_us -= self.t_offset
        t_end_us -= self.t_offset
        lo_idx = self.ms2idx(math.floor(t_start_us / 1000))
        hi_idx = self.ms2idx(math.ceil(t_end_us / 1000))
        if lo_idx is None or hi_idx is None:
            return None
        t_cons = np.asarray(self.events["t"][lo_idx:hi_idx])
        a = int(np.searchsorted(t_cons, t_start_us, side="left"))
        b = int(np.searchsorted(t_cons, t_end_us, side="left"))
        out = {"t": t_cons[a:b] + self.t_offset}
        for k in ("p", "x", "y"):
            out[k] = np.asarray(self.events[k][lo_idx + a:lo_idx + b])
        return out


def polarity_image(x, y, pol, height: int, width: int) -> np.ndarray:
    """(H, W, 3) uint8 visualization: positive events red, negative blue, on
    white (reference event_data_visualization, event_utils.py:228-244)."""
    img = np.full((height, width, 3), 255, np.uint8)
    x = np.asarray(x, np.int64)
    y = np.asarray(y, np.int64)
    pos = np.asarray(pol) > 0
    img[y[pos], x[pos]] = (255, 0, 0)
    img[y[~pos], x[~pos]] = (0, 0, 255)
    return img


def accumulate_events_numpy(x, y, pol, height: int, width: int):
    """Host-side scatter-add of polarities into an (H, W) float64 map (tests,
    visualization, the motion-scale pose init); reference
    accumulate_events_no_numba (event_utils.py:276-279)."""
    out = np.zeros((height, width), np.float64)
    np.add.at(out, (np.asarray(y, np.int64), np.asarray(x, np.int64)), pol)
    return out
