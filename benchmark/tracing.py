"""What the device did, read from a torch.profiler trace on the card.

`profiled(fn)` runs fn under the profiler (host and CUDA activities) and
returns a Profile: the wall seconds of the call (host clock, ending in a
synchronise), the device's busy seconds (the union of its kernel and copy
intervals), its launches, its kernels by name, and its idle gaps, each
named by the innermost host operation that was running at the gap's
start. The device spans of user annotations are left out: the kernels
under them are counted themselves.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

TOP_GAPS = 10


@dataclass
class Profile:
    wall_s: float
    busy_s: float = 0.0
    launches: int = 0
    kernels: list = field(default_factory=list)   # [(name, launches, s)]
    gaps: list = field(default_factory=list)      # [(host op, s)]

    def seconds_of(self, match) -> float:
        return sum(s for name, _, s in self.kernels if match(name))

    def breakdown(self, top=10) -> dict:
        return {"device_ops": [[n, s] for n, _, s in self.kernels[:top]],
                "idle_gaps": [[n, s] for n, s in self.gaps[:top]]}


def _is_device(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and "#" not in e.name)


def profiled(fn, device) -> tuple:
    """(fn's result, Profile of the call). On a CPU device the profile has
    the wall time alone."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    return out, read(prof, wall)


def read(prof, wall_s) -> Profile:
    events = list(prof.events())
    dev = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in events if _is_device(e)))
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    by_name = defaultdict(lambda: [0, 0.0])
    for s, t, name in dev:
        by_name[name][0] += 1
        by_name[name][1] += (t - s) * 1e-6
    kernels = sorted(((n, c, s) for n, (c, s) in by_name.items()),
                     key=lambda k: -k[2])
    busy, gaps, cur = 0.0, [], None
    for s, t, _ in dev:
        if cur is None:
            cur = [s, t]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    if cur is not None:
        busy += cur[1] - cur[0]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP_GAPS]:
        inside = [(t - s, n) for s, t, n in host if s <= a < t]
        named.append((min(inside)[1] if inside else "host: no profiled op",
                      (b - a) * 1e-6))
    return Profile(wall_s=wall_s, busy_s=busy * 1e-6, launches=len(dev),
                   kernels=kernels, gaps=named)


def device_seconds(fn, device, reps=3) -> tuple:
    """(device seconds a call of fn: the busy time of `reps` calls over
    reps, Profile of those calls), after one call outside the profiler;
    None seconds off the card."""
    fn()
    _, prof = profiled(lambda: [fn() for _ in range(reps)], device)
    if device.type != "cuda" or prof.launches == 0:
        return None, prof
    return prof.busy_s / reps, prof
