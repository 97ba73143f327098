"""The card's work in a torch.profiler trace.

The kernels and copies the card ran, by name, with their launch counts and
device time, read from `key_averages()` of a profile taken with the CUDA
activity on. The device spans of `record_function` annotations are left
out: they cover kernels that are counted themselves. Used by
cli/bench.py's --profile, tools/torch_profile_step.py and
tools/torch_perf_breakdown.py.
"""

from __future__ import annotations

import torch


def _device_us(evt) -> float:
    """Self device time of a profiler entry, in microseconds."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_work(prof):
    """[(name, launches, ms)] of every kernel and copy the card ran under
    `prof`, largest total time first; empty when it recorded no device
    time (a CPU run)."""
    work = [(e.key, e.count, _device_us(e) / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and _device_us(e) > 0 and not getattr(e, "is_user_annotation", False)
            and "#" not in e.key]
    return sorted(work, key=lambda w: -w[2])
