"""Operations, bytes and peaks: the yardstick of the benchmark's rooflines
and utilisations.

FLOP are multiply-adds x 2 of the NeRF MLP in its split-skip layout (the
same count as the port's bench arithmetic): 1,186,816 a point at the
published widths (8 x 256, 63 / 27 encoding rows, 128 wide views layer,
3 colours). A training step evaluates both MLPs at 64 coarse and 128 fine
points a ray, forward and backward (the backward counted as twice the
forward, recomputation not counted); a frame evaluates them forward only.
Encoding, compositing, sampling, spline and Adam are O(width) a point and
are left out.

Bytes: each input read once and each output written once: points and
directions (float32), the weights, the raw outputs; for the backward the
upstream gradient too, and the gradients of the points and weights
written.

Peaks of one NVIDIA H100 SXM (NVIDIA's H100 data sheet, dense, at its
700 W limit): 495 TFLOP/s in TF32 (the precision of a float32
configuration on the tensor cores), 989 TFLOP/s in bf16, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def mlp_flops_per_point(depth=8, width=256, input_ch=63, views_ch=27,
                        channels=3) -> int:
    f = input_ch * width                      # first layer
    f += (depth - 2) * width * width          # plain hidden layers
    f += (width + input_ch) * width           # skip layer
    f += width * width                        # feature
    f += width                                # alpha
    f += (width + views_ch) * (width // 2)    # views layer
    f += (width // 2) * channels              # colour head
    return 2 * f


def mlp_params(depth=8, width=256, input_ch=63, views_ch=27, channels=3) -> int:
    """Weights and biases of one MLP."""
    n = mlp_flops_per_point(depth, width, input_ch, views_ch, channels) // 2
    return n + depth * width + width + 1 + width // 2 + channels


def _mlp_kw(c):
    return dict(depth=c["netdepth"], width=c["netwidth"], channels=c["channels"])


def rays_per_step(c) -> int:
    return (2 * c["sampling_event_rays"] + c["num_interpolated_pose"]
            * (c["sampling_rgb_rays"] // c["num_interpolated_pose"]))


def train_points(c):
    """(coarse, fine) points of a step's two MLP calls."""
    r = rays_per_step(c)
    return r * c["N_samples"], r * (c["N_samples"] + c["N_importance"])


def train_flops_per_step(c) -> int:
    """Forward + backward (3 x forward) MLP FLOP of one step."""
    per_point = mlp_flops_per_point(**_mlp_kw(c))
    return 3 * per_point * sum(train_points(c))


def frame_flops(c, H, W) -> int:
    """Forward MLP FLOP of one full frame."""
    return (H * W * (2 * c["N_samples"] + c["N_importance"])
            * mlp_flops_per_point(**_mlp_kw(c)))


def mlp_fwd_bytes(c, n_points, n_rays) -> int:
    C = c["channels"]
    return 4 * (n_points * 3 + n_rays * 3 + mlp_params(**_mlp_kw(c))
                + n_points * (C + 1))


def mlp_bwd_bytes(c, n_points, n_rays) -> int:
    C = c["channels"]
    p = mlp_params(**_mlp_kw(c))
    reads = n_points * 3 + n_rays * 3 + p + n_points * (C + 1)
    writes = n_points * 3 + p
    return 4 * (reads + writes)


def least_seconds(flops, nbytes, precision):
    """(least time, "compute" or "memory"): max(FLOP / peak, bytes / HBM)."""
    tc, tm = flops / PEAK_FLOPS[precision], nbytes / HBM_BYTES_PER_S
    return (tc, "compute") if tc >= tm else (tm, "memory")
