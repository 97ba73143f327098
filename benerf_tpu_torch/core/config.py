"""Configuration: a single dataclass covering the reference's full flag
surface (reference config.py:3-228) plus the JAX package's extensions, with a
parser for the reference's `key = value` .txt scene configs so that every
shipped config under configs/ runs unmodified.

This is the PyTorch port's own copy of benerf_tpu/core/config.py: the port
imports nothing from the JAX package. Fields that only the JAX package reads
(use_pallas, mesh_devices, profile_*) parse the same way; the port's train
loop raises on the ones it cannot honour yet.

Parsing rules (configargparse compatibility):
  - lines `key = value`; `#` starts a comment; booleans are True/False;
  - bracketed lists `[a, b, c]` -> list of floats;
  - CLI overrides config-file values (config-file overrides dataclass default).

Deviation (documented): the reference declares `--ndc` with type=bool so ANY
config string parses truthy — NDC is effectively always on (config.py:109,
SURVEY.md §3.2). We parse booleans properly but keep default ndc=True, which
reproduces every shipped run.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Config:
    # -- run identity / IO (config.py:7-32)
    device: int = 0
    debug: bool = False
    seed: int = 0
    config: Optional[str] = None
    project: str = "None"
    expname: Optional[str] = None
    datadir: Optional[str] = None
    logdir: str = "./logs"
    dataset: str = "BeNeRF_Blender"
    index: int = 0
    viewer: str = "jsonl"  # reference default: wandb; we always write JSONL
    depth: bool = False

    # -- model options (config.py:34-94)
    model: str = "benerf"
    load_checkpoint: bool = False
    loadpose: bool = False
    loadtrans: bool = False
    traj: str = "spline"
    num_interpolated_pose: int = 19
    use_barf_c2f: bool = False
    barf_c2f_start: float = 0.1
    barf_c2f_end: float = 0.5
    netdepth: int = 8
    netwidth: int = 256
    netdepth_fine: int = 8
    netwidth_fine: int = 256
    rgb_crf_net_hidden: int = 0
    rgb_crf_net_width: int = 128
    event_crf_net_hidden: int = 0
    event_crf_net_width: int = 128
    chunk: int = 4096
    netchunk: int = 32768
    channels: int = 3
    sampling_event_rays: int = 2048
    sampling_rgb_rays: int = 1024
    N_samples: int = 64
    N_importance: int = 0
    perturb: float = 1.0
    use_viewdirs: bool = False
    i_embed: int = 0
    multires: int = 10
    multires_views: int = 4
    raw_noise_std: float = 0.0  # see sigma_noise_std below for actual behavior

    # -- render test (config.py:96-122)
    render_images: bool = False
    render_video: bool = False
    extract_poses: bool = False
    checkpoint: int = 80000
    num_render_images: int = 19
    num_extract_poses: int = 19
    ndc: bool = True
    render_height: int = 0
    render_width: int = 0
    render_fx: float = 0.0
    render_fy: float = 0.0
    render_cx: float = 0.0
    render_cy: float = 0.0

    # -- optimization (config.py:124-156)
    optimize_nerf: bool = False
    optimize_pose: bool = False
    optimize_trans: bool = False
    optimize_rgb_crf: bool = False
    optimize_event_crf: bool = False
    lrate: float = 5e-4
    pose_lrate: float = 1e-3
    transform_lrate: float = 1e-6
    rgb_crf_lrate: float = 5e-4
    event_crf_lrate: float = 5e-4
    decay_rate: float = 0.1
    decay_rate_pose: float = 0.01
    decay_rate_transform: float = 0.01
    decay_rate_rgb_crf: float = 0.1
    decay_rate_event_crf: float = 0.1
    lrate_decay: int = 200
    # linear 0->lr warmup steps applied to BOTH the knot and transform
    # optimizer groups (new, no reference counterpart — default 0 keeps
    # reference behavior; guards the trajectory from untrained-NeRF gradient
    # noise early in training)
    pose_lrate_warmup: int = 0

    # -- camera parameters (config.py:158-186)
    rgb_fx: float = 548.409
    rgb_fy: float = 548.409
    rgb_cx: float = 384.0
    rgb_cy: float = 240.0
    rgb_width: float = 240.0
    rgb_height: float = 240.0
    rgb_dist: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0, 0.0])
    event_fx: float = 548.409
    event_fy: float = 548.409
    event_cx: float = 384.0
    event_cy: float = 240.0
    event_width: int = 480
    event_height: int = 768
    event_dist: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0, 0.0])

    # -- event stream (config.py:188-200)
    event_threshold: float = 0.1
    event_shift_start: float = 5.0
    event_shift_end: float = 5.0
    accumulate_time_length: float = 0.1
    # static cap on events per time window for the sliced ETA scatter
    # (0 = scatter the full stream; the train loop auto-computes a safe
    # value from the loaded stream via data.events.window_cap)
    event_window_cap: int = 0
    random_sampling_window: bool = False
    event_time_window: bool = False

    # -- logging/saving (config.py:202-212)
    max_iter: int = 200000
    console_log_iter: int = 100
    render_image_iter: int = 25000
    save_model_iter: int = 10000
    render_video_iter: int = 50000

    # -- losses (config.py:214-224)
    rgb_loss: bool = False
    event_loss: bool = False
    event_coeff_syn: float = 1.0
    event_coeff_real: float = 1.0
    rgb_coeff: float = 1.0

    # ================= TPU-native extensions (not in the reference) ========
    # sigma regularization noise. The reference applies N(0,1) noise to sigma
    # unconditionally at train AND eval (model/nerf.py:118,312-335; its
    # raw_noise_std flag is dead). parity default reproduces that; set
    # sigma_noise_eval=False for deterministic eval renders.
    sigma_noise_std: float = 1.0
    sigma_noise_eval: bool = True
    # matmul input precision: "float32" | "bfloat16" (accumulate f32 either way)
    compute_dtype: str = "float32"
    # use fused Pallas kernels for the MLP hot path where available
    use_pallas: bool = True
    # data-parallel mesh size over the ray axis (1 = single chip); -1 = all
    # visible devices.
    mesh_devices: int = -1
    # NaN diagnostics (SURVEY.md §5: the reference dies silently on NaN).
    # debug_nans=True flips jax_debug_nans so the faulting primitive is
    # reported at the cost of per-op checks; the training loop always
    # finite-guards the loss on the host and aborts with a pointer here.
    debug_nans: bool = False
    # profiling (SURVEY.md §5): capture a jax.profiler trace (TensorBoard /
    # xprof format) of the dispatch that crosses `profile_iter`, written to
    # profile_dir. 0 = off.
    profile_iter: int = 0
    profile_dir: str = "/tmp/benerf_trace"
    # deterministic per-step RNG folding
    log_file: Optional[str] = None
    # diagnostics: log per-loss-term knot gradient norms (extra backward
    # passes per step — use for short investigative runs only)
    log_knot_grad_terms: bool = False
    # ray subset sampling: True = approx_max_k over random keys (TPU-native,
    # stratified-flavor subset); False = exact uniform permutation slice
    # (reference randperm semantics, model/nerf.py:214 — a full sort of
    # H*W keys per sensor per iteration). Default False keeps the default
    # training path reference-faithful; perf-oriented configs (demo.txt,
    # bench.py) enable it explicitly.
    fast_ray_sampling: bool = False
    # trajectory init: "reference" = U(0,0.01) knots (model/optimize.py:22),
    # "motion_scale" = random knots rescaled to the apparent-motion
    # magnitude estimated from the event stream + blurry image
    # (train/pose_init.py — documented deviation; the near-zero reference
    # init cannot escape the absorption minimum, ANALYSIS_pose_recovery.md)
    pose_init: str = "reference"

    def scene_tag(self) -> str:
        return self.expname or self.project or "scene"


_BOOL = {"true": True, "false": False, "1": True, "0": False}


def _parse_value(name: str, raw: str, target_type):
    raw = raw.strip()
    if raw.startswith("[") and raw.endswith("]"):
        items = [s.strip() for s in raw[1:-1].split(",") if s.strip()]
        return [float(s) for s in items]
    if target_type is bool or (target_type is type(None) and raw in ("True", "False")):
        low = raw.lower()
        if low not in _BOOL:
            raise ValueError(f"config key {name}: expected bool, got {raw!r}")
        return _BOOL[low]
    if target_type is int:
        return int(float(raw))
    if target_type is float:
        return float(raw)
    if target_type is list or target_type is List[float]:
        return [float(s) for s in raw.split(",")]
    return raw  # string


_FIELD_TYPES = {}


def _field_types():
    global _FIELD_TYPES
    if not _FIELD_TYPES:
        for f in dataclasses.fields(Config):
            t = f.type
            if t in ("bool", bool):
                _FIELD_TYPES[f.name] = bool
            elif t in ("int", int):
                _FIELD_TYPES[f.name] = int
            elif t in ("float", float):
                _FIELD_TYPES[f.name] = float
            elif "List" in str(t) or "list" in str(t):
                _FIELD_TYPES[f.name] = list
            else:
                _FIELD_TYPES[f.name] = str
    return _FIELD_TYPES


def parse_config_text(text: str) -> dict:
    """Parse reference-style `key = value` config text into a dict."""
    types = _field_types()
    out = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        if "=" not in line:
            raise ValueError(f"config line {lineno}: no '=' in {line!r}")
        key, raw = line.split("=", 1)
        key = key.strip()
        if key not in types:
            # Unknown keys are tolerated (forward compat with reference forks)
            continue
        out[key] = _parse_value(key, raw, types[key])
    return out


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None) -> Config:
    """Build a Config: defaults <- config file <- overrides (CLI)."""
    values: dict = {}
    if path is not None:
        with open(path) as f:
            values.update(parse_config_text(f.read()))
        values["config"] = path
    if overrides:
        types = _field_types()
        for k, v in overrides.items():
            if v is None or k not in types:
                continue
            values[k] = v
    return Config(**values)


def add_cli_args(parser):
    """Register every Config field as a --flag on an argparse parser."""
    types = _field_types()
    for f in dataclasses.fields(Config):
        t = types[f.name]
        if f.name == "config":
            parser.add_argument("--config", type=str, default=None)
            continue
        if t is bool:
            parser.add_argument(
                f"--{f.name}", type=str, choices=["True", "False"], default=None
            )
        elif t is list:
            parser.add_argument(f"--{f.name}", type=str, default=None)
        else:
            parser.add_argument(f"--{f.name}", type=t, default=None)
    return parser


def config_from_cli(argv=None) -> Config:
    """Reference-compatible CLI: --config file.txt plus per-flag overrides."""
    import argparse

    parser = argparse.ArgumentParser()
    add_cli_args(parser)
    args, _ = parser.parse_known_args(argv)
    overrides = {}
    types = _field_types()
    for k, v in vars(args).items():
        if v is None or k == "config":
            continue
        if types[k] is bool:
            overrides[k] = _BOOL[v.lower()]
        elif types[k] is list:
            overrides[k] = _parse_value(k, v, list)
        else:
            overrides[k] = v
    return load_config(args.config, overrides)
