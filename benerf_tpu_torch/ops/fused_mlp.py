"""Fused NeRF MLP on the card: kernels K1 (forward) and K2 (backward).

Port of benerf_tpu/ops/pallas_mlp_t.py. The TPU pair `_fwd_kernel_t` /
`_bwd_kernel_t` becomes two hand-written CUDA C++ kernels for Hopper,
csrc/fused_mlp_fwd.cu (K1) and csrc/fused_mlp_bwd.cu (K2), whose layer
products run on the tensor cores (csrc/mma_layer.cuh), built with nvcc for
sm_90a into shared libraries with a plain C interface, loaded through
ctypes and tied together by a torch.autograd.Function. Each .cu file's
header says what bounds it and how its design answers that.

Contract of `fused_nerf_mlp` (same as the JAX function): standard
architecture, viewdirs on, L = 10 / 4 frequencies, optional BARF band
weights, compute_dtype "float32" or "bfloat16"; pts (R, S, 3), viewdirs
(R, 3) -> raw (R, S, C+1).
  - CPU tensors take the plain PyTorch version, models/nerf.apply (bf16
    operands for "bfloat16");
  - CUDA float32 tensors launch the kernels: "float32" in their TF32X3
    mode (three TF32 products a step, fp32-level accuracy), "bfloat16" in
    their BF16 mode (bf16 operands, fp32 accumulation, as the JAX kernel);
  - anything outside the contract raises ValueError on either device;
    ops/mlp.route sends only what the kernels take here.
The build and load of every kernel library of the port (K1-K4) live here.

Weights are packed into one flat vector (`_layout`), each matrix in its
(fan_in, fan_out) orientation; K1/K2 read it with natural column order
(`interleaved=False`), and their backward reads the same vector for its
data-gradient products. The staged pair K3/K4 (ops/staged_mlp.py) uses the
same layout without the view-encoding entries (view_pe=False) and with the
columns of the matrices its CUDA-core layer product reads interleaved
(`interleave`), so that the 8 (4, 2) outputs one thread owns, o = og + 32
k, sit side by side and load as float4s; K4 also gets a transposed copy
(`_tlayout`). The packing is differentiable (views and torch.cat), so the
kernel's flat gradient, written in the same layout, flows back to each
parameter. The BARF band weights get no gradient: they are step functions
of the iteration counter.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from benerf_tpu_torch.models import nerf as nerf_mod

WIDTH = 256
DEPTH = 8
SKIP_LAYER = 5
HEAD = 128
L_PTS = 10
L_VIEWS = 4
TILE = 64             # points per block of K1 and of K2's tile pass
DEFAULT_SPLITS = 32   # point-axis chunks of K2's weight-gradient reduction
# compute_dtype -> the kernels' operand mode (tc::Mode in csrc/mma_layer.cuh)
MODES = {"float32": 0, "bfloat16": 1}

# launches on the card, one per wrapper call that launched its kernel(s),
# by mode: "float32" counts under the kernel's name, "bfloat16" under
# name + "_bf16"
LAUNCHES = {"fused_mlp_fwd": 0, "fused_mlp_bwd": 0,
            "fused_mlp_fwd_bf16": 0, "fused_mlp_bwd_bf16": 0}


def launch_key(name, compute_dtype):
    return name if compute_dtype == "float32" else f"{name}_bf16"

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fused_mlp_fwd", "fused_mlp_bwd", "staged_mlp_fwd", "staged_mlp_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# build output of the last build (ptxas register / spill report), by source
BUILD_LOG: dict = {}

_libs: dict = {}


def _layout(C, view_pe=True):
    """(name, shape) of the packed weight vector, in order (mirrors
    fmlp::Offsets in csrc/fused_mlp_common.cuh); `_INTERLEAVED` names hold
    interleaved columns. view_pe=False (K3/K4): the view-encoding weights
    and their bias are empty; the per-ray view bias comes in instead."""
    return [
        ("w0", (63, WIDTH)), ("wh", (DEPTH - 1, WIDTH, WIDTH)),
        ("w5pe", (63, WIDTH)), ("wf", (WIDTH, WIDTH)), ("wfv", (WIDTH, HEAD)),
        ("wvpe", (27 if view_pe else 0, HEAD)), ("b", (DEPTH, WIDTH)),
        ("bf", (WIDTH,)), ("bv", (HEAD if view_pe else 0,)), ("wa", (WIDTH, 1)),
        ("ba", (1,)), ("wrgb", (HEAD, C)), ("brgb", (C,)),
    ]


def _tlayout(C, view_pe=True):
    """(name, shape) of K4's transposed weight vector
    (fmlp::TOffsets): matrix (I, O) stored (O, I padded to a multiple of 4),
    columns interleaved."""
    return [
        ("whT", (DEPTH - 1, WIDTH, WIDTH)), ("w0T", (WIDTH, 64)),
        ("w5peT", (WIDTH, 64)), ("wfT", (WIDTH, WIDTH)), ("wfvT", (HEAD, WIDTH)),
        ("wvpeT", (HEAD, 32 if view_pe else 0)), ("waT", (1, WIDTH)),
        ("wrgbT", (C, HEAD)),
    ]


def _offsets(layout):
    offs, o = [], 0
    for _, shape in layout:
        offs.append(o)
        o += math.prod(shape)
    return offs + [o]


def interleave(m):
    """(..., 32 * T) columns o = og + 32 k -> position og * T + k."""
    return m.unflatten(-1, (m.shape[-1] // 32, 32)).transpose(-1, -2).flatten(-2)


def deinterleave(m):
    """Inverse of `interleave`."""
    return m.unflatten(-1, (32, m.shape[-1] // 32)).transpose(-1, -2).flatten(-2)


# packed matrices the layer product reads (interleaved columns)
_INTERLEAVED = ("w0", "wh", "w5pe", "wf", "wfv", "wvpe")


def supports(params) -> bool:
    """Standard BeNeRF architecture (pallas_mlp_t.supports)."""
    try:
        if "views" not in params or len(params["pts"]) != DEPTH:
            return False
        return (tuple(params["pts"][0]["w"].shape) == (63, WIDTH)
                and "w_pe" in params["pts"][SKIP_LAYER]
                and tuple(params["views"]["w_feat"].shape) == (WIDTH, HEAD)
                and tuple(params["views"]["w_pe"].shape) == (27, HEAD)
                and params["rgb"]["w"].shape[1] + 1 <= 8)
    except (KeyError, IndexError, TypeError):
        return False


def pack_params(params, view_pe=True, interleaved=True):
    """Parameter dict -> flat packed vector (differentiable); view_pe as
    for `_layout`; interleaved: the `_INTERLEAVED` matrices' columns
    interleaved (K3/K4) or in natural order (K1/K2)."""
    p = params["pts"]
    views = params["views"]
    il = interleave if interleaved else (lambda m: m)
    parts = [
        il(p[0]["w"]),
        il(torch.stack([p[l]["w_h"] if l == SKIP_LAYER else p[l]["w"]
                        for l in range(1, DEPTH)])),
        il(p[SKIP_LAYER]["w_pe"]), il(params["feature"]["w"]),
        il(views["w_feat"]),
        *([il(views["w_pe"])] if view_pe else []),
        torch.stack([p[l]["b"] for l in range(DEPTH)]),
        params["feature"]["b"], *([views["b"]] if view_pe else []),
        params["alpha"]["w"], params["alpha"]["b"], params["rgb"]["w"],
        params["rgb"]["b"],
    ]
    return torch.cat([x.reshape(-1) for x in parts])


def unpack(flat, C, view_pe=True, interleaved=True):
    """Flat packed vector -> {name: tensor} per `_layout`, columns in their
    natural order; `interleaved` as the vector was packed."""
    layout = _layout(C, view_pe)
    offs = _offsets(layout)
    out = {name: flat[offs[i]:offs[i + 1]].view(shape)
           for i, (name, shape) in enumerate(layout)}
    return {k: deinterleave(v) if interleaved and k in _INTERLEAVED else v
            for k, v in out.items()}


def pack_transposed(packed, C, view_pe=True):
    """K4's transposed weight vector from the interleaved packed one (no
    gradient): each matrix transposed, its rows zero-padded to a multiple
    of 4, its columns interleaved."""
    v = unpack(packed.detach(), C, view_pe)
    parts = [
        v["wh"].transpose(1, 2), F.pad(v["w0"].t(), (0, 1)),
        F.pad(v["w5pe"].t(), (0, 1)), v["wf"].t(), v["wfv"].t(),
        F.pad(v["wvpe"].t(), (0, 5 if view_pe else 0)), v["wa"].t(),
        v["wrgb"].t(),
    ]
    return torch.cat([interleave(x).reshape(-1) for x in parts])


def band_weights(barf_weights, barf_weights_views, device):
    """(14,) per-band encoding multipliers: the BARF weights, ones when off."""
    w = (torch.ones(L_PTS, device=device) if barf_weights is None
         else barf_weights.to(device=device, dtype=torch.float32))
    wv = (torch.ones(L_VIEWS, device=device) if barf_weights_views is None
          else barf_weights_views.to(device=device, dtype=torch.float32))
    return torch.cat([w.reshape(-1), wv.reshape(-1)]).contiguous()


# ---- build and load -------------------------------------------------------


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _source_files(name):
    """csrc/{name}.cu and every csrc header it includes, directly or not."""
    files, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        f = todo.pop()
        if f not in files:
            files.append(f)
            todo += [CSRC / h for h in
                     re.findall(r'^#include "([^"]+)"', f.read_text(), re.M)]
    return files


def _target(name):
    """The library's path, keyed by the flags and every file it is built
    from, so an edit to any included header rebuilds it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _source_files(name):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build():
    """Compile every kernel source that has no current library, one nvcc
    process per source, all started together. Returns seconds taken."""
    t0 = time.perf_counter()
    todo = [(n, _target(n)) for n in SOURCES if not _target(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, target in todo:
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, target, tmp, proc in procs:
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C functions of each library: name -> (argtypes, restype). Pointers and the
# stream are c_void_p (a bare int would pass as a 32-bit int).
_API = {
    "fused_mlp_fwd": {
        "fused_mlp_fwd": ([_P, _P, _I64, _I, _P, _P, _I, _P, _I, _P], _I),
        "fused_mlp_layout": ([_I, _P], None)},
    "fused_mlp_bwd": {
        "fused_mlp_bwd": ([_P, _P, _I64, _I, _P, _P, _P, _I, _I64, _P, _P, _P,
                           _P, _P, _I, _P, _I, _P], _I),
        "fused_mlp_wgrad": ([_P, _P, _I64, _I, _P, _I, _P, _I, _P], _I),
        "fused_mlp_bwd_scratch": ([_I64, _P], None)},
    "staged_mlp_fwd": {
        "staged_mlp_fwd": ([_P, _P, _I64, _I, _P, _I, _P, _P], _I),
        "staged_mlp_layout": ([_I, _P], None)},
    "staged_mlp_bwd": {
        "staged_mlp_bwd": ([_P, _P, _I64, _I, _P, _P, _P, _I, _I64, _P, _P, _P,
                            _P, _I, _P, _P], _I),
        "staged_mlp_bwd_scratch": ([_I64, _I, _P], None),
        "staged_mlp_tlayout": ([_I, _P], None)},
}
# the layout each library reports, checked against the Python one at load:
# name -> (C function, layout function, view_pe). K2 reads K1's layout, from
# the same header (fmlp::offsets), so K1's library reports it for both.
_LAYOUT_OF = {
    "fused_mlp_fwd": ("fused_mlp_layout", _layout, True),
    "staged_mlp_fwd": ("staged_mlp_layout", _layout, False),
    "staged_mlp_bwd": ("staged_mlp_tlayout", _tlayout, False),
}


def _lib(name):
    """The loaded library of csrc/{name}.cu, built first if needed."""
    if name in _libs:
        return _libs[name]
    build()
    lib = ctypes.CDLL(str(_target(name)))
    for fn, (argtypes, restype) in _API[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    if name in _LAYOUT_OF:
        fn, layout, view_pe = _LAYOUT_OF[name]
        for C in (1, 3, 8):
            _check_layout(getattr(lib, fn), layout(C, view_pe), C)
    _libs[name] = lib
    return lib


def _check_layout(fn, layout, C):
    want = _offsets(layout)
    got = (ctypes.c_int64 * len(want))()
    fn(C, got)
    if list(got) != want:
        raise RuntimeError(f"packed layout mismatch (C={C}): kernel {list(got)}"
                           f" vs python {want}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _check(name, t, shape, dtype=torch.float32):
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} CUDA tensor, got "
                         f"{t.dtype} on {t.device} (contiguous="
                         f"{t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _mode(compute_dtype):
    if compute_dtype not in MODES:
        raise ValueError(f"compute_dtype must be one of {sorted(MODES)}, got "
                         f"{compute_dtype!r}")
    return MODES[compute_dtype]


def launch_fwd(packed, pts, vd, band, S, C, compute_dtype="float32"):
    """K1: pts (n, 3), vd (n / S, 3) -> raw (n, C+1); packed in natural
    column order."""
    mode = _mode(compute_dtype)
    n = pts.shape[0]
    if n == 0 or n % S:
        raise ValueError(f"point count {n} is not a positive multiple of S={S}")
    _check("packed", packed, (_offsets(_layout(C))[-1],))
    _check("pts", pts, (n, 3))
    _check("viewdirs", vd, (n // S, 3))
    _check("band", band, (L_PTS + L_VIEWS,))
    lib = _lib("fused_mlp_fwd")
    out = torch.empty((n, C + 1), device=pts.device, dtype=torch.float32)
    rc = lib.fused_mlp_fwd(_ptr(pts), _ptr(vd), n, S, _ptr(packed), _ptr(band),
                           C, _ptr(out), mode, _stream())
    if rc:
        raise RuntimeError(f"fused_mlp_fwd: CUDA error {rc}")
    LAUNCHES[launch_key("fused_mlp_fwd", compute_dtype)] += 1
    return out


def bwd_scratch(n, device):
    """K2's scratch for n points: (n_pad, X, D), feature-major fp32."""
    n_pad = -(-n // TILE) * TILE
    sizes = (ctypes.c_int64 * 2)()
    _lib("fused_mlp_bwd").fused_mlp_bwd_scratch(n_pad, sizes)
    return (n_pad, torch.empty(sizes[0], device=device),
            torch.empty(sizes[1], device=device))


def launch_bwd(packed, pts, vd, band, g, S, C, splits=DEFAULT_SPLITS,
               compute_dtype="float32"):
    """K2: cotangent g (n, C+1) -> (d packed, d pts (n, 3), d vd per point
    (n, 3)); packed and d packed in natural column order."""
    mode = _mode(compute_dtype)
    n = pts.shape[0]
    _check("packed", packed, (_offsets(_layout(C))[-1],))
    _check("pts", pts, (n, 3))
    _check("viewdirs", vd, (n // S, 3))
    _check("band", band, (L_PTS + L_VIEWS,))
    _check("cotangent", g, (n, C + 1))
    if splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    lib = _lib("fused_mlp_bwd")
    dev = pts.device
    n_pad, x_scr, d_scr = bwd_scratch(n, dev)
    part = torch.empty((splits, packed.numel()), device=dev)
    dpacked = torch.empty_like(packed)
    dpts = torch.empty((n, 3), device=dev)
    dvd = torch.empty((n, 3), device=dev)
    rc = lib.fused_mlp_bwd(
        _ptr(pts), _ptr(vd), n, S, _ptr(packed), _ptr(band), _ptr(g), C,
        n_pad, _ptr(x_scr), _ptr(d_scr), _ptr(dpts), _ptr(dvd), _ptr(part),
        splits, _ptr(dpacked), mode, _stream())
    if rc:
        raise RuntimeError(f"fused_mlp_bwd: CUDA error {rc}")
    LAUNCHES[launch_key("fused_mlp_bwd", compute_dtype)] += 1
    return dpacked, dpts, dvd


def run_wgrad(x_scr, d_scr, n_pad, C, splits=DEFAULT_SPLITS,
              compute_dtype="float32"):
    """K2's weight-gradient pass alone on a scratch from `bwd_scratch`, for
    timing it apart (not counted: the main path runs it inside K2)."""
    _check("X scratch", x_scr, tuple(x_scr.shape))
    _check("D scratch", d_scr, tuple(d_scr.shape))
    part = torch.empty((splits, _offsets(_layout(C))[-1]), device=x_scr.device)
    dpacked = torch.empty(part.shape[1], device=x_scr.device)
    rc = _lib("fused_mlp_bwd").fused_mlp_wgrad(
        _ptr(x_scr), _ptr(d_scr), n_pad, C, _ptr(part), splits,
        _ptr(dpacked), _mode(compute_dtype), _stream())
    if rc:
        raise RuntimeError(f"fused_mlp_wgrad: CUDA error {rc}")
    return dpacked


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, pts, vd, band, S, C, splits, compute_dtype):
        ctx.save_for_backward(packed, pts, vd, band)
        ctx.S, ctx.C, ctx.splits, ctx.cd = S, C, splits, compute_dtype
        return launch_fwd(packed, pts, vd, band, S, C, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        packed, pts, vd, band = ctx.saved_tensors
        dpacked, dpts, dvd_pt = launch_bwd(packed, pts, vd, band,
                                           g.contiguous(), ctx.S, ctx.C,
                                           ctx.splits, ctx.cd)
        # a ray's viewdir is broadcast over its S samples: sum them
        dvd = dvd_pt.view(vd.shape[0], ctx.S, 3).sum(dim=1)
        return dpacked, dpts, dvd, None, None, None, None, None


def fused_nerf_mlp(params, pts, viewdirs, *, num_freqs=10, num_freqs_views=4,
                   barf_weights=None, barf_weights_views=None,
                   splits=DEFAULT_SPLITS, compute_dtype="float32"):
    """Drop-in replacement for models.nerf.apply (standard architecture,
    viewdirs on, optional BARF band weights). pts: (R, S, 3); viewdirs:
    (R, 3). On the CPU this is the plain version, nerf.apply."""
    _mode(compute_dtype)
    if (viewdirs is None or not supports(params)
            or (num_freqs, num_freqs_views) != (L_PTS, L_VIEWS)):
        raise ValueError(
            "fused_nerf_mlp takes the 8x256 MLP with viewdirs, 27 view-"
            f"encoding rows, C + 1 <= 8 and 10/4 frequencies (got "
            f"{num_freqs}/{num_freqs_views}); ops/mlp.route picks the "
            "implementation for anything else")
    if pts.device.type == "cpu":
        return nerf_mod.apply(
            params, pts, viewdirs, num_freqs=num_freqs,
            num_freqs_views=num_freqs_views, barf_weights=barf_weights,
            barf_weights_views=barf_weights_views,
            compute_dtype=None if compute_dtype == "float32" else torch.bfloat16)
    return _fused(params, pts, viewdirs, barf_weights, barf_weights_views,
                  splits, compute_dtype)


def _fused(params, pts, viewdirs, barf_weights, barf_weights_views, splits,
           compute_dtype):
    """The card path: the packing (natural column order), the band weights,
    K1 and (through autograd) K2."""
    R, S, _ = pts.shape
    C = params["rgb"]["w"].shape[1]
    packed = pack_params(params, interleaved=False)
    band = band_weights(barf_weights, barf_weights_views, pts.device)
    out = _FusedMLP.apply(packed, pts.reshape(R * S, 3).contiguous(),
                          viewdirs.contiguous(), band, S, C, splits,
                          compute_dtype)
    return out.view(R, S, C + 1)
