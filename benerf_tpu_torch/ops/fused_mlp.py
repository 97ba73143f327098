"""Fused NeRF MLP on the card: kernels K1 (forward) and K2 (backward).

Port of benerf_tpu/ops/pallas_mlp_t.py. The TPU pair `_fwd_kernel_t` /
`_bwd_kernel_t` becomes two hand-written CUDA C++ kernels for Hopper,
csrc/fused_mlp_fwd.cu (K1) and csrc/fused_mlp_bwd.cu (K2), built with nvcc
for sm_90a into shared libraries with a plain C interface, loaded through
ctypes and tied together by a torch.autograd.Function. Each .cu file's
header says what bounds it and how its design answers that.

Contract of `fused_nerf_mlp` (same as the JAX function): standard
architecture, viewdirs on, L = 10 / 4 frequencies, optional BARF band
weights; pts (R, S, 3), viewdirs (R, 3) -> raw (R, S, C+1).
  - CPU tensors take the plain PyTorch version, models/nerf.apply;
  - CUDA float32 tensors launch the kernels; anything the kernels do not
    take raises. There is no fallback from a CUDA tensor to the plain path.

Weights are packed into one flat vector (`_layout`), each matrix in its
(fan_in, fan_out) orientation. The columns of the matrices the kernels'
layer product reads are interleaved (`interleave`) so that the 8 (4, 2)
outputs one thread owns, o = og + 32 k, sit side by side and load as
float4s. The packing is differentiable (views and torch.cat), so the
kernel's flat gradient, written in the same layout, flows back to each
parameter. K2 also gets a transposed copy (`_tlayout`) for its
data-gradient products. The BARF band weights get no gradient: they are
step functions of the iteration counter.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
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

# launches on the card, one per wrapper call that launched its kernel(s)
LAUNCHES = {"fused_mlp_fwd": 0, "fused_mlp_bwd": 0}

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fused_mlp_fwd", "fused_mlp_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# build output of the last build (ptxas register / spill report), by source
BUILD_LOG: dict = {}

_libs: dict = {}


def _layout(C):
    """(name, shape) of the packed weight vector, in order (mirrors
    fmlp::Offsets in csrc/fused_mlp_common.cuh); `_INTERLEAVED` names hold
    interleaved columns."""
    return [
        ("w0", (63, WIDTH)), ("wh", (DEPTH - 1, WIDTH, WIDTH)),
        ("w5pe", (63, WIDTH)), ("wf", (WIDTH, WIDTH)), ("wfv", (WIDTH, HEAD)),
        ("wvpe", (27, HEAD)), ("b", (DEPTH, WIDTH)), ("bf", (WIDTH,)),
        ("bv", (HEAD,)), ("wa", (WIDTH, 1)), ("ba", (1,)),
        ("wrgb", (HEAD, C)), ("brgb", (C,)),
    ]


def _tlayout(C):
    """(name, shape) of K2's transposed weight vector (fmlp::TOffsets):
    matrix (I, O) stored (O, I padded to a multiple of 4), columns
    interleaved."""
    return [
        ("whT", (DEPTH - 1, WIDTH, WIDTH)), ("w0T", (WIDTH, 64)),
        ("w5peT", (WIDTH, 64)), ("wfT", (WIDTH, WIDTH)), ("wfvT", (HEAD, WIDTH)),
        ("wvpeT", (HEAD, 32)), ("waT", (1, WIDTH)), ("wrgbT", (C, HEAD)),
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


def pack_params(params):
    """Parameter dict -> flat packed vector (differentiable)."""
    p = params["pts"]
    parts = [
        interleave(p[0]["w"]),
        interleave(torch.stack([p[l]["w_h"] if l == SKIP_LAYER else p[l]["w"]
                                for l in range(1, DEPTH)])),
        interleave(p[SKIP_LAYER]["w_pe"]), interleave(params["feature"]["w"]),
        interleave(params["views"]["w_feat"]), interleave(params["views"]["w_pe"]),
        torch.stack([p[l]["b"] for l in range(DEPTH)]),
        params["feature"]["b"], params["views"]["b"], params["alpha"]["w"],
        params["alpha"]["b"], params["rgb"]["w"], params["rgb"]["b"],
    ]
    return torch.cat([x.reshape(-1) for x in parts])


def unpack(flat, C):
    """Flat packed vector -> {name: tensor} per `_layout`, columns in their
    natural order."""
    layout = _layout(C)
    offs = _offsets(layout)
    out = {name: flat[offs[i]:offs[i + 1]].view(shape)
           for i, (name, shape) in enumerate(layout)}
    return {k: deinterleave(v) if k in _INTERLEAVED else v
            for k, v in out.items()}


def pack_transposed(packed, C):
    """K2's transposed weight vector from the packed one (no gradient):
    each matrix transposed, its rows zero-padded to a multiple of 4, its
    columns interleaved."""
    v = unpack(packed.detach(), C)
    parts = [
        v["wh"].transpose(1, 2), F.pad(v["w0"].t(), (0, 1)),
        F.pad(v["w5pe"].t(), (0, 1)), v["wf"].t(), v["wfv"].t(),
        F.pad(v["wvpe"].t(), (0, 5)), v["wa"].t(), v["wrgb"].t(),
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


def _target(name):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", CSRC / "fused_mlp_common.cuh"):
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


def _lib(name):
    if name in _libs:
        return _libs[name]
    build()
    lib = ctypes.CDLL(str(_target(name)))
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    if name == "fused_mlp_fwd":
        lib.fused_mlp_fwd.argtypes = [P, P, I64, I, P, P, I, P, P]
        lib.fused_mlp_fwd.restype = I
        lib.fused_mlp_layout.argtypes = [I, P]
        lib.fused_mlp_layout.restype = None
        for C in (1, 3):
            _check_layout(lib.fused_mlp_layout, _layout(C), C)
    else:
        lib.fused_mlp_bwd.argtypes = [P, P, I64, I, P, P, P, P, I, I64, P, P,
                                      P, P, P, I, P, P]
        lib.fused_mlp_bwd.restype = I
        lib.fused_mlp_bwd_scratch.argtypes = [I64, P]
        lib.fused_mlp_bwd_scratch.restype = None
        lib.fused_mlp_tlayout.argtypes = [I, P]
        lib.fused_mlp_tlayout.restype = None
        for C in (1, 3):
            _check_layout(lib.fused_mlp_tlayout, _tlayout(C), C)
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


def launch_fwd(packed, pts, vd, band, S, C):
    """K1: pts (n, 3), vd (n / S, 3) -> raw (n, C+1)."""
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
                           C, _ptr(out), _stream())
    if rc:
        raise RuntimeError(f"fused_mlp_fwd: CUDA error {rc}")
    LAUNCHES["fused_mlp_fwd"] += 1
    return out


def launch_bwd(packed, pts, vd, band, g, S, C, splits=DEFAULT_SPLITS):
    """K2: cotangent g (n, C+1) -> (d packed, d pts (n, 3), d vd per point
    (n, 3))."""
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
    n_pad = -(-n // TILE) * TILE
    sizes = (ctypes.c_int64 * 2)()
    lib.fused_mlp_bwd_scratch(n_pad, sizes)
    ptr_ = pack_transposed(packed, C).contiguous()
    x_scr = torch.empty(sizes[0], device=dev)
    d_scr = torch.empty(sizes[1], device=dev)
    part = torch.empty((splits, packed.numel()), device=dev)
    dpacked = torch.empty_like(packed)
    dpts = torch.empty((n, 3), device=dev)
    dvd = torch.empty((n, 3), device=dev)
    rc = lib.fused_mlp_bwd(
        _ptr(pts), _ptr(vd), n, S, _ptr(packed), _ptr(ptr_), _ptr(band),
        _ptr(g), C, n_pad, _ptr(x_scr), _ptr(d_scr), _ptr(dpts), _ptr(dvd),
        _ptr(part), splits, _ptr(dpacked), _stream())
    if rc:
        raise RuntimeError(f"fused_mlp_bwd: CUDA error {rc}")
    LAUNCHES["fused_mlp_bwd"] += 1
    return dpacked, dpts, dvd


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, pts, vd, band, S, C, splits):
        ctx.save_for_backward(packed, pts, vd, band)
        ctx.S, ctx.C, ctx.splits = S, C, splits
        return launch_fwd(packed, pts, vd, band, S, C)

    @staticmethod
    def backward(ctx, g):
        packed, pts, vd, band = ctx.saved_tensors
        dpacked, dpts, dvd_pt = launch_bwd(packed, pts, vd, band,
                                           g.contiguous(), ctx.S, ctx.C,
                                           ctx.splits)
        # a ray's viewdir is broadcast over its S samples: sum them
        dvd = dvd_pt.view(vd.shape[0], ctx.S, 3).sum(dim=1)
        return dpacked, dpts, dvd, None, None, None, None


def fused_nerf_mlp(params, pts, viewdirs, *, num_freqs=10, num_freqs_views=4,
                   barf_weights=None, barf_weights_views=None,
                   splits=DEFAULT_SPLITS):
    """Drop-in replacement for models.nerf.apply (standard architecture,
    viewdirs on, optional BARF band weights). pts: (R, S, 3); viewdirs:
    (R, 3). On the CPU this is the plain version, nerf.apply."""
    if pts.device.type == "cpu":
        return nerf_mod.apply(params, pts, viewdirs, num_freqs=num_freqs,
                              num_freqs_views=num_freqs_views,
                              barf_weights=barf_weights,
                              barf_weights_views=barf_weights_views)
    # the JAX package runs these on its staged kernel pair K3/K4
    # (benerf_tpu/ops/pallas_mlp.py), not ported yet
    if (num_freqs, num_freqs_views) != (L_PTS, L_VIEWS):
        raise NotImplementedError(
            f"{num_freqs}/{num_freqs_views} frequencies on the card: the fused "
            "kernel takes 10/4; other counts need K3/K4, not ported yet")
    if viewdirs is None or not supports(params):
        raise NotImplementedError(
            "non-standard MLP architecture on the card: the fused kernel "
            "takes the 8x256 MLP with viewdirs; others need K3/K4, not "
            "ported yet")
    R, S, _ = pts.shape
    C = params["rgb"]["w"].shape[1]
    packed = pack_params(params)
    band = band_weights(barf_weights, barf_weights_views, pts.device)
    out = _FusedMLP.apply(packed, pts.reshape(R * S, 3).contiguous(),
                          viewdirs.contiguous(), band, S, C, splits)
    return out.view(R, S, C + 1)
