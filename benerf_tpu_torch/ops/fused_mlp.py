"""Fused NeRF MLP on the card: kernels K1 (forward) and K2 (backward).

Port of benerf_tpu/ops/pallas_mlp_t.py. The TPU pair `_fwd_kernel_t` /
`_bwd_kernel_t` becomes two hand-written CUDA C++ kernels for Hopper,
csrc/fused_mlp_fwd.cu (K1) and csrc/fused_mlp_bwd.cu (K2), whose layer
products run as wgmma on weights that TMA brings into shared memory
(csrc/wgmma_layer.cuh), built with nvcc for sm_90a into shared libraries
with a plain C interface, loaded through ctypes and tied together by a
torch.autograd.Function. Each .cu file's header says what bounds it and how
its design answers that.

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
(fan_in, fan_out) orientation with its columns in natural order. The
packing is differentiable (views and torch.cat), so the kernel's flat
gradient, written in the same layout, flows back to each parameter. The
staged pair K3/K4 (ops/staged_mlp.py) uses the same layout without the
view-encoding entries (view_pe=False). The layer products read the
weights' wgmma copies instead (`prep_table`): W^T for the forward, W for the
backward's data gradients, K-major, cut into stages, split into TF32 big and
small parts (TF32X3) or rounded to bf16 (BF16). K1's (K3's) launch writes
them into a buffer the autograd Function keeps for K2 (K4);
`prepare_weights_plain` is their plain version. The heads read the packed
vector. The BARF band weights get no gradient: they are step functions of
the iteration counter.
"""

from __future__ import annotations

import ctypes
import math
import os
import re
import shutil
import time
from pathlib import Path

import torch

from benerf_tpu_torch.core import libbuild, profiling
from benerf_tpu_torch.models import nerf as nerf_mod

WIDTH = 256
DEPTH = 8
SKIP_LAYER = 5
HEAD = 128
L_PTS = 10
L_VIEWS = 4
TILE = 64             # points per block of K1 and of K2's tile pass
DEFAULT_SPLITS = 32   # point-axis chunks of K2's weight-gradient reduction
# compute_dtype -> the kernels' operand mode (tc::Mode in csrc/tc_common.cuh)
MODES = {"float32": 0, "bfloat16": 1}
# the weights' wgmma copies (wl::Cfg in csrc/wgmma_layer.cuh), by mode:
# contraction rows a stage, parts a stage (TF32X3: big and small), the
# element type of a 64-byte row
PREP_KS = {"float32": 16, "bfloat16": 32}
PREP_PARTS = {"float32": 2, "bfloat16": 1}
PREP_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}

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
    fmlp::Offsets in csrc/fused_mlp_common.cuh). view_pe=False (K3/K4): the
    view-encoding weights and their bias are empty; the per-ray view bias
    comes in instead."""
    return [
        ("w0", (63, WIDTH)), ("wh", (DEPTH - 1, WIDTH, WIDTH)),
        ("w5pe", (63, WIDTH)), ("wf", (WIDTH, WIDTH)), ("wfv", (WIDTH, HEAD)),
        ("wvpe", (27 if view_pe else 0, HEAD)), ("b", (DEPTH, WIDTH)),
        ("bf", (WIDTH,)), ("bv", (HEAD if view_pe else 0,)), ("wa", (WIDTH, 1)),
        ("ba", (1,)), ("wrgb", (HEAD, C)), ("brgb", (C,)),
    ]


def _offsets(layout):
    offs, o = [], 0
    for _, shape in layout:
        offs.append(o)
        o += math.prod(shape)
    return offs + [o]


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


def pack_params(params, view_pe=True):
    """Parameter dict -> flat packed vector (differentiable); view_pe as
    for `_layout`."""
    p = params["pts"]
    views = params["views"]
    parts = [
        p[0]["w"],
        torch.stack([p[l]["w_h"] if l == SKIP_LAYER else p[l]["w"]
                     for l in range(1, DEPTH)]),
        p[SKIP_LAYER]["w_pe"], params["feature"]["w"], views["w_feat"],
        *([views["w_pe"]] if view_pe else []),
        torch.stack([p[l]["b"] for l in range(DEPTH)]),
        params["feature"]["b"], *([views["b"]] if view_pe else []),
        params["alpha"]["w"], params["alpha"]["b"], params["rgb"]["w"],
        params["rgb"]["b"],
    ]
    return torch.cat([x.reshape(-1) for x in parts])


def unpack(flat, C, view_pe=True):
    """Flat packed vector -> {name: tensor view} per `_layout`."""
    layout = _layout(C, view_pe)
    offs = _offsets(layout)
    return {name: flat[offs[i]:offs[i + 1]].view(shape)
            for i, (name, shape) in enumerate(layout)}


def band_weights(barf_weights, barf_weights_views, device):
    """(14,) per-band encoding multipliers: the BARF weights, ones when off."""
    w = (torch.ones(L_PTS, device=device) if barf_weights is None
         else barf_weights.to(device=device, dtype=torch.float32))
    wv = (torch.ones(L_VIEWS, device=device) if barf_weights_views is None
          else barf_weights_views.to(device=device, dtype=torch.float32))
    return torch.cat([w.reshape(-1), wv.reshape(-1)]).contiguous()


def _pad32(x):
    return -(-x // 32) * 32


def prep_table(view_pe=True, compute_dtype="float32"):
    """The layout of the weights' wgmma copies (mirrors wl::prep_table in
    csrc/wgmma_layer.cuh, checked against the library's at load): ([(name,
    orient, row0, N, K, src, I, O)], rows). For each matrix W (I, O) at
    `src` in the packed vector, "fwd" holds B = W^T (N = O, K = I rounded up
    to 32), "bwd" B = W (N = I rounded up, K = O), zero past I; B is stored
    as K / KS stages of PREP_PARTS x N rows of KS values from row `row0`
    (TF32X3: a stage's big rows, then its small rows). Independent of C."""
    _mode(compute_dtype)
    layout = _layout(1, view_pe)
    off = dict(zip([name for name, _ in layout], _offsets(layout)))
    mats = [("w0", off["w0"], 63, WIDTH)]
    mats += [(f"wh{l}", off["wh"] + (l - 1) * WIDTH * WIDTH, WIDTH, WIDTH)
             for l in range(1, DEPTH)]
    mats += [("w5pe", off["w5pe"], 63, WIDTH), ("wf", off["wf"], WIDTH, WIDTH),
             ("wfv", off["wfv"], WIDTH, HEAD)]
    if view_pe:
        mats.append(("wvpe", off["wvpe"], 27, HEAD))
    ks, parts = PREP_KS[compute_dtype], PREP_PARTS[compute_dtype]
    table, rows = [], 0
    for orient in ("fwd", "bwd"):
        for name, src, I, O in mats:
            N, K = (O, _pad32(I)) if orient == "fwd" else (_pad32(I), O)
            table.append((name, orient, rows, N, K, src, I, O))
            rows += K // ks * parts * N
    return table, rows


def prep_buffer(view_pe, compute_dtype, device):
    """An empty buffer for the weights' wgmma copies: (rows, 64 B)."""
    rows = prep_table(view_pe, compute_dtype)[1]
    return torch.empty((rows, PREP_KS[compute_dtype]), device=device,
                       dtype=PREP_DTYPE[compute_dtype])


def tf32_big(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 does (ties away from zero, the
    low 13 bits zero): the big part of the TF32X3 split."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def prepare_weights_plain(packed, view_pe=True, compute_dtype="float32"):
    """The plain version of the weights' wgmma copies (wl::prep_kernel),
    laid out by `prep_table`: float32 (rows, 16) in "float32" (each stage's
    big = tf32_big(w) rows, then small = w - big), bfloat16 (rows, 32) in
    "bfloat16" (rounded to nearest even)."""
    table, _ = prep_table(view_pe, compute_dtype)
    ks = PREP_KS[compute_dtype]
    blocks = []
    for _, orient, _, N, K, src, I, O in table:
        W = packed[src:src + I * O].reshape(I, O)
        B = (torch.nn.functional.pad(W.t(), (0, K - I)) if orient == "fwd"
             else torch.nn.functional.pad(W, (0, 0, 0, N - I)))
        B = B.reshape(N, K // ks, ks).permute(1, 0, 2)  # (stages, N, KS)
        if compute_dtype == "float32":
            big = tf32_big(B)
            blocks.append(torch.stack([big, B - big], 1).reshape(-1, ks))
        else:
            blocks.append(B.to(torch.bfloat16).reshape(-1, ks))
    return torch.cat(blocks)


def prepare_weights(packed, C, view_pe=True, compute_dtype="float32"):
    """The weights' wgmma copies alone, for checking them against
    `prepare_weights_plain` and timing them (not counted: on the main path
    K1's and K3's launches write them). CUDA tensors only."""
    _check("packed", packed, (_offsets(_layout(C, view_pe))[-1],))
    prep = prep_buffer(view_pe, compute_dtype, packed.device)
    rc = _lib("fused_mlp_fwd").fused_mlp_prep(
        _ptr(packed), C, int(view_pe), _ptr(prep), _mode(compute_dtype),
        _stream())
    if rc:
        raise RuntimeError(f"fused_mlp_prep: CUDA error {rc}")
    return prep


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
    return libbuild.library_path(BUILD_DIR, name, NVCC_FLAGS,
                                 _source_files(name))


def build():
    """Compile every kernel source that has no current library, one nvcc
    process per source, all started together. Returns seconds taken."""
    t0 = time.perf_counter()
    todo = [(n, _target(n)) for n in SOURCES if not _target(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_LOG.update(libbuild.compile_libraries(
        [(n, [nvcc, *NVCC_FLAGS, str(CSRC / f"{n}.cu")], target)
         for n, target in todo], "kernel"))
    return time.perf_counter() - t0


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C functions of each library: name -> (argtypes, restype). Pointers and the
# stream are c_void_p (a bare int would pass as a 32-bit int).
_API = {
    "fused_mlp_fwd": {
        "fused_mlp_fwd": ([_P, _P, _I64, _I, _P, _P, _P, _I, _P, _I, _P], _I),
        "fused_mlp_layout": ([_I, _P], None),
        "fused_mlp_prep_table": ([_I, _I, _P, _I], _I),
        "fused_mlp_prep": ([_P, _I, _I, _P, _I, _P], _I)},
    "fused_mlp_bwd": {
        "fused_mlp_bwd": ([_P, _P, _I64, _I, _P, _P, _P, _P, _I, _I64, _P, _P,
                           _P, _P, _P, _I, _P, _I, _P], _I),
        "fused_mlp_tile": ([_P, _P, _I64, _I, _P, _P, _P, _P, _I, _I64, _P, _P,
                            _P, _P, _I, _P], _I),
        "fused_mlp_wgrad": ([_P, _P, _I64, _I, _P, _I, _P, _I, _P], _I),
        "fused_mlp_wgrad_jobs": ([_I, _P, _I], _I),
        "fused_mlp_bwd_scratch": ([_I64, _P], None)},
    "staged_mlp_fwd": {
        "staged_mlp_fwd": ([_P, _P, _I64, _I, _P, _P, _I, _P, _I, _P], _I),
        "staged_mlp_layout": ([_I, _P], None)},
    "staged_mlp_bwd": {
        "staged_mlp_bwd": ([_P, _P, _I64, _I, _P, _P, _P, _I, _I64, _P, _P,
                            _P, _P, _I, _P, _I, _P], _I),
        "staged_mlp_tile": ([_P, _P, _I64, _I, _P, _P, _P, _I, _I64, _P, _P,
                             _P, _I, _P], _I),
        "staged_mlp_wgrad": ([_P, _P, _I64, _I, _P, _I, _P, _I, _P], _I),
        "staged_mlp_wgrad_jobs": ([_I, _P, _I], _I),
        "staged_mlp_bwd_scratch": ([_I64, _I, _P], None)},
}
# the layout each library reports, checked against the Python one at load:
# name -> (C function, view_pe). K2 and K4 read the layouts of K1 and K3,
# from the same header (fmlp::offsets), so K1's and K3's libraries report
# them for both.
_LAYOUT_OF = {
    "fused_mlp_fwd": ("fused_mlp_layout", True),
    "staged_mlp_fwd": ("staged_mlp_layout", False),
}
# the weight-gradient job table each backward library reports, checked
# against `wgrad_jobs` at load: name -> (C function, view_pe)
_JOBS_OF = {
    "fused_mlp_bwd": ("fused_mlp_wgrad_jobs", True),
    "staged_mlp_bwd": ("staged_mlp_wgrad_jobs", False),
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
        fn, view_pe = _LAYOUT_OF[name]
        for C in (1, 3, 8, 127):
            _check_layout(getattr(lib, fn), _layout(C, view_pe), C)
    if name in _JOBS_OF:
        fn, view_pe = _JOBS_OF[name]
        for C in (1, 3, 7):
            _check_jobs(getattr(lib, fn), view_pe, C)
    if name == "fused_mlp_fwd":
        for view_pe in (True, False):
            for cd in MODES:
                _check_prep(lib.fused_mlp_prep_table, view_pe, cd)
    _libs[name] = lib
    return lib


def _table_rows(fn, arg, n_want, *mode):
    """The rows of 6 that a library's table function reports, given room for
    n_want of them; None when it has another count (it writes nothing
    then)."""
    got = (ctypes.c_int64 * (6 * n_want))()
    rows = fn(arg, *mode, got, n_want)
    if rows != n_want:
        return None
    return [list(got[6 * i:6 * i + 6]) for i in range(rows)]


def _check_prep(fn, view_pe, compute_dtype):
    want = [list(e[2:]) for e in prep_table(view_pe, compute_dtype)[0]]
    got = _table_rows(fn, int(view_pe), len(want), MODES[compute_dtype])
    if got != want:
        raise RuntimeError(f"wgmma weight copies mismatch (view_pe={view_pe}, "
                           f"{compute_dtype}): kernel {got} vs python {want}")


def _check_layout(fn, layout, C):
    want = _offsets(layout)
    got = (ctypes.c_int64 * len(want))()
    fn(C, got)
    if list(got) != want:
        raise RuntimeError(f"packed layout mismatch (C={C}): kernel {list(got)}"
                           f" vs python {want}")


def _check_jobs(fn, view_pe, C):
    products, thin = wgrad_jobs(C, view_pe)
    want = [list(j[1:]) for j in products + thin]
    got = _table_rows(fn, C, len(want))
    if got != want:
        raise RuntimeError(f"weight-gradient jobs mismatch (C={C}, view_pe="
                           f"{view_pe}): kernel {got} vs python {want}")


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


def check_prep(prep, view_pe, compute_dtype):
    """Raise unless `prep` is a buffer for the weights' wgmma copies."""
    rows = prep_table(view_pe, compute_dtype)[1]
    _check("prepared weights", prep, (rows, PREP_KS[compute_dtype]),
           PREP_DTYPE[compute_dtype])


def launch_fwd(packed, pts, vd, band, S, C, compute_dtype="float32", *, prep):
    """K1: pts (n, 3), vd (n / S, 3) -> raw (n, C+1). The launch also writes
    the weights' wgmma copies into `prep` (a `prep_buffer`), which K2
    reads."""
    mode = _mode(compute_dtype)
    n = pts.shape[0]
    if n == 0 or n % S:
        raise ValueError(f"point count {n} is not a positive multiple of S={S}")
    _check("packed", packed, (_offsets(_layout(C))[-1],))
    _check("pts", pts, (n, 3))
    _check("viewdirs", vd, (n // S, 3))
    _check("band", band, (L_PTS + L_VIEWS,))
    check_prep(prep, True, compute_dtype)
    lib = _lib("fused_mlp_fwd")
    out = torch.empty((n, C + 1), device=pts.device, dtype=torch.float32)
    rc = lib.fused_mlp_fwd(_ptr(pts), _ptr(vd), n, S, _ptr(packed), _ptr(prep),
                           _ptr(band), C, _ptr(out), mode, _stream())
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


def _bwd_args(packed, pts, vd, band, g, S, C, compute_dtype, prep):
    """Check K2's inputs; -> (mode, prep, n, n_pad, X, D, dpts, dvd)."""
    mode = _mode(compute_dtype)
    n = pts.shape[0]
    _check("packed", packed, (_offsets(_layout(C))[-1],))
    _check("pts", pts, (n, 3))
    _check("viewdirs", vd, (n // S, 3))
    _check("band", band, (L_PTS + L_VIEWS,))
    _check("cotangent", g, (n, C + 1))
    check_prep(prep, True, compute_dtype)
    dev = pts.device
    n_pad, x_scr, d_scr = bwd_scratch(n, dev)
    return (mode, prep, n, n_pad, x_scr, d_scr, torch.empty((n, 3), device=dev),
            torch.empty((n, 3), device=dev))


def launch_bwd(packed, pts, vd, band, g, S, C, splits=DEFAULT_SPLITS,
               compute_dtype="float32", *, prep):
    """K2: cotangent g (n, C+1) -> (d packed, d pts (n, 3), d vd per point
    (n, 3)); prep: the weights' wgmma copies K1's launch wrote."""
    if splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    mode, prep, n, n_pad, x_scr, d_scr, dpts, dvd = _bwd_args(
        packed, pts, vd, band, g, S, C, compute_dtype, prep)
    lib = _lib("fused_mlp_bwd")
    part = torch.empty((splits, packed.numel()), device=pts.device)
    dpacked = torch.empty_like(packed)
    rc = lib.fused_mlp_bwd(
        _ptr(pts), _ptr(vd), n, S, _ptr(packed), _ptr(prep), _ptr(band),
        _ptr(g), C, n_pad, _ptr(x_scr), _ptr(d_scr), _ptr(dpts), _ptr(dvd),
        _ptr(part), splits, _ptr(dpacked), mode, _stream())
    if rc:
        raise RuntimeError(f"fused_mlp_bwd: CUDA error {rc}")
    LAUNCHES[launch_key("fused_mlp_bwd", compute_dtype)] += 1
    return dpacked, dpts, dvd


def run_tile(packed, pts, vd, band, g, S, C, compute_dtype="float32", *,
             prep):
    """K2's tile pass alone (pass (a), for timing it apart; not counted: the
    main path runs it inside K2) -> (n_pad, X, D, d pts, d vd per point)."""
    mode, prep, n, n_pad, x_scr, d_scr, dpts, dvd = _bwd_args(
        packed, pts, vd, band, g, S, C, compute_dtype, prep)
    rc = _lib("fused_mlp_bwd").fused_mlp_tile(
        _ptr(pts), _ptr(vd), n, S, _ptr(packed), _ptr(prep), _ptr(band),
        _ptr(g), C, n_pad, _ptr(x_scr), _ptr(d_scr), _ptr(dpts), _ptr(dvd),
        mode, _stream())
    if rc:
        raise RuntimeError(f"fused_mlp_tile: CUDA error {rc}")
    return n_pad, x_scr, d_scr, dpts, dvd


# rows of the backward scratch (fmlp::Scratch in
# csrc/fused_mlp_bwd_common.cuh), [row][point] with row stride n_pad
X_H = 64                              # after the point encoding (64 rows)
X_F = X_H + DEPTH * WIDTH
X_VPE = X_F + WIDTH                   # K2's view encoding (32 rows)
D_F = DEPTH * WIDTH                   # after d pre-activation of layers 0..7
D_HV = D_F + WIDTH
D_G = D_HV + HEAD                     # the cotangent's C + 1 rows


def wgrad_jobs(C, view_pe=True):
    """The weight-gradient pass's job table (mirrors fmlp::make_jobs,
    checked against the library's at load): (matrix products, thin jobs),
    each a list of (name, x_row0, I, d_row0, O, out_off, bias_off): the
    packed gradient's entries [out_off, out_off + I O) are X[x_row0:+I] @
    D[d_row0:+O]^T over the scratch's points, row-major; x_row0 = -1 stands
    for a row of ones (a bias); bias_off >= 0: the entries [bias_off,
    bias_off + O) are the sums of those D rows (the kernel forms them while
    it splits D). view_pe as for `_layout`: K2's table (12 products), else
    K4's (11, no wvpe)."""
    layout = _layout(C, view_pe)
    off = dict(zip([name for name, _ in layout], _offsets(layout)))
    x_hv = X_VPE + (32 if view_pe else 0)
    h7 = X_H + (DEPTH - 1) * WIDTH
    products = [("w0", 0, 63, 0, WIDTH, off["w0"], off["b"])]
    products += [(f"wh{l + 1}", X_H + l * WIDTH, WIDTH, (l + 1) * WIDTH, WIDTH,
                  off["wh"] + l * WIDTH * WIDTH, off["b"] + (l + 1) * WIDTH)
                 for l in range(DEPTH - 1)]
    products += [("w5pe", 0, 63, SKIP_LAYER * WIDTH, WIDTH, off["w5pe"], -1),
                 ("wf", h7, WIDTH, D_F, WIDTH, off["wf"], off["bf"]),
                 ("wfv", X_F, WIDTH, D_HV, HEAD, off["wfv"],
                  off["bv"] if view_pe else -1)]
    if view_pe:
        products.append(("wvpe", X_VPE, 27, D_HV, HEAD, off["wvpe"], -1))
    thin = [("wa", h7, WIDTH, D_G + C, 1, off["wa"], -1),
            ("ba", -1, 1, D_G + C, 1, off["ba"], -1),
            ("wrgb", x_hv, HEAD, D_G, C, off["wrgb"], -1),
            ("brgb", -1, 1, D_G, C, off["brgb"], -1)]
    return products, thin


def wgrad_ranges(C, view_pe=True):
    """(name, offset, size) of every range of the packed gradient that the
    weight-gradient pass writes, by `wgrad_jobs`: each product, each bias
    of its D rows, each thin job."""
    products, thin = wgrad_jobs(C, view_pe)
    out = [(j[0], j[5], j[2] * j[4]) for j in products + thin]
    return out + [(f"bias of {j[0]}", j[6], j[4]) for j in products if j[6] >= 0]


def wgrad_plain(x_scr, d_scr, n_pad, C, view_pe=True, compute_dtype="float32"):
    """The weight-gradient pass's plain version: the packed gradient from a
    scratch by `wgrad_jobs`, in float64; in "bfloat16" the matrix products'
    operands are rounded to bf16 first, as the kernel does (the thin jobs
    read fp32 in both modes)."""
    _mode(compute_dtype)
    X, D = x_scr.view(-1, n_pad), d_scr.view(-1, n_pad)
    products, thin = wgrad_jobs(C, view_pe)
    out = torch.zeros(_offsets(_layout(C, view_pe))[-1], dtype=torch.float64,
                      device=x_scr.device)
    for q, (_, x0, I, d0, O, off, bias) in enumerate(products + thin):
        d = D[d0:d0 + O]
        if bias >= 0:
            out[bias:bias + O] = d.double().sum(dim=1)
        x = X[x0:x0 + I] if x0 >= 0 else torch.ones_like(d[:1])
        if q < len(products) and compute_dtype == "bfloat16":
            x, d = (t.to(torch.bfloat16) for t in (x, d))
        out[off:off + I * O] = (x.double() @ d.double().t()).reshape(-1)
    return out


def run_wgrad(x_scr, d_scr, n_pad, C, splits=DEFAULT_SPLITS,
              compute_dtype="float32", view_pe=True):
    """The weight-gradient pass alone (K2's table, or K4's with view_pe
    False) on a scratch from `bwd_scratch` / `staged_mlp.bwd_scratch`, for
    timing and checking it apart (not counted: the main path runs it inside
    K2 and K4). On the CPU: the plain version, `wgrad_plain`, in fp32."""
    if x_scr.device.type == "cpu":
        return wgrad_plain(x_scr, d_scr, n_pad, C, view_pe,
                           compute_dtype).float()
    _check("X scratch", x_scr, tuple(x_scr.shape))
    _check("D scratch", d_scr, tuple(d_scr.shape))
    if splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    part = torch.empty((splits, _offsets(_layout(C, view_pe))[-1]),
                       device=x_scr.device)
    dpacked = torch.empty(part.shape[1], device=x_scr.device)
    name = "fused_mlp_wgrad" if view_pe else "staged_mlp_wgrad"
    lib = _lib("fused_mlp_bwd" if view_pe else "staged_mlp_bwd")
    rc = getattr(lib, name)(
        _ptr(x_scr), _ptr(d_scr), n_pad, C, _ptr(part), splits,
        _ptr(dpacked), _mode(compute_dtype), _stream())
    if rc:
        raise RuntimeError(f"{name}: CUDA error {rc}")
    return dpacked


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, pts, vd, band, S, C, splits, compute_dtype):
        prep = prep_buffer(True, compute_dtype, pts.device)
        out = launch_fwd(packed, pts, vd, band, S, C, compute_dtype, prep=prep)
        ctx.save_for_backward(packed, pts, vd, band, prep)
        ctx.S, ctx.C, ctx.splits, ctx.cd = S, C, splits, compute_dtype
        return out

    @staticmethod
    def backward(ctx, g):
        packed, pts, vd, band, prep = ctx.saved_tensors
        with profiling.span("mlp.bwd"):
            dpacked, dpts, dvd_pt = launch_bwd(packed, pts, vd, band,
                                               g.contiguous(), ctx.S, ctx.C,
                                               ctx.splits, ctx.cd, prep=prep)
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
    """The card path: the packing, the band weights, K1 and (through
    autograd) K2."""
    R, S, _ = pts.shape
    C = params["rgb"]["w"].shape[1]
    packed = pack_params(params)
    band = band_weights(barf_weights, barf_weights_views, pts.device)
    out = _FusedMLP.apply(packed, pts.reshape(R * S, 3).contiguous(),
                          viewdirs.contiguous(), band, S, C, splits,
                          compute_dtype)
    return out.view(R, S, C + 1)
