"""The port's four MLP kernel libraries and their contract with csrc/.

K1/K2 (csrc/fused_mlp_{fwd,bwd}.cu, behind ops/fused_mlp.py) and K3/K4
(csrc/staged_mlp_{fwd,bwd}.cu, behind ops/staged_mlp.py) are built here
with nvcc for sm_90a into shared libraries with a plain C interface and
loaded through ctypes, each library's own tables checked against their
Python mirrors at load. This module holds the formats the kernels share
with Python and their plain versions, and launches both pairs through one
checked call and one autograd Function.

Weights are packed into one flat vector (`layout`), each matrix in its
(fan_in, fan_out) orientation with its columns in natural order. The
packing is differentiable (views and torch.cat), so the kernel's flat
gradient, written in the same layout, flows back to each parameter. K3/K4
use the same layout without the view-encoding entries (view_pe=False). The
layer products read the weights' wgmma copies instead (`prep_table`): W^T
for the forward, W for the backward's data gradients, K-major, cut into
stages, split into TF32 big and small parts (TF32X3) or rounded to bf16
(BF16). K1's (K3's) launch writes them into a buffer the autograd Function
keeps for K2 (K4); `prepare_weights_plain` is their plain version. The
heads read the packed vector. The BARF band weights get no gradient: they
are step functions of the iteration counter.

When autograd records a K1 call, K1 also keeps its forward for K2 (every
activation as a row of K2's scratch, the ReLU sign words: `kept_scratch`),
so K2's tile pass starts at the backward; under no_grad K1 keeps nothing.
K3/K4 keep nothing: K4's tile pass runs K3's forward again.
"""

from __future__ import annotations

import ctypes
import math
import os
import re
import shutil
import time
from pathlib import Path
from typing import NamedTuple

import torch

from benerf_tpu_torch.core import libbuild, profiling

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

# launches on the card of the main path (K1-K4), one per wrapper call that
# launched its kernel(s), under the library's name in "float32" and under
# name + "_bf16" in "bfloat16"; "fused_mlp_fwd_kept" (+ "_bf16") counts the K1
# launches among them that kept their forward for K2 (on the train path as
# many as K2's launches, none under no_grad)
LAUNCHES = {"fused_mlp_fwd": 0, "fused_mlp_bwd": 0,
            "fused_mlp_fwd_bf16": 0, "fused_mlp_bwd_bf16": 0,
            "fused_mlp_fwd_kept": 0, "fused_mlp_fwd_kept_bf16": 0,
            "staged_mlp_fwd": 0, "staged_mlp_bwd": 0,
            "staged_mlp_fwd_bf16": 0, "staged_mlp_bwd_bf16": 0}

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fused_mlp_fwd", "fused_mlp_bwd", "staged_mlp_fwd", "staged_mlp_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# build output of the last build (ptxas register / spill report), by source
BUILD_LOG: dict = {}

_libs: dict = {}


class Pair(NamedTuple):
    """What differs between the two kernel pairs. K1/K2 encode the view
    directions themselves and take the BARF band weights (view_pe); K3/K4
    read a per-ray view bias made outside instead and leave its gradient
    per point in their scratch."""
    name: str        # prefix of the libraries and of their C functions
    view_pe: bool
    ray: str         # the per-ray input, (R, ray_width)
    ray_width: int
    max_c: int       # the widest head, C (C + 1 output rows)


FUSED = Pair("fused_mlp", True, "viewdirs", 3, 7)    # C + 1 <= G_PAD
STAGED = Pair("staged_mlp", False, "vb", HEAD, HEAD - 1)
PAIRS = {True: FUSED, False: STAGED}    # by view_pe


def supports(params, pair) -> bool:
    """The standard BeNeRF trunk with viewdirs that the kernels are built
    for, a head of at most pair.max_c channels and, for K1/K2, 27
    view-encoding rows (pallas_mlp_t.supports, pallas_mlp.supports)."""
    try:
        if "views" not in params or len(params["pts"]) != DEPTH:
            return False
        return (tuple(params["pts"][0]["w"].shape) == (63, WIDTH)
                and "w_pe" in params["pts"][SKIP_LAYER]
                and tuple(params["views"]["w_feat"].shape) == (WIDTH, HEAD)
                and (not pair.view_pe
                     or tuple(params["views"]["w_pe"].shape) == (27, HEAD))
                and params["rgb"]["w"].shape[1] <= pair.max_c)
    except (KeyError, IndexError, TypeError):
        return False


def layout(C, view_pe=True):
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


def offsets(entries):
    """Each entry's offset in the packed vector, then its size."""
    offs, o = [], 0
    for _, shape in entries:
        offs.append(o)
        o += math.prod(shape)
    return offs + [o]


def packed_size(C, view_pe=True):
    return offsets(layout(C, view_pe))[-1]


def _offset_of(C, view_pe):
    entries = layout(C, view_pe)
    return dict(zip([name for name, _ in entries], offsets(entries)))


def pack_params(params, view_pe=True):
    """Parameter dict -> flat packed vector (differentiable); view_pe as
    for `layout`."""
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
    """Flat packed vector -> {name: tensor view} per `layout`."""
    entries = layout(C, view_pe)
    offs = offsets(entries)
    return {name: flat[offs[i]:offs[i + 1]].view(shape)
            for i, (name, shape) in enumerate(entries)}


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
    mode_of(compute_dtype)
    off = _offset_of(1, view_pe)
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
    _check("packed", packed, (packed_size(C, view_pe),))
    prep = prep_buffer(view_pe, compute_dtype, packed.device)
    call("fused_mlp_fwd", "fused_mlp_prep", _ptr(packed), C, int(view_pe),
         _ptr(prep), mode=mode_of(compute_dtype))
    return prep


# rows of the backward scratch (fmlp::Scratch in
# csrc/fused_mlp_wg.cuh), [row][point] with row stride n_pad
X_H = 64                              # after the point encoding (64 rows)
X_F = X_H + DEPTH * WIDTH
X_VPE = X_F + WIDTH                   # K2's view encoding (32 rows)
D_F = DEPTH * WIDTH                   # after d pre-activation of layers 0..7
D_HV = D_F + WIDTH
D_G = D_HV + HEAD                     # the cotangent's C + 1 rows
G_PAD = 8                             # K2's cotangent rows (C + 1 <= 8)
# "bfloat16": the fp32 rows (fmlp::Side) and the rows with a tile sum
SIDE_H7 = 0                           # h7
SIDE_HV = SIDE_H7 + WIDTH             # hv
SIDE_KEPT = SIDE_HV + HEAD            # K2: the rows K1 keeps
SIDE_DHV = SIDE_KEPT                  # K4: d vb per point (128 rows)
BIAS_ROWS = D_G                       # D's rows 0..2432: the products' D rows
# ReLU sign words of a 64-point tile (fmlp::SIGN_WORDS): h0..h7 two each and
# hv, a word of each for every consumer thread of the tile's block
SIGN_WORDS = (2 * DEPTH + 1) * 256


def side_g(view_pe=True):
    """The first cotangent row among the "bfloat16" scratch's fp32 rows: of
    K2's own `gside` (row 0), of K4's `side` (after d vb)."""
    return 0 if view_pe else SIDE_DHV + HEAD


def x_rows_bf16(view_pe=True):
    """X's rows in the "bfloat16" scratch: those the matrix products read."""
    return X_VPE + (32 if view_pe else 0)


class Scratch(NamedTuple):
    """The backward scratch of K2 or K4 for n_pad points (a multiple of
    TILE), in the format of compute_dtype (csrc/fused_mlp_bwd_common.cuh),
    row-major [row][point] with row stride n_pad unless named otherwise:
      - "float32": x, d fp32, every row (X_*, D_*); side, bsum, gside None;
      - "bfloat16": x, d bf16, the rows the matrix products read (X's first
        `x_rows_bf16`, D's first D_G), tile-blocked: [tile][row][TILE
        points] (`rows` gathers them); side fp32, the SIDE_* rows (h7, hv,
        and K4's d vb per point and cotangent); gside fp32, K2's cotangent
        rows; bsum fp32 (n_pad / TILE, BIAS_ROWS), each D row's sum over
        each 64-point tile (the biases).
    K2's x, side and signs (int32 (n_pad / TILE, SIGN_WORDS), the ReLU sign
    words of every tile) are what K1 kept (`kept_scratch`: d None); its
    backward adds d, bsum and gside. K4 keeps its signs in shared memory."""
    n_pad: int
    compute_dtype: str
    x: torch.Tensor
    d: torch.Tensor | None
    side: torch.Tensor | None = None
    bsum: torch.Tensor | None = None
    signs: torch.Tensor | None = None
    gside: torch.Tensor | None = None

    def nbytes(self):
        return sum(t.numel() * t.element_size()
                   for t in (self.x, self.d, self.side, self.bsum, self.signs,
                             self.gside) if t is not None)

    def rows(self, name):
        """x or d ("x", "d") as [row][point]: a view of the "float32"
        format, a copy of the "bfloat16" format's tile blocks."""
        t = getattr(self, name)
        if self.side is None:
            return t.view(-1, self.n_pad)
        return t.view(self.n_pad // TILE, -1, TILE).transpose(0, 1).reshape(-1, self.n_pad)


class Sizes(NamedTuple):
    """Elements of each array of a `Scratch` (0 where the format has none),
    and K4's first row of d vb per point (of d in "float32", of side in
    "bfloat16"; None for K2)."""
    x: int
    d: int
    side: int
    bsum: int
    signs: int = 0
    gside: int = 0
    dvb: int | None = None


# the arrays of K2's scratch that K1 writes when it keeps its forward
KEPT = ("x", "side", "signs")


def scratch_sizes(n_pad, C, view_pe=True, compute_dtype="float32"):
    """The `Sizes` of the scratch (`Scratch`) for n_pad points; mirrors
    fused_mlp_kept (K2's `KEPT` arrays) and fused_mlp_bwd_scratch (the rest),
    staged_mlp_bwd_scratch (K4's), checked at load."""
    mode_of(compute_dtype)
    x_hv = x_rows_bf16(view_pe)
    g_rows = G_PAD if view_pe else C + 1
    signs = n_pad // TILE * SIGN_WORDS if view_pe else 0
    if compute_dtype == "float32":
        return Sizes((x_hv + HEAD) * n_pad, (D_G + g_rows) * n_pad, 0, 0, signs,
                     dvb=None if view_pe else D_HV)
    bsum = n_pad // TILE * BIAS_ROWS
    if view_pe:
        return Sizes(x_hv * n_pad, D_G * n_pad, SIDE_KEPT * n_pad, bsum, signs,
                     g_rows * n_pad)
    return Sizes(x_hv * n_pad, D_G * n_pad, (side_g(False) + g_rows) * n_pad,
                 bsum, dvb=SIDE_DHV)


def scratch_bytes(n_pad, C, view_pe=True, compute_dtype="float32", part=None):
    """Bytes of the scratch for n_pad points (`Scratch.nbytes`): K2's
    19,872 B a point in "float32" (fp32 X and D, every row), 11,384 B at
    C = 3 in "bfloat16" (the products' rows as bf16, 392 fp32 side rows, a
    tile sum of each of D's 2,432 product rows a 64-point tile), and 272 B
    of sign words besides. part "kept": K2's `KEPT` arrays alone (10,384
    and 6,608 B a point), "backward": the rest (9,760 and 5,048)."""
    sizes = scratch_sizes(n_pad, C, view_pe, compute_dtype)._asdict()
    wide = 4 if compute_dtype == "float32" else 2
    names = {None: ("x", "d", "side", "bsum", "signs", "gside"), "kept": KEPT,
             "backward": ("d", "bsum", "gside")}[part]
    return sum(sizes[k] * (wide if k in ("x", "d") else 4) for k in names)


def kept_scratch(n, device, compute_dtype="float32"):
    """What K1 keeps for K2 of n points (`KEPT`: x, side, signs of a
    `Scratch` whose d is None), uninitialised: the launch fills it."""
    n_pad = -(-n // TILE) * TILE
    sizes = scratch_sizes(n_pad, 1, True, compute_dtype)
    dt = torch.float32 if compute_dtype == "float32" else torch.bfloat16
    side = (None if compute_dtype == "float32"
            else torch.empty(sizes.side, device=device))
    signs = torch.empty((n_pad // TILE, SIGN_WORDS), device=device,
                        dtype=torch.int32)
    return Scratch(n_pad, compute_dtype, torch.empty(sizes.x, device=device, dtype=dt),
                   None, side, signs=signs)


def bwd_scratch(pair, n, C, device, compute_dtype="float32", kept=None):
    """K2's or K4's scratch for n points and C channels in the format of
    compute_dtype, a `Scratch` sized by the library, uninitialised: K4's
    whole, K2's on the arrays K1 kept (`kept`, from `kept_scratch`)."""
    n_pad = -(-n // TILE) * TILE
    _check_kept(pair, kept, n, compute_dtype)
    fn = getattr(library(f"{pair.name}_bwd"), f"{pair.name}_bwd_scratch")
    sizes = _scratch_report(fn, pair.view_pe, C, compute_dtype, n_pad)
    dt = torch.float32 if compute_dtype == "float32" else torch.bfloat16
    fp32 = compute_dtype == "float32"

    def empty(k, dtype=torch.float32):
        return None if fp32 and k in ("side", "bsum", "gside") else torch.empty(
            sizes[k], device=device, dtype=dtype)

    bsum = None if fp32 else empty("bsum").view(-1, BIAS_ROWS)
    if pair.view_pe:
        return kept._replace(d=empty("d", dt), bsum=bsum, gside=empty("gside"))
    return Scratch(n_pad, compute_dtype, empty("x", dt), empty("d", dt),
                   empty("side"), bsum)


def wgrad_jobs(C, view_pe=True, compute_dtype="float32"):
    """The weight-gradient pass's job table (mirrors fmlp::make_jobs,
    checked against the library's at load): (matrix products, thin jobs),
    each a list of (name, x_row0, I, d_row0, O, out_off, bias_off): the
    packed gradient's entries [out_off, out_off + I O) are X[x_row0:+I] @
    D[d_row0:+O]^T over the scratch's points, row-major; x_row0 = -1 stands
    for a row of ones (a bias); bias_off >= 0: the entries [bias_off,
    bias_off + O) are the sums of those D rows. view_pe as for `layout`:
    K2's table (12 products), else K4's (11, no wvpe). In "bfloat16" the
    thin jobs' rows are the scratch's side rows (X and D both), the
    products' the same (K2's cotangent rows: its `gside`)."""
    off = _offset_of(C, view_pe)
    x_hv = X_VPE + (32 if view_pe else 0)
    h7 = X_H + (DEPTH - 1) * WIDTH
    d_g = D_G
    if mode_of(compute_dtype):
        x_hv, d_g = SIDE_HV, side_g(view_pe)
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
    if mode_of(compute_dtype):
        h7 = SIDE_H7
    thin = [("wa", h7, WIDTH, d_g + C, 1, off["wa"], -1),
            ("ba", -1, 1, d_g + C, 1, off["ba"], -1),
            ("wrgb", x_hv, HEAD, d_g, C, off["wrgb"], -1),
            ("brgb", -1, 1, d_g, C, off["brgb"], -1)]
    return products, thin


def wgrad_ranges(C, view_pe=True):
    """(name, offset, size) of every range of the packed gradient that the
    weight-gradient pass writes, by `wgrad_jobs`: each product, each bias
    of its D rows, each thin job."""
    products, thin = wgrad_jobs(C, view_pe)
    out = [(j[0], j[5], j[2] * j[4]) for j in products + thin]
    return out + [(f"bias of {j[0]}", j[6], j[4]) for j in products if j[6] >= 0]


def wgrad_plain(scr, C, view_pe=True, compute_dtype=None):
    """The weight-gradient pass's plain version: the packed gradient from a
    `Scratch` by `wgrad_jobs` in its format, in float64. The matrix
    products read bf16 operands in "bfloat16" (compute_dtype, by default
    the scratch's; an fp32 scratch is rounded first, as the pass rounded it
    before the bf16 format); the thin jobs read fp32; the biases are the
    sums of D's fp32 rows, or of the bf16 format's tile sums."""
    cd = compute_dtype or scr.compute_dtype
    if mode_of(cd) < mode_of(scr.compute_dtype):
        raise ValueError(f"a {scr.compute_dtype} scratch holds no {cd} operands")
    n_pad = scr.n_pad
    X, D = scr.rows("x"), scr.rows("d")
    bf16 = scr.side is not None
    products, thin = wgrad_jobs(C, view_pe, scr.compute_dtype)
    out = torch.zeros(packed_size(C, view_pe), dtype=torch.float64,
                      device=scr.x.device)
    for _, x0, I, d0, O, off, bias in products:
        d = D[d0:d0 + O]
        if bias >= 0:
            out[bias:bias + O] = (scr.bsum[:, d0:d0 + O].double().sum(0) if bf16
                                  else d.double().sum(dim=1))
        x = X[x0:x0 + I]
        if cd == "bfloat16":
            x, d = (t.to(torch.bfloat16) for t in (x, d))
        out[off:off + I * O] = (x.double() @ d.double().t()).reshape(-1)
    Xt, Dt = X, D
    if bf16:
        Xt = scr.side.view(-1, n_pad)
        Dt = Xt if scr.gside is None else scr.gside.view(-1, n_pad)
    for _, x0, I, d0, O, off, _ in thin:
        d = Dt[d0:d0 + O].double()
        x = Xt[x0:x0 + I].double() if x0 >= 0 else torch.ones_like(d[:1])
        out[off:off + I * O] = (x @ d.t()).reshape(-1)
    return out


def bf16_scratch_plain(scr, C, view_pe=True):
    """The "bfloat16" format of a "float32" `Scratch` (the plain version of
    what K1 keeps and the tile pass writes in BF16 mode): the products' rows
    rounded to bf16 (rn) and tile-blocked, the side rows copied (K2: h7 and
    hv to side, the cotangent to gside), each D row's tile sums in float64
    rounded to fp32; the sign words as they are."""
    if scr.compute_dtype != "float32":
        raise ValueError("bf16_scratch_plain takes a float32 scratch")
    n_pad = scr.n_pad
    X, D = scr.x.view(-1, n_pad), scr.d.view(-1, n_pad)
    x_hv = x_rows_bf16(view_pe)
    g_rows = G_PAD if view_pe else C + 1
    side = [X[X_H + (DEPTH - 1) * WIDTH:X_F], X[x_hv:x_hv + HEAD]]
    if not view_pe:
        side.append(D[D_HV:D_G])
    g = D[D_G:D_G + g_rows]
    tiles = n_pad // TILE
    bsum = D[:D_G].double().view(D_G, tiles, TILE).sum(-1).float()

    def blocked(rows):
        return rows.to(torch.bfloat16).view(-1, tiles, TILE).transpose(0, 1).reshape(-1)

    return Scratch(n_pad, "bfloat16", blocked(X[:x_hv]), blocked(D[:D_G]),
                   torch.cat(side + ([] if view_pe else [g])).reshape(-1),
                   bsum.t().contiguous(), scr.signs,
                   g.reshape(-1).clone() if view_pe else None)


def run_wgrad(scr, C, splits=DEFAULT_SPLITS, view_pe=True):
    """The weight-gradient pass alone (K2's table, or K4's with view_pe
    False) on a `Scratch` (from `bwd_scratch` or `bf16_scratch_plain`), in
    the mode of its format, for timing and checking it apart (not counted:
    the main path runs it inside K2 and K4). On the CPU: the plain version,
    `wgrad_plain`, in fp32. splits: point-axis chunks of the reduction."""
    if scr.x.device.type == "cpu":
        return wgrad_plain(scr, C, view_pe).float()
    dt = torch.float32 if scr.compute_dtype == "float32" else torch.bfloat16
    _check("X scratch", scr.x, tuple(scr.x.shape), dt)
    _check("D scratch", scr.d, tuple(scr.d.shape), dt)
    if splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    part = torch.empty((splits, packed_size(C, view_pe)), device=scr.x.device)
    dpacked = torch.empty(part.shape[1], device=scr.x.device)
    name = PAIRS[view_pe].name
    call(f"{name}_bwd", f"{name}_wgrad", _ptr(scr.x), _ptr(scr.d),
         _ptr(scr.side), _ptr(scr.bsum), *([_ptr(scr.gside)] if view_pe else []),
         scr.n_pad, C, _ptr(part), splits, _ptr(dpacked),
         mode=mode_of(scr.compute_dtype))
    return dpacked


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
# stream are c_void_p (a bare int would pass as a 32-bit int). Every launch
# takes the mode and the stream last and returns a CUDA error code (`call`).
_API = {
    "fused_mlp_fwd": {
        "fused_mlp_fwd": ([_P, _P, _I64, _I, _P, _P, _P, _I, _P, _P, _P, _P,
                           _I, _P], _I),
        "fused_mlp_kept": ([_I64, _I, _P], None),
        "fused_mlp_layout": ([_I, _P], None),
        "fused_mlp_prep_table": ([_I, _I, _P, _I], _I),
        "fused_mlp_prep": ([_P, _I, _I, _P, _I, _P], _I)},
    "fused_mlp_bwd": {
        "fused_mlp_bwd": ([_P, _P, _I64, _I, _P, _P, _P, _P, _I, _I64, _P, _P,
                           _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P], _I),
        "fused_mlp_tile": ([_P, _P, _I64, _I, _P, _P, _P, _P, _I, _I64, _P, _P,
                            _P, _P, _P, _P, _P, _P, _I, _P], _I),
        "fused_mlp_wgrad": ([_P, _P, _P, _P, _P, _I64, _I, _P, _I, _P, _I, _P],
                            _I),
        "fused_mlp_wgrad_jobs": ([_I, _I, _P, _I], _I),
        "fused_mlp_bwd_scratch": ([_I64, _I, _P], None)},
    "staged_mlp_fwd": {
        "staged_mlp_fwd": ([_P, _P, _I64, _I, _P, _P, _I, _P, _I, _P], _I),
        "staged_mlp_layout": ([_I, _P], None)},
    "staged_mlp_bwd": {
        "staged_mlp_bwd": ([_P, _P, _I64, _I, _P, _P, _P, _I, _I64, _P, _P,
                            _P, _P, _P, _P, _I, _P, _I, _P], _I),
        "staged_mlp_tile": ([_P, _P, _I64, _I, _P, _P, _P, _I, _I64, _P, _P,
                             _P, _P, _P, _I, _P], _I),
        "staged_mlp_wgrad": ([_P, _P, _P, _P, _I64, _I, _P, _I, _P, _I, _P], _I),
        "staged_mlp_wgrad_jobs": ([_I, _I, _P, _I], _I),
        "staged_mlp_bwd_scratch": ([_I64, _I, _I, _P], None)},
}
# the layout each library reports, checked against the Python one at load:
# name -> (C function, view_pe). K2 and K4 read the layouts of K1 and K3,
# from the same header (fmlp::offsets), so K1's and K3's libraries report
# them for both.
_LAYOUT_OF = {
    "fused_mlp_fwd": ("fused_mlp_layout", True),
    "staged_mlp_fwd": ("staged_mlp_layout", False),
}
# the weight-gradient job table and the scratch sizes each backward library
# reports (K2's library the arrays K1 does not keep), checked against
# `wgrad_jobs` and `scratch_sizes` at load: name -> (jobs C function,
# view_pe, scratch C function)
_JOBS_OF = {
    "fused_mlp_bwd": ("fused_mlp_wgrad_jobs", True, "fused_mlp_bwd_scratch"),
    "staged_mlp_bwd": ("staged_mlp_wgrad_jobs", False, "staged_mlp_bwd_scratch"),
}


def library(name):
    """The loaded library of csrc/{name}.cu, built first if needed, with
    the tables it reports checked against their Python mirrors."""
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
            want = offsets(layout(C, view_pe))
            got = (ctypes.c_int64 * len(want))()
            getattr(lib, fn)(C, got)
            _expect(f"packed layout (C={C})", list(got), want)
    if name in _JOBS_OF:
        fn, view_pe, fn_scratch = _JOBS_OF[name]
        for cd in MODES:
            for C in (1, 3, 7):
                what = f"(C={C}, view_pe={view_pe}, {cd})"
                products, thin = wgrad_jobs(C, view_pe, cd)
                want = [list(j[1:]) for j in products + thin]
                _expect(f"weight-gradient jobs {what}", _table_rows(
                    getattr(lib, fn), C, len(want), MODES[cd]), want)
                got = _scratch_report(getattr(lib, fn_scratch), view_pe, C,
                                      cd, 3 * TILE)
                _expect(f"backward scratch {what}", got, _sizes_of(
                    got, 3 * TILE, C, view_pe, cd))
    if name == "fused_mlp_fwd":
        for cd in MODES:
            got = _kept_report(lib.fused_mlp_kept, cd, 3 * TILE)
            _expect(f"kept forward ({cd})", got, _sizes_of(got, 3 * TILE, 1,
                                                           True, cd))
        for view_pe in (True, False):
            for cd in MODES:
                want = [list(e[2:]) for e in prep_table(view_pe, cd)[0]]
                _expect(f"wgmma weight copies (view_pe={view_pe}, {cd})",
                        _table_rows(lib.fused_mlp_prep_table, int(view_pe),
                                    len(want), MODES[cd]), want)
    _libs[name] = lib
    return lib


def _expect(what, got, want):
    if got != want:
        raise RuntimeError(f"{what} mismatch: kernel {got} vs python {want}")


def _table_rows(fn, arg, n_want, *mode):
    """The rows of 6 that a library's table function reports, given room for
    n_want of them; None when it has another count (it writes nothing
    then)."""
    got = (ctypes.c_int64 * (6 * n_want))()
    rows = fn(arg, *mode, got, n_want)
    if rows != n_want:
        return None
    return [list(got[6 * i:6 * i + 6]) for i in range(rows)]


def _scratch_report(fn, view_pe, C, compute_dtype, n_pad):
    """A backward library's scratch sizes, by `Sizes` field: K2's arrays
    that K1 does not keep (d, gside, bsum elements), K4's every array and
    its first d vb row."""
    got = (ctypes.c_int64 * 5)()
    if view_pe:
        fn(n_pad, MODES[compute_dtype], got)
        return dict(zip(("d", "gside", "bsum"), got[:3]))
    fn(n_pad, C, MODES[compute_dtype], got)
    return dict(zip(("x", "d", "side", "bsum", "dvb"), got))


def _kept_report(fn, compute_dtype, n_pad):
    """K1's library's sizes of what it keeps, by `Sizes` field (`KEPT`)."""
    got = (ctypes.c_int64 * 3)()
    fn(n_pad, MODES[compute_dtype], got)
    return dict(zip(KEPT, got))


def _sizes_of(report, n_pad, C, view_pe, compute_dtype):
    """The Python mirror's `Sizes` of the fields a library report has."""
    sizes = scratch_sizes(n_pad, C, view_pe, compute_dtype)
    return {k: getattr(sizes, k) for k in report}


# ---- launches -------------------------------------------------------------


def _ptr(t):
    """A tensor's data pointer; None -> a null pointer."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _check(name, t, shape, dtype=torch.float32):
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} CUDA tensor, got "
                         f"{t.dtype} on {t.device} (contiguous="
                         f"{t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


def mode_of(compute_dtype):
    """The kernels' operand mode of compute_dtype; ValueError for any
    other."""
    if compute_dtype not in MODES:
        raise ValueError(f"compute_dtype must be one of {sorted(MODES)}, got "
                         f"{compute_dtype!r}")
    return MODES[compute_dtype]


def call(lib, fn, *args, mode, count=False):
    """C function `fn` of library `lib` on `args`, the mode and the current
    stream; a nonzero return (a CUDA error) raises. count: a launch of the
    main path, counted in LAUNCHES."""
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rc = getattr(library(lib), fn)(*args, mode, stream)
    if rc:
        raise RuntimeError(f"{fn}: CUDA error {rc}")
    if count:
        LAUNCHES[_key(lib, mode)] += 1


def _key(name, mode):
    """A LAUNCHES key: the name in "float32" (mode 0), name + "_bf16" in
    "bfloat16"."""
    return name if mode == 0 else f"{name}_bf16"


def _launch_args(pair, packed, pts, ray, band, S, C, compute_dtype, prep,
                 g=None):
    """Check a launch's inputs (g: the backward's cotangent) -> (mode, n,
    the leading arguments of every K1-K4 entry: pts, the per-ray input, n,
    S, the packed weights, their wgmma copies, K1/K2's band, the
    cotangent)."""
    mode = mode_of(compute_dtype)
    n = pts.shape[0]
    if n == 0 or n % S:
        raise ValueError(f"point count {n} is not a positive multiple of S={S}")
    if not 1 <= C <= pair.max_c:
        raise ValueError(f"{pair.name} takes 1 <= C <= {pair.max_c} channels, "
                         f"got {C}")
    _check("packed", packed, (packed_size(C, pair.view_pe),))
    _check("pts", pts, (n, 3))
    _check(pair.ray, ray, (n // S, pair.ray_width))
    if pair.view_pe:
        _check("band", band, (L_PTS + L_VIEWS,))
    elif band is not None:
        raise ValueError(f"{pair.name} takes no band weights")
    if g is not None:
        _check("cotangent", g, (n, C + 1))
    _check("prepared weights", prep, (prep_table(pair.view_pe, compute_dtype)[1],
                                      PREP_KS[compute_dtype]),
           PREP_DTYPE[compute_dtype])
    args = (_ptr(pts), _ptr(ray), n, S, _ptr(packed), _ptr(prep),
            *[_ptr(t) for t in (band, g) if t is not None])
    return mode, n, args


def _check_kept(pair, kept, n, compute_dtype):
    """Raise unless `kept` is a kept forward (`kept_scratch`) of n points in
    compute_dtype where the pair has one (K1/K2), None for K3/K4."""
    if not pair.view_pe:
        if kept is not None:
            raise ValueError(f"{pair.name} keeps no forward")
        return
    n_pad = -(-n // TILE) * TILE
    sizes = scratch_sizes(n_pad, 1, True, compute_dtype)
    dt = torch.float32 if compute_dtype == "float32" else torch.bfloat16
    if kept is None or (kept.n_pad, kept.compute_dtype) != (n_pad, compute_dtype):
        raise ValueError(f"{pair.name}: need the forward kept for {n_pad} points "
                         f"in {compute_dtype} (kept_scratch)")
    _check("kept X", kept.x, (sizes.x,), dt)
    if compute_dtype != "float32":
        _check("kept side rows", kept.side, (sizes.side,))
    _check("kept signs", kept.signs, (n_pad // TILE, SIGN_WORDS), torch.int32)


def launch_fwd(pair, packed, pts, ray, band, S, C, compute_dtype="float32", *,
               prep, kept=None):
    """K1 or K3: pts (n, 3), the per-ray input (n / S, pair.ray_width), K1's
    band weights (14,) (K3: None) -> raw (n, C+1). The launch also writes
    the weights' wgmma copies into `prep` (a `prep_buffer`), which K2 / K4
    read, and with `kept` (K1 only: a `kept_scratch` of n points in
    compute_dtype) its forward for K2, counted in LAUNCHES
    "fused_mlp_fwd_kept"."""
    mode, n, args = _launch_args(pair, packed, pts, ray, band, S, C,
                                 compute_dtype, prep)
    if kept is not None:
        _check_kept(pair, kept, n, compute_dtype)
    out = torch.empty((n, C + 1), device=pts.device, dtype=torch.float32)
    keep = ([_ptr(kept.x), _ptr(kept.side), _ptr(kept.signs)] if kept is not None
            else [_ptr(None)] * 3)
    call(f"{pair.name}_fwd", f"{pair.name}_fwd", *args, C, _ptr(out),
         *(keep if pair.view_pe else []), mode=mode, count=True)
    if kept is not None:
        LAUNCHES[_key(f"{pair.name}_fwd_kept", mode)] += 1
    return out


def _bwd_args(pair, packed, pts, ray, band, g, S, C, compute_dtype, prep,
              kept):
    """Check K2's / K4's inputs (K2: on the forward K1 kept) and allocate
    their scratch and outputs -> (mode, scratch, d pts, K2's d viewdirs per
    point (K4: None), the arguments that the tile pass and the whole
    backward share)."""
    mode, n, args = _launch_args(pair, packed, pts, ray, band, S, C,
                                 compute_dtype, prep, g)
    scr = bwd_scratch(pair, n, C, pts.device, compute_dtype, kept)
    dpts = torch.empty((n, 3), device=pts.device)
    dvd = torch.empty((n, 3), device=pts.device) if pair.view_pe else None
    k2 = [scr.signs, scr.gside] if pair.view_pe else []
    args += (C, scr.n_pad, *[_ptr(t) for t in [scr.x, scr.d, scr.side, scr.bsum,
                                               *k2, dpts]]
             + ([_ptr(dvd)] if pair.view_pe else []))
    return mode, scr, dpts, dvd, args


def launch_bwd(pair, packed, pts, ray, band, g, S, C, compute_dtype="float32",
               *, prep, kept=None, splits=DEFAULT_SPLITS):
    """K2 or K4: cotangent g (n, C+1) -> (d packed, d pts (n, 3), d of the
    per-ray input (n / S, pair.ray_width)); prep: the weights' wgmma copies
    K1's / K3's launch wrote; kept: K2's, the forward K1 kept
    (`kept_scratch`; K4: None). splits: point-axis chunks of the
    weight-gradient reduction, which its result does not depend on."""
    if splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    mode, scr, dpts, dvd, args = _bwd_args(pair, packed, pts, ray, band, g, S,
                                           C, compute_dtype, prep, kept)
    part = torch.empty((splits, packed.numel()), device=pts.device)
    dpacked = torch.empty_like(packed)
    call(f"{pair.name}_bwd", f"{pair.name}_bwd", *args, _ptr(part), splits,
         _ptr(dpacked), mode=mode, count=True)
    # a ray's input is broadcast over its S samples: sum them. K2 writes d
    # viewdirs per point to its own output; K4 leaves d vb per point in 128
    # rows of its scratch (fp32 in both formats) from the row that
    # `scratch_sizes` names
    n, R = pts.shape[0], pts.shape[0] // S
    if pair.view_pe:
        return dpacked, dpts, dvd.view(R, S, 3).sum(dim=1)
    rows = (scr.d if scr.side is None else scr.side).view(-1, scr.n_pad)
    row0 = scratch_sizes(scr.n_pad, C, False, compute_dtype).dvb
    dvb_pt = rows[row0:row0 + HEAD, :n]
    return dpacked, dpts, dvb_pt.unflatten(1, (R, S)).sum(dim=2).t()


def run_tile(pair, packed, pts, ray, band, g, S, C, compute_dtype="float32", *,
             prep, kept=None):
    """K2's or K4's tile pass alone (pass (a), for timing it apart; not
    counted: the main path runs it inside K2 / K4; K2's on the forward K1
    kept, `kept`) -> (its `Scratch`, d pts)."""
    mode, scr, dpts, _, args = _bwd_args(pair, packed, pts, ray, band, g, S, C,
                                         compute_dtype, prep, kept)
    call(f"{pair.name}_bwd", f"{pair.name}_tile", *args, mode=mode)
    return scr, dpts


class KernelMLP(torch.autograd.Function):
    """A kernel pair's MLP through autograd, `KernelMLP.apply(pair, packed,
    pts, ray, band, S, C, compute_dtype, recorded)` (`kernel_mlp` passes the
    caller's grad mode as `recorded`): K1 (K3) forward, K2 (K4) in the
    backward on the weights' wgmma copies the forward's launch wrote.
    packed: `pack_params(params, pair.view_pe)`; pts (n, 3); the per-ray
    input (n / S, pair.ray_width); K1/K2's band weights (K3/K4: None) ->
    raw (n, C+1). Where autograd records the call (`recorded` and an input
    that needs a gradient), K1 keeps its forward for K2 (`kept_scratch`),
    saved until the backward has run; otherwise it keeps nothing."""

    @staticmethod
    def forward(ctx, pair, packed, pts, ray, band, S, C, compute_dtype,
                recorded):
        prep = prep_buffer(pair.view_pe, compute_dtype, pts.device)
        kept = (kept_scratch(pts.shape[0], pts.device, compute_dtype)
                if pair.view_pe and recorded and any(ctx.needs_input_grad)
                else None)
        out = launch_fwd(pair, packed, pts, ray, band, S, C, compute_dtype,
                         prep=prep, kept=kept)
        ctx.save_for_backward(packed, pts, ray, band, prep,
                              *([kept.x, kept.side, kept.signs] if kept else []))
        ctx.pair, ctx.S, ctx.C, ctx.cd = pair, S, C, compute_dtype
        return out

    @staticmethod
    def backward(ctx, g):
        packed, pts, ray, band, prep, *saved = ctx.saved_tensors
        kept = None
        if saved:
            x, side, signs = saved
            kept = Scratch(signs.shape[0] * TILE, ctx.cd, x, None, side,
                           signs=signs)
        with profiling.span("mlp.bwd"):
            dpacked, dpts, dray = launch_bwd(ctx.pair, packed, pts, ray, band,
                                             g.contiguous(), ctx.S, ctx.C,
                                             ctx.cd, prep=prep, kept=kept)
        return None, dpacked, dpts, dray, None, None, None, None, None


def kernel_mlp(pair, packed, pts, ray, band, S, C, compute_dtype):
    """`KernelMLP` under the caller's grad mode: K1 keeps its forward for K2
    only where autograd records the call, so no_grad (eval chunks,
    cli.test, renders) launches the forward that keeps nothing."""
    return KernelMLP.apply(pair, packed, pts, ray, band, S, C, compute_dtype,
                           torch.is_grad_enabled())
