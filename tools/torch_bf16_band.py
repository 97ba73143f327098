#!/usr/bin/env python3
"""The bf16 gradient band of K1/K2 and K3/K4 over many seeds, in two trees of
this repository, on one card.

    python3 tools/torch_bf16_band.py PARENT_DIR [CHANGE_DIR] [--seeds N]

PARENT_DIR and CHANGE_DIR (default: this repository) are checkouts, e.g.
`git archive <commit> | tar -x -C PARENT_DIR`. Each tree builds its own
kernels and, in a process of its own, runs chip_smoke.check_bf16's
measurement (without its assertions) at the card tests' ragged sizes,
n = 1, 63, 65 and 200 (tests/test_torch_cuda.py RAGGED), for seeds 0 to
N - 1 (default 20), K1/K2 with BARF at C = 1, 3, 7 and K3/K4 (view
encoding L = 6) at C = 1, 3, 8, 127: the ratios of the kernel's distance
to float64 to the plain bf16 version's, for the weight gradients (worst
err/scale) and the per-point gradients (RMS). It also pools sixteen
one-point launches per seed, as the card tests hold n = 1, for the first
five seeds. Prints one JSON line per tree with every ratio, then per case
and n the range of each ratio in each tree, how many fall outside
chip_smoke's band [BF16_GRAD_FLOOR, BF16_GRAD_FACTOR], and the largest
ratio of change to parent over the seeds. Needs one CUDA card; imports
nothing of JAX or of the JAX package.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

CASES = [("K1/K2", C, True) for C in (1, 3, 7)] + \
        [("K3/K4", C, False) for C in (1, 3, 8, 127)]
SIZES = [(1, 1), (7, 9), (5, 13), (8, 25)]  # n = 1, 63, 65, 200
POOLED_SEEDS = 5
POOLED_POINTS = 16

RUN = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from benerf_tpu_torch.models import nerf
from benerf_tpu_torch.ops import fused_mlp
torch.backends.cuda.matmul.allow_tf32 = False
fused_mlp.build()
seeds, cases, sizes, pooled_seeds, points = json.loads(sys.argv[1])


def grads(op, params, pts, vd, kw, barf_kw):
    kw64 = {**kw, **{k: v.double() for k, v in barf_kw.items()}}
    return (cs._grads(torch, op, params, pts, vd, compute_dtype="bfloat16", **kw),
            cs._grads(torch, nerf.apply, params, pts, vd,
                      compute_dtype=torch.bfloat16, **kw),
            cs._grads(torch, nerf.apply, cs._f64(torch, params), pts.double(),
                      vd.double(), **kw64))


def ratios(gk, gp, g64):
    n_w = len(g64) - 2
    wk, wp = cs._dist(gk[:n_w], g64[:n_w]), cs._dist(gp[:n_w], g64[:n_w])
    pk = max(cs._rms_rel(a, b) for a, b in zip(gk[n_w:], g64[n_w:]))
    pp = max(cs._rms_rel(a, b) for a, b in zip(gp[n_w:], g64[n_w:]))
    return wk / wp, pk / pp


rows = []
for which, C, barf in cases:
    op, views_ch, kw0 = cs._pair(which)
    for R, S in sizes:
        for seed in range(seeds):
            params, pts, vd, bw, bwv = cs._inputs(torch, R, S, C, seed, barf,
                                                  views_ch)
            barf_kw = cs._barf_kw(bw, bwv)
            w, p = ratios(*grads(op, params, pts, vd, {**kw0, **barf_kw}, barf_kw))
            rows.append([which, C, str(R * S), seed, w, p])
    for seed in range(pooled_seeds):
        params, pts, vd, bw, bwv = cs._inputs(torch, points, 1, C, seed, barf,
                                              views_ch)
        barf_kw = cs._barf_kw(bw, bwv)
        runs = [grads(op, params, pts[i:i + 1], vd[i:i + 1], {**kw0, **barf_kw},
                      barf_kw) for i in range(points)]
        n_w = len(runs[0][2]) - 2
        pooled = [[sum(r[s][j] for r in runs) for j in range(n_w)]
                  + [torch.cat([r[s][j] for r in runs]) for j in (n_w, n_w + 1)]
                  for s in range(3)]
        w, p = ratios(*pooled)
        rows.append([which, C, "pooled", seed, w, p])
print(json.dumps({"band": [cs.BF16_GRAD_FLOOR, cs.BF16_GRAD_FACTOR],
                  "rows": rows}))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--seeds", type=int, default=20)
    args = ap.parse_args()
    spec = json.dumps([args.seeds, CASES, SIZES, POOLED_SEEDS, POOLED_POINTS])
    res = {}
    for side in ("parent", "change"):
        out = subprocess.run([sys.executable, "-c", RUN, spec],
                             cwd=Path(getattr(args, side)).resolve(), check=True,
                             capture_output=True, text=True)
        res[side] = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"side": side, **res[side]}), flush=True)
    lo, hi = res["change"]["band"]
    keyed = {side: {tuple(r[:4]): r[4:] for r in res[side]["rows"]}
             for side in res}
    for which, C, _ in CASES:
        for n in [str(R * S) for R, S in SIZES] + ["pooled"]:
            summary = {"case": which, "C": C, "n": n}
            for side in ("parent", "change"):
                rs = [v for k, v in keyed[side].items() if k[:3] == (which, C, n)]
                for i, what in enumerate(("wgrad", "points")):
                    vals = [r[i] for r in rs]
                    summary[f"{side}_{what}"] = [min(vals), max(vals)]
                    summary[f"{side}_{what}_outside"] = sum(
                        not lo <= v <= hi for v in vals)
            same = [(v, keyed["parent"][k]) for k, v in keyed["change"].items()
                    if k[:3] == (which, C, n) and k in keyed["parent"]]
            for i, what in enumerate(("wgrad", "points")):
                summary[f"change_over_parent_{what}"] = [
                    min(a[i] / b[i] for a, b in same),
                    max(a[i] / b[i] for a, b in same)]
            print(json.dumps(summary))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
