#!/usr/bin/env python3
"""Time the MLP kernels of two trees of this repository on one card.

    python3 tools/torch_kernel_ab.py PARENT_DIR [CHANGE_DIR]

PARENT_DIR and CHANGE_DIR (default: this repository) are checkouts, e.g.
`git archive <commit> | tar -x -C PARENT_DIR`. Each tree builds its own
kernels and runs chip_smoke.time_kernels and time_staged_kernels in a
process of its own, in the order parent, change, change, parent, at the
training path's n = 195,520 and 391,040. Prints one JSON line per run and
the median per side (ms, CUDA events): K1/K2 and K3/K4 in fp32 mode (k1,
k2, k3, k4), in bf16 mode where the tree has it (k1_bf16, k2_bf16,
k3_bf16, k4_bf16; K2 on the forward a K1 launch kept where the tree's K1
keeps one), K1 keeping its forward where the tree has that launch
(k1_kept, k1_kept_bf16), the train path's pair
(k1_k2_train, k1_k2_train_bf16: K1 keeping, else K1, plus K2), the
plain versions (plain_*), and the weight-gradient
pass of K2/K4 alone (chip_smoke.time_wgrad) in both modes on K2's job
table (wgrad, wgrad_bf16) and, where the tree can run it alone, on K4's
(wgrad_k4, wgrad_k4_bf16); the tile pass of K2/K4 alone
(chip_smoke.time_tile_pass: tile, tile_bf16, tile_k4, tile_k4_bf16) where
the tree can run it alone; K3/K4 at C = 127 in both modes (k3_c127,
k4_c127, k3_c127_bf16, k4_c127_bf16) where the tree has K3/K4's bf16 mode;
and each run's count of K1 launches that kept their forward
(kept_launches, mlp_kernels.LAUNCHES; null where the tree has no such
counter). Needs one CUDA card; imports nothing of JAX or of the JAX
package.
"""

import json
import statistics
import subprocess
import sys
from pathlib import Path

RUN = r"""
import inspect, json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from benerf_tpu_torch.ops import mlp_kernels
torch.backends.cuda.matmul.allow_tf32 = False
mlp_kernels.build()
modes = "compute_dtype" in inspect.signature(cs.time_kernels).parameters
staged_modes = "compute_dtype" in inspect.signature(cs.time_staged_kernels).parameters
res = {}
for S in (64, 128):  # what both trees have first, in the same order
    r = dict(zip(("k3", "plain_fwd_l6", "k4", "plain_fwd_bwd_l6"),
                 cs.time_staged_kernels(torch, S)))
    r.update(zip(("k1", "plain_fwd", "k2", "plain_fwd_bwd", "k1_kept"),
                 cs.time_kernels(torch, S)))
    if modes:
        r.update(zip(("k1_bf16", "plain_fwd_bf16", "k2_bf16", "plain_fwd_bwd_bf16",
                      "k1_kept_bf16"),
                     cs.time_kernels(torch, S, compute_dtype="bfloat16")))
    if staged_modes:
        r.update(zip(("k3_bf16", "plain_fwd_l6_bf16", "k4_bf16",
                      "plain_fwd_bwd_l6_bf16"),
                     cs.time_staged_kernels(torch, S, compute_dtype="bfloat16")))
    r["wgrad"] = cs.time_wgrad(torch, S)[0]
    r["wgrad_bf16"] = cs.time_wgrad(torch, S, compute_dtype="bfloat16")[0]
    if "view_pe" in inspect.signature(cs.time_wgrad).parameters:
        r["wgrad_k4"] = cs.time_wgrad(torch, S, view_pe=False)[0]
        r["wgrad_k4_bf16"] = cs.time_wgrad(torch, S, compute_dtype="bfloat16",
                                           view_pe=False)[0]
    if hasattr(cs, "time_tile_pass"):
        for key, vp in (("tile", True), ("tile_k4", False)):
            r[key] = cs.time_tile_pass(torch, S, view_pe=vp)
            r[key + "_bf16"] = cs.time_tile_pass(torch, S, compute_dtype="bfloat16",
                                                 view_pe=vp)
    if staged_modes:
        for cd, suffix in (("float32", ""), ("bfloat16", "_bf16")):
            k3, _, k4, _ = cs.time_staged_kernels(torch, S, C=127, compute_dtype=cd)
            r["k3_c127" + suffix], r["k4_c127" + suffix] = k3, k4
    for suffix in ("", "_bf16"):
        if "k2" + suffix in r:
            r["k1_k2_train" + suffix] = (r.get("k1_kept" + suffix, r["k1" + suffix])
                                         + r["k2" + suffix])
    res[str(cs.RAYS * S)] = r
res["kept_launches"] = {k: v for k, v in mlp_kernels.LAUNCHES.items() if "kept" in k} or None
print(json.dumps(res))
"""


def main():
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    trees = {"parent": Path(sys.argv[1]).resolve(),
             "change": Path(sys.argv[2] if len(sys.argv) == 3 else
                            Path(__file__).resolve().parents[1]).resolve()}
    runs = {"parent": [], "change": []}
    for side in ("parent", "change", "change", "parent"):
        out = subprocess.run([sys.executable, "-c", RUN], cwd=trees[side],
                             check=True, capture_output=True, text=True)
        res = json.loads(out.stdout.strip().splitlines()[-1])
        runs[side].append(res)
        print(json.dumps({"side": side, **res}), flush=True)
    sizes = [n for n in runs["change"][0] if n != "kept_launches"]
    for side, rs in runs.items():
        med = {n: {k: statistics.median(r[n][k] for r in rs) for k in rs[0][n]}
               for n in sizes}
        print(json.dumps({"median": side, **med}))
    both = [k for k in runs["change"][0][sizes[0]] if k in runs["parent"][0][sizes[0]]]
    print(json.dumps({"change_over_parent": {
        n: {k: statistics.median(r[n][k] for r in runs["change"])
            / statistics.median(r[n][k] for r in runs["parent"]) for k in both}
        for n in sizes}}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
