#!/usr/bin/env python3
"""Time the MLP kernels of two trees of this repository on one card.

    python3 tools/torch_kernel_ab.py PARENT_DIR [CHANGE_DIR]

PARENT_DIR and CHANGE_DIR (default: this repository) are checkouts, e.g.
`git archive <commit> | tar -x -C PARENT_DIR`. Each tree builds its own
kernels and runs chip_smoke.time_kernels and time_staged_kernels in a
process of its own, in the order parent, change, change, parent, at the
training path's n = 195,520 and 391,040. Prints one JSON line per run and
the median per side (ms, CUDA events): K1 and K2 in fp32 mode (k1, k2),
in bf16 mode where the tree has it (k1_bf16, k2_bf16), K3 and K4, and the
plain versions (plain_*).
Needs one CUDA card; imports nothing of JAX or of the JAX package.
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
from benerf_tpu_torch.ops import fused_mlp
torch.backends.cuda.matmul.allow_tf32 = False
fused_mlp.build()
modes = "compute_dtype" in inspect.signature(cs.time_kernels).parameters
res = {}
for S in (64, 128):  # what both trees have first, in the same order
    r = dict(zip(("k3", "plain_fwd_l6", "k4", "plain_fwd_bwd_l6"),
                 cs.time_staged_kernels(torch, S)))
    r.update(zip(("k1", "plain_fwd", "k2", "plain_fwd_bwd"), cs.time_kernels(torch, S)))
    if modes:
        r.update(zip(("k1_bf16", "plain_fwd_bf16", "k2_bf16", "plain_fwd_bwd_bf16"),
                     cs.time_kernels(torch, S, compute_dtype="bfloat16")))
    res[str(cs.RAYS * S)] = r
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
    for side, rs in runs.items():
        med = {n: {k: statistics.median(r[n][k] for r in rs) for k in rs[0][n]}
               for n in rs[0]}
        print(json.dumps({"median": side, **med}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
