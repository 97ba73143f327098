#!/usr/bin/env python3
"""Hold the K1/K2 pair's outputs and gradients of two trees of this
repository against each other, bit for bit.

    python3 tools/torch_grad_bits.py PARENT_DIR [CHANGE_DIR]

PARENT_DIR and CHANGE_DIR (default: this repository) are checkouts, e.g.
`git archive <commit> | tar -x -C PARENT_DIR`. Each tree builds its own
kernels and, in a process of its own, runs K1/K2 through autograd
(ops/fused_mlp.fused_nerf_mlp) in both modes, with C = 3 and C = 1 colour
channels, at the training path's n = 195,520 and 391,040 (3,055 rays x 64 /
128 samples) on the same inputs, made on the card from one seed, with the
cotangent of sum(sin(out)). Prints one JSON line per mode, C and n: whether the output and each gradient (every
parameter leaf, the points, the viewdirs) are bitwise equal between the
trees, and the largest difference of those that are not; then the card's
name and power limit. Needs one CUDA card; imports nothing of JAX.
"""

import json
import subprocess
import sys
import tempfile
from pathlib import Path

RAYS = 3055
RUN = r"""
import sys
sys.path.insert(0, ".")
import torch
from benerf_tpu_torch.models import bridge, nerf
from benerf_tpu_torch.ops import fused_mlp
torch.backends.cuda.matmul.allow_tf32 = False
res = {}
for cd in ("float32", "bfloat16"):
    for C in (3, 1):
        for S in (64, 128):
            g = torch.Generator(device="cuda")
            g.manual_seed(23)
            params = nerf.init_params(g, channels=C, device="cuda")
            leaves = [t.requires_grad_(True) for t in bridge.tree_leaves(params)]
            x = (torch.rand((%d, S, 3), generator=g, device="cuda") * 2 - 1).requires_grad_(True)
            v = torch.nn.functional.normalize(
                torch.randn((%d, 3), generator=g, device="cuda"), dim=-1).requires_grad_(True)
            out = fused_mlp.fused_nerf_mlp(params, x, v, compute_dtype=cd)
            grads = torch.autograd.grad(torch.sin(out).sum(), leaves + [x, v])
            res[f"{cd}/C{C}/{x.shape[0] * S}"] = [out.detach().cpu()] + [t.cpu() for t in grads]
torch.save(res, sys.argv[1])
""" % (RAYS, RAYS)


def main():
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    import torch

    trees = {"parent": Path(sys.argv[1]).resolve(),
             "change": Path(sys.argv[2] if len(sys.argv) == 3 else
                            Path(__file__).resolve().parents[1]).resolve()}
    with tempfile.TemporaryDirectory() as tmp:
        got = {}
        for side, tree in trees.items():
            path = str(Path(tmp) / f"{side}.pt")
            subprocess.run([sys.executable, "-c", RUN, path], cwd=tree, check=True)
            got[side] = torch.load(path)
    for key, parent in got["parent"].items():
        change = got["change"][key]
        names = ["out"] + [f"grad{i}" for i in range(len(parent) - 3)] + ["d_pts", "d_viewdirs"]
        differ = {n: float((a.double() - b.double()).abs().max())
                  for n, a, b in zip(names, parent, change) if not torch.equal(a, b)}
        print(json.dumps({"mode_n": key, "bitwise_equal": not differ,
                          "tensors": len(parent), "differ_max_abs": differ}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
