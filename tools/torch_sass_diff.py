#!/usr/bin/env python3
"""Diff the SASS of the MLP kernels between two trees of this repository.

    python3 tools/torch_sass_diff.py PARENT_DIR [CHANGE_DIR]

Each tree's benerf_tpu_torch/csrc/fused_mlp_{fwd,bwd}.cu (K1, K2) and
staged_mlp_{fwd,bwd}.cu (K3, K4) are compiled with the port's nvcc flags to
a cubin for sm_90a, `cuobjdump -sass` lists every function, and every
function of the parent's cubin is paired with the change's by kernel name
and template arguments (a parameter appended changes the rest of the
mangled name, so the pair is made on the name up to its parameter list)
and compared instruction by instruction, with the addresses and encodings
dropped. K1's `fwd_kernel<Mode, false>` (the launch that keeps nothing) is
paired with a parent's `fwd_kernel<Mode>` where the parent has no keeping
instantiation. Prints one JSON line per kernel: identical or not,
instruction counts and the first differing lines, then the functions only
the change has. Needs nvcc and cuobjdump (the CUDA toolkit); imports
nothing of JAX.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

SOURCES = ("fused_mlp_fwd", "fused_mlp_bwd", "staged_mlp_fwd", "staged_mlp_bwd")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-cubin")
def key(mangled):
    """The kernel's name and template arguments: the mangled name up to its
    parameter list (tc::Mode m: `ILN2tc4ModeEmE`), a bool argument false
    (`Lb0E`, K1's launch that keeps nothing) dropped, so that it pairs with
    the parent's kernel of the Mode alone."""
    m = re.match(r"(_ZN.*?ILN2tc4ModeE\dE)(Lb[01]E)?EE", mangled)
    if not m:
        return mangled
    return m.group(1) + ("" if m.group(2) in (None, "Lb0E") else m.group(2)) + "EE"


def _tool(name):
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return shutil.which(name) or os.path.join(cuda, "bin", name)


def sass(tree, source, out_dir):
    """{kernel key: [instruction, ...]} of one source's cubin."""
    cubin = Path(out_dir) / f"{source}.cubin"
    subprocess.run([_tool("nvcc"), *FLAGS, "-o", str(cubin),
                    str(Path(tree) / "benerf_tpu_torch/csrc" / f"{source}.cu")],
                   check=True)
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = key(m.group(1))
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name and m:
            funcs[name].append(m.group(1))
    return funcs


def main():
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    parent = Path(sys.argv[1]).resolve()
    change = Path(sys.argv[2] if len(sys.argv) == 3
                  else Path(__file__).resolve().parents[1]).resolve()
    with tempfile.TemporaryDirectory() as tmp:
        for source in SOURCES:
            sides = {}
            for side, tree in (("parent", parent), ("change", change)):
                d = Path(tmp) / side
                d.mkdir(exist_ok=True)
                sides[side] = sass(tree, source, d)
            for name in sorted(sides["parent"]):
                a, b = sides["parent"][name], sides["change"].get(name)
                diff = None if b is None else [
                    (i, x, y) for i, (x, y) in enumerate(zip(a, b)) if x != y]
                print(json.dumps({
                    "source": source, "kernel": name,
                    "identical": b is not None and a == b,
                    "in_change": b is not None,
                    "instructions": [len(a), None if b is None else len(b)],
                    "differing": None if diff is None else len(diff) + abs(len(a) - len(b)),
                    "first_differences": None if diff is None else diff[:12]}))
            new = sorted(n for n in sides["change"] if n not in sides["parent"])
            if new:
                print(json.dumps({"source": source, "only_in_change": new}))


if __name__ == "__main__":
    main()
