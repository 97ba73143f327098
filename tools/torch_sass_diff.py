#!/usr/bin/env python3
"""Diff the SASS of the backward kernels' fp32 (TF32X3) instantiations
between two trees of this repository.

    python3 tools/torch_sass_diff.py PARENT_DIR [CHANGE_DIR]

Each tree's benerf_tpu_torch/csrc/fused_mlp_bwd.cu (K2) and
staged_mlp_bwd.cu (K4) are compiled with the port's nvcc flags to a cubin
for sm_90a, `cuobjdump -sass` lists every function, and the functions whose
mangled name carries tc::Mode 0 (tile_kernel, staged_tile_kernel,
wgrad_wgmma_kernel) are paired by kernel name and template argument (a
parameter appended changes the rest of the mangled name) and compared
instruction by instruction, with the addresses and encodings dropped.
Prints one JSON line per kernel: identical or not, instruction counts and
the first differing lines. Needs
nvcc and cuobjdump (the CUDA toolkit); imports nothing of JAX.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

SOURCES = ("fused_mlp_bwd", "staged_mlp_bwd")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-cubin")
MODE0 = "ILN2tc4ModeE0E"  # the mangled template argument tc::Mode 0


def key(mangled):
    """The kernel's name and template argument: the mangled name up to its
    parameter list."""
    m = re.match(r"(_ZN.*?ILN2tc4ModeE\dEEE)", mangled)
    return m.group(1) if m else mangled


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
            for name in sorted(n for n in sides["parent"] if MODE0 in n):
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
            new = sorted(n for n in sides["change"] if MODE0 in n and n not in sides["parent"])
            if new:
                print(json.dumps({"source": source, "mode0_only_in_change": new}))


if __name__ == "__main__":
    main()
