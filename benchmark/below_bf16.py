#!/usr/bin/env python3
"""The control below bfloat16, for a training cell whose configuration runs
in the port's bf16 mode (bf16 operands, fp32 sums), where calibrate.py's
control (the bf16 mode itself) is the configuration.

    python3 benchmark/below_bf16.py --workload NAME --seeds S1,S2,... \\
        [--out FILE.jsonl]

For each seed, one run of the cell in this process (the window cut to its
first dispatch, as calibrate.py cuts it) prints and appends
{"workload", "mode": "e4m3", "seed", "numbers"}: the program on its plain
route (use_pallas off: models/nerf.apply, float32, TF32 off) with each MLP
product's operands rounded to 4 significant bits (float8 e4m3's mantissa,
float32's exponent range) and its sums in fp32, in the forward and in both
products of the backward. The limits of such a cell have to fail it on
every seed. Needs one card; a cell on several chips is not run.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

from benchmark import harness  # noqa: E402

DROPPED_BITS = 20  # float32 keeps 24 significant bits; e4m3 keeps 4
PRODUCTS = (torch.Tensor.matmul, torch.Tensor.__matmul__, torch.matmul)


def round_e4m3(x):
    """float32 x with its significand rounded to 4 bits, to nearest (ties
    away from zero), in float32's exponent range."""
    i = x.contiguous().view(torch.int32)
    half, keep = 1 << (DROPPED_BITS - 1), -(1 << DROPPED_BITS)
    return ((i + half) & keep).view(torch.float32)


class _Product(torch.autograd.Function):
    """a @ w with rounded operands and fp32 sums; its backward rounds the
    incoming gradient and both operands in turn the same way."""

    @staticmethod
    def forward(ctx, a, w):
        qa, qw = round_e4m3(a), round_e4m3(w)
        ctx.save_for_backward(qa, qw)
        return qa @ qw

    @staticmethod
    def backward(ctx, g):
        qa, qw = ctx.saved_tensors
        qg = round_e4m3(g)
        return qg @ qw.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class _RoundedProducts(TorchFunctionMode):
    """Every matrix product under it through _Product."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in PRODUCTS and not kwargs:
            return _Product.apply(*args)
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def operands_e4m3():
    """The program with each product of the NeRF MLP's plain route
    (models/nerf.apply) rounded as _Product rounds it."""
    from benerf_tpu_torch.models import nerf

    apply = nerf.apply

    def rounded(*args, **kw):
        with _RoundedProducts():
            return apply(*args, **kw)

    nerf.apply = rounded
    try:
        yield
    finally:
        nerf.apply = apply


def run(bench, name, seed, device, conf=None, traffic=None):
    """One run of cell `name` as the control -> (result line, checks).
    conf, traffic: the cell's files unless given."""
    from benchmark.run import run_cell

    wl = harness.workload(bench, name)
    conf = copy.deepcopy(conf or harness.load_json(
        harness.config_file(bench, wl["config"])))
    conf["config"]["use_pallas"] = False
    with operands_e4m3():
        return run_cell(bench, name, seed, 0.0, 0, device, conf=conf,
                        traffic=traffic, precision="float32")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    bench = harness.spec()
    if harness.workload(bench, a.workload)["chips"] != 1:
        raise SystemExit(f"{a.workload}: the control runs on one chip")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    for seed in (int(s) for s in a.seeds.split(",")):
        _, checks = run(bench, a.workload, seed, device)
        line = {"workload": a.workload, "mode": "e4m3", "seed": seed,
                "numbers": {k: v["value"] for k, v in checks.items()}}
        print(json.dumps(line), flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
