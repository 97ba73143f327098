#!/usr/bin/env python3
"""One run of one cell of the benchmark of benerf_tpu_torch.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Finds the cell in BENCHMARK.json and its pieces by name (harness.py), makes
its inputs from the seed, runs its set-up and its measured window on the
card, checks what the window produced against the plain reference, and
prints one JSON line last on standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), `device`, with --trace 1 `breakdown`, and last `checks`
(each compared number with its limit, also printed last on standard
error). A cell on N chips starts N ranks of this script (one NCCL process
per card, rank 0 prints the line) and fails if any rank fails. Without a
card, or with fewer cards than the cell asks for, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"


def _cache_env():
    """Every kernel cache at a fixed directory inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


_cache_env()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


@dataclass
class Run:
    """One run's options and its ranks' collectives."""

    name: str
    bench: dict
    conf: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    chips: int
    t_start: float
    precision: str
    mesh: object = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _reduce(self, value, op):
        if self.mesh is None:
            return value
        import torch.distributed as dist

        t = torch.tensor([float(value)], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=op, group=self.mesh.group)
        return float(t[0])

    def agree(self, flag: bool) -> bool:
        """Rank 0's flag on every rank."""
        if self.mesh is None:
            return flag
        import torch.distributed as dist

        t = torch.tensor([int(flag)], device=self.device)
        dist.broadcast(t, src=0, group=self.mesh.group)
        return bool(t.item())

    def max_over_ranks(self, value):
        import torch.distributed as dist

        return int(self._reduce(value, dist.ReduceOp.MAX))

    def mean_over_ranks(self, value):
        import torch.distributed as dist

        return self._reduce(value, dist.ReduceOp.SUM) / (
            1 if self.mesh is None else self.mesh.size)

    def free(self):
        import gc

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def read_metrics(self, ctx) -> dict:
        out = {}
        for name in harness.metric_names(self.bench, self.name, "per_layer"):
            value = harness.reader(name)(ctx)
            if value is not None:
                out[name] = {"value": value,
                             "unit": harness.unit_of(self.bench, name)}
        return out


def run_cell(bench, name, seed, seconds, trace, device, conf=None,
             traffic=None, limits=None, precision=None, mesh=None,
             t_start=None):
    """One run of cell `name` on `device` -> (result line fields, checks),
    or (None, None) on a rank other than 0. conf, traffic, limits: the
    cell's files unless given (tests give small ones)."""
    wl = harness.workload(bench, name)
    conf = conf or harness.load_json(harness.config_file(bench, wl["config"]))
    traffic = traffic or harness.traffic(wl["traffic"])
    limits = limits or harness.limits(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(name=name, bench=bench, conf=conf, traffic=traffic, seed=seed,
              seconds=seconds, trace=bool(trace), device=torch.device(device),
              chips=wl["chips"], t_start=T_START if t_start is None else t_start,
              precision=precision or conf["precision"], mesh=mesh)
    fields, numbers = harness.cell_module(traffic["kind"]).run(run)
    if fields is None:
        return None, None
    ok, checks = harness.compare(numbers, limits)
    kind = "per_layer" if trace else "end_to_end"
    metrics = (fields["per_layer"] if trace else
               {m: {"value": fields["e2e"][m], "unit": harness.unit_of(bench, m)}
                for m in harness.metric_names(bench, name, kind)})
    result = {"correct": bool(ok and fields["failed"] == 0),
              "attempted": fields["attempted"], "failed": fields["failed"],
              "metrics": metrics,
              "device": harness.device_entry(torch, wl["chips"], fields["peak"],
                                             fields["trace"])}
    if trace:
        result["breakdown"] = fields["trace"]["breakdown"]
    return result, checks


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(argv, chips) -> int:
    """Start `chips` ranks of this script; print rank 0's line once every
    rank has ended well. A rank that fails ends the others."""
    port = _free_port()
    procs = []
    for r in range(chips):
        cmd = [sys.executable, str(Path(__file__).resolve()), *argv,
               "--rank", str(r), "--world", str(chips), "--port", str(port),
               "--t0", repr(T_START)]
        procs.append(subprocess.Popen(
            cmd, stdout=subprocess.PIPE if r == 0 else sys.stderr,
            text=True))
    out = ""
    try:
        while True:
            rcs = [p.poll() for p in procs]
            if any(rc not in (None, 0) for rc in rcs):
                print(f"benchmark: a rank failed (exit codes {rcs})",
                      file=sys.stderr)
                return 1
            if all(rc == 0 for rc in rcs):
                break
            if rcs[0] is None:
                try:
                    out += procs[0].communicate(timeout=1.0)[0]
                except subprocess.TimeoutExpired:
                    pass
            else:
                time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if not lines:
        print("benchmark: rank 0 printed no result", file=sys.stderr)
        return 1
    result = json.loads(lines[-1])
    checks = result.pop("checks")
    return harness.finish(result, checks)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    bench = harness.spec()
    chips = harness.workload(bench, a.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {a.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if chips > 1 and a.rank is None:
        return _launch(argv, chips)

    rank = a.rank or 0
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    mesh = None
    if a.world > 1:
        import torch.distributed as dist

        from benerf_tpu_torch.parallel import mesh as mesh_mod

        dist.init_process_group("nccl", init_method=f"tcp://localhost:{a.port}",
                                world_size=a.world, rank=rank, device_id=device)
        mesh = mesh_mod.mesh_of_group(None, device)
    try:
        result, checks = run_cell(bench, a.workload, a.seed, a.seconds, a.trace,
                                  device, mesh=mesh, t_start=a.t0)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
    if result is None:
        return 0
    print(f"card: {harness.card_line()}", file=sys.stderr)
    return harness.finish(result, checks)


if __name__ == "__main__":
    sys.exit(main())
