#!/usr/bin/env python3
"""Readings of a cell's checked numbers, from which its limits are set.

    python3 benchmark/calibrate.py --workload NAME --seeds S1,S2,... \\
        [--modes sound,control,half_batch] [--out FILE.jsonl]

For each mode and seed, one run of the cell in this process (the window
cut to its first dispatch or frame: the readings need none) prints and
appends {"workload", "mode", "seed", "numbers"}:
  sound       the program as the configuration states it;
  plain       the program's plain route (use_pallas off: models/nerf.apply
              in float32 with TF32 off), a second witness beside the
              kernels;
  control     the program in its bfloat16 mode (compute_dtype), the
              nearest precision below the configuration's float32;
  half_batch  a planted fault: every loss term's mean taken over the first
              half of its rows only;
  unchanged   a planted fault: the optimizer's step does nothing;
  no_exchange a planted fault: the step's all-reduce between the ranks is
              left out (a cell on several chips);
  altered     a planted fault: the colour of each rendered chunk's first
              ray is raised by 0.05 where the compositing produces it.
Needs the card(s) the cell asks for: a cell on N chips runs as N ranks of
this script (one NCCL process a card), rank 0 printing.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


@contextlib.contextmanager
def planted(mode):
    """The program with one fault planted (nothing for sound / control)."""
    from benerf_tpu_torch.parallel import mesh as mesh_mod
    from benerf_tpu_torch.render import volume
    from benerf_tpu_torch.train import loss as loss_mod

    saved = []

    def patch(obj, name, fn):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, fn)

    if mode == "half_batch":
        patch(loss_mod, "mse", lambda a, b: torch.mean(
            (a[: a.shape[0] // 2] - b[: b.shape[0] // 2]) ** 2))
    elif mode == "no_exchange":
        patch(mesh_mod, "all_reduce_flat", lambda tensors, mesh: None)
    elif mode == "unchanged":
        patch(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif mode == "altered":
        composite = volume.composite

        def altered(*args, **kw):
            out = composite(*args, **kw)
            bump = torch.zeros_like(out["rgb_map"])
            bump[0] = 0.05
            return dict(out, rgb_map=out["rgb_map"] + bump)
        patch(volume, "composite", altered)
    try:
        yield
    finally:
        for obj, name, fn in reversed(saved):
            setattr(obj, name, fn)


def _launch(argv, world) -> int:
    """`world` ranks of this script, one a card; rank 0 prints."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               *argv, "--rank", str(r), "--port", str(port)],
                              stdout=None if r == 0 else subprocess.DEVNULL)
             for r in range(world)]
    rcs = [p.wait() for p in procs]
    return 0 if all(rc == 0 for rc in rcs) else 1


def main(argv=None):
    from benchmark.run import run_cell

    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--modes", default="sound,control")
    p.add_argument("--out", default=None)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    bench = harness.spec()
    world = harness.workload(bench, a.workload)["chips"]
    if world > 1 and a.rank is None:
        return _launch(argv, world)
    rank = a.rank or 0
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    mesh = None
    if world > 1:
        import torch.distributed as dist

        from benerf_tpu_torch.parallel import mesh as mesh_mod

        dist.init_process_group("nccl", init_method=f"tcp://localhost:{a.port}",
                                world_size=world, rank=rank, device_id=device)
        mesh = mesh_mod.mesh_of_group(None, device)
    seeds = [int(s) for s in a.seeds.split(",")]
    for mode in a.modes.split(","):
        for seed in seeds:
            conf = None
            if mode == "plain":
                wl = harness.workload(bench, a.workload)
                conf = harness.load_json(harness.config_file(bench, wl["config"]))
                conf["config"]["use_pallas"] = False
            with planted(mode):
                _, checks = run_cell(
                    bench, a.workload, seed, 0.0, 0, device, conf=conf,
                    precision="bfloat16" if mode == "control" else None,
                    mesh=mesh)
            if checks is None:  # a rank other than 0
                continue
            line = {"workload": a.workload, "mode": mode, "seed": seed,
                    "numbers": {k: v["value"] for k, v in checks.items()}}
            print(json.dumps(line), flush=True)
            if a.out:
                with open(a.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
