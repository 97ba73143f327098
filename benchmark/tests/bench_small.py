"""A cell shrunk to a size a CPU test holds: its configuration with a
24 x 32 image and sensor, 16 + 19 x 2 rays, 8 + 8 samples and 32-wide
MLPs, 3,000 events; its mix with dispatches of 4 steps, or 3 poses in
chunks of 200 rays. The harness runs it on the CPU (the program's plain
routes), the reference beside it as on the card."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402

torch.set_num_threads(2)


def small(name, bench=None):
    """(bench, conf, traffic) of cell `name` at the small size."""
    bench = bench or harness.spec()
    wl = harness.workload(bench, name)
    conf = copy.deepcopy(harness.load_json(harness.config_file(bench, wl["config"])))
    conf["config"].update(
        rgb_height=24, rgb_width=32, event_height=24, event_width=32,
        rgb_fx=30.0, rgb_fy=30.0, rgb_cx=16, rgb_cy=12, event_fx=30.0,
        event_fy=30.0, event_cx=16, event_cy=12, sampling_event_rays=16,
        sampling_rgb_rays=38, N_samples=8, N_importance=8, netwidth=32,
        netwidth_fine=32)
    conf["n_events"] = 3000
    traffic = dict(harness.traffic(wl["traffic"]))
    if traffic["kind"] == "train":
        traffic["steps_per_dispatch"] = 4
    else:
        traffic.update(poses=3, chunk=200, check_chunks=4)
    return bench, conf, traffic


def run_small(name, seed=2**31 + 7, trace=0, precision=None):
    """One run of the small cell on the CPU -> (result line, checks)."""
    from benchmark.run import run_cell

    bench, conf, traffic = small(name)
    return run_cell(bench, name, seed, 0.0, trace, "cpu", conf=conf,
                    traffic=traffic, precision=precision)


def mesh_bench(world):
    """BENCHMARK.json with one more cell: tanabata.train's steps on `world`
    ranks, the path that run.py starts for a cell on several chips."""
    bench = copy.deepcopy(harness.spec())
    bench["workloads"].append({"name": "tanabata.train.mesh", "config": "tanabata",
                               "traffic": "train", "chips": world})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tanabata.train" in m.get("workloads", []):
            m["workloads"].append("tanabata.train.mesh")
    return bench


def mesh_rank(rank, world, port, fault, out):
    """Rank `rank` of a small several-chip training cell on `world` gloo
    processes on the CPU, held to tanabata.train's limits; rank 0 puts its
    (result line, checks) on the queue `out`."""
    import torch.distributed as dist

    from benchmark.calibrate import planted
    from benchmark.run import run_cell
    from benerf_tpu_torch.parallel import mesh as mesh_mod

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        bench, conf, traffic = small("tanabata.train.mesh", mesh_bench(world))
        conf["config"]["sampling_rgb_rays"] = 19 * world
        with planted(fault):
            result = run_cell(bench, "tanabata.train.mesh", 2**31 + 11, 0.0,
                              0, "cpu", conf=conf, traffic=traffic,
                              limits=harness.limits("tanabata.train"),
                              mesh=mesh_mod.mesh_of_group(None, "cpu"))
        if rank == 0:
            out.put(result)
    finally:
        dist.destroy_process_group()
