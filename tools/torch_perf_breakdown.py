#!/usr/bin/env python3
"""Component-level timing of the port's train step at the bench workload,
the counterpart of tools/perf_breakdown.py.

    python3 tools/torch_perf_breakdown.py [--reps 20] [--dtype bfloat16]
                                          [--json_out FILE]

Times each component of the step alone, at the bench shapes of
benerf_tpu_torch/cli/bench.py (1024 event rays x 2 poses + 53 rgb rays x
19 poses = 3,055 rows, 64 coarse + 128 fine points, 400x600, 1,000,000
events), forward and backward wherever the step differentiates through it,
each on the port's own function as the step calls it:

  ray_subset_fast  the top-k ray subsets of both sensors (fast_ray_sampling,
                   the bench config's path: train/step.py rand_subset)
  ray_subset_perm  the randperm slices of the config default (comparison)
  mlp_staging      what the step does around K1 at both levels: the two
                   families' points and viewdirs joined, the weights packed
                   (ops/mlp_kernels.pack_params), the band weights, the
                   points flattened; forward and backward
  mlp_fine         K1 + K2 through ops/mlp_kernels.kernel_mlp, n = 391,040
  mlp_coarse       the same at n = 195,520
  composite        render/volume.composite of both families at both levels
  z_merge          render/pdf.merge_sorted of both families (no gradient
                   path); z_sort_torch: torch.sort of the concatenation
                   (comparison)
  sample_pdf       the fine samples of both families with their sorted
                   draws (no gradient: the step detaches them)
  eta              the event window's draw, the capped-slice ETA scatter over
                   the 1,000,000 events and its gather at the event rays
  spline           interpolate_poses for the 2 event and 19 rgb poses
  rng_noise        the sigma-noise draws of both families at both levels
  losses           the event and blur loss terms, coarse and fine, with the
                   image gather
  optimizer        the grad norms and the five Adam groups with their
                   decayed lrs (train/optim.py)
  STEP_MEASURED    cli.bench.run_step_bench in this process (ms/iter), with
                   the captured step's device busy and launches from its
                   profiled dispatch (main(step=line) takes them from a
                   bench line of the same mode run with --profile instead)

For every row: the eager wall ms a call over --reps calls (CUDA events,
after a warm-up call), the device ms a call (the sum of its kernels under
torch.profiler) and the launches a call. Caveat, as for the JAX tool: the
eager times include each launch's host overhead, so they rank the
components and do not price them; the device ms and the launches are the
numbers to compare with the step's. The table is sorted by device ms; the
production rows' sums stand beside the step's. It runs on the card and
exits non-zero without one (build_rows and measure also run the plain
versions on the CPU, without device numbers). Imports nothing of JAX or
of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# rows timed for comparison, left out of the production sums
COMPARISON = ("ray_subset_perm", "z_sort_torch")
STEP_INNER, STEP_CHUNKS = 25, 2  # STEP_MEASURED's dispatches



def build_rows(cfg, batch, H, W, device, seed=0):
    """{row: fn}: each fn() makes one call of a component of the step at
    the shapes `cfg` gives it (forward and backward where the step
    differentiates through it), on inputs made here from `seed`. cfg and
    batch: cli.bench.bench_batch's (the window cap set, the events and the
    image that the eta and losses rows read); H, W: the image's size."""
    import torch

    from benerf_tpu_torch.data import events as events_mod
    from benerf_tpu_torch.geometry import spline as spline_mod
    from benerf_tpu_torch.models.bridge import tree_leaves
    from benerf_tpu_torch.ops import fused_mlp, mlp_kernels
    from benerf_tpu_torch.render import pdf as pdf_mod
    from benerf_tpu_torch.render import volume
    from benerf_tpu_torch.train import loss as loss_mod
    from benerf_tpu_torch.train import optim as optim_mod
    from benerf_tpu_torch.train import step as step_mod

    def generator(offset):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + offset)
        return gen

    g = generator(0)

    def rand(*shape, grad=False):
        return torch.rand(shape, generator=g, device=device).requires_grad_(grad)

    def fwd_bwd(fn):
        """A row: fn() -> outputs, then the backward of those that need a
        gradient, from random cotangents made once."""
        cots = [torch.rand(o.shape, generator=g, device=device)
                for o in fn() if o.requires_grad]

        def call():
            torch.autograd.backward([o for o in fn() if o.requires_grad], cots)
        return call

    C, P = cfg.channels, cfg.num_interpolated_pose
    n_evt, n_rgb = cfg.sampling_event_rays, cfg.sampling_rgb_rays // P
    hw_evt, hw_rgb = cfg.event_height * cfg.event_width, H * W
    fams = (2 * n_evt, P * n_rgb)  # rows of the event and the rgb family
    S_c, S_f = cfg.N_samples, cfg.N_samples + cfg.N_importance
    levels = ((S_c, "nerf"), (S_f, "nerf_fine"))
    std = cfg.sigma_noise_std
    rows = {}

    def subsets(pick):
        ge, gr = generator(1), generator(2)
        return lambda: (pick(ge, hw_evt, n_evt), pick(gr, hw_rgb, n_rgb))

    rows["ray_subset_fast"] = subsets(lambda gen, n, k: torch.topk(
        torch.rand(n, generator=gen, device=device), k).indices)
    rows["ray_subset_perm"] = subsets(lambda gen, n, k: torch.randperm(
        n, generator=gen, device=device)[:k])

    # the step's two MLP calls, each over both families' rows
    params = step_mod.build_params(cfg, seed, device=device)
    pts = {S: [rand(R, S, 3, grad=True) for R in fams] for S, _ in levels}
    vd = [torch.nn.functional.normalize(rand(R, 3) - 0.5, dim=-1)
          .requires_grad_(True) for R in fams]

    def staging():
        outs = []
        for S, name in levels:
            outs += [mlp_kernels.pack_params(params[name]),
                     torch.cat(pts[S], dim=0).reshape(-1, 3).contiguous(),
                     torch.cat(vd, dim=0).contiguous(),
                     fused_mlp.band_weights(None, None, device)]
        return outs

    rows["mlp_staging"] = fwd_bwd(staging)
    for S, name in levels:
        row = "mlp_coarse" if S == S_c else "mlp_fine"
        rows[row] = fwd_bwd(_mlp_call(
            params[name], torch.cat(pts[S], dim=0).detach(),
            torch.cat(vd, dim=0).detach(), cfg.compute_dtype))

    # compositing and fine sampling, one family at a time as the renderer
    z = {S: [torch.sort(rand(R, S), dim=-1).values for R in fams]
         for S, _ in levels}
    rays_d = [rand(R, 3) - 0.5 for R in fams]
    raw = {S: [(rand(R, S, C + 1) - 0.5).requires_grad_(True) for R in fams]
           for S, _ in levels}
    noise = {S: [torch.randn((R, S), generator=g, device=device) * std
                 for R in fams] for S, _ in levels}
    rows["composite"] = fwd_bwd(lambda: [
        volume.composite(raw[S][i], z[S][i], rays_d[i], C,
                         noise=noise[S][i])["rgb_map"]
        for S, _ in levels for i in range(len(fams))])

    z_samples = [torch.sort(rand(R, cfg.N_importance), dim=-1).values
                 for R in fams]
    rows["z_merge"] = lambda: [pdf_mod.merge_sorted(a, b)
                               for a, b in zip(z[S_c], z_samples)]
    rows["z_sort_torch"] = lambda: [
        torch.sort(torch.cat([a, b], -1), -1).values
        for a, b in zip(z[S_c], z_samples)]

    weights = [rand(R, S_c) for R in fams]
    g_pdf = generator(3)

    def fine_samples():
        return [pdf_mod.sample_pdf(0.5 * (zc[..., 1:] + zc[..., :-1]),
                                   w[..., 1:-1], cfg.N_importance,
                                   generator=g_pdf, sorted_draws=True).detach()
                for zc, w in zip(z[S_c], weights)]

    rows["sample_pdf"] = fine_samples

    g_win = generator(4)
    ray_idx_evt = torch.randperm(hw_evt, generator=g, device=device)[:n_evt]

    def eta():
        low, up = events_mod.sample_time_window(
            g_win, cfg.accumulate_time_length, cfg.random_sampling_window,
            device=device)
        e, _ = events_mod.eta_time_window(batch.events, hw_evt, low, up,
                                          cap=cfg.event_window_cap)
        return e[ray_idx_evt][:, None]

    rows["eta"] = eta

    knots = (rand(4, 6) * 0.05).requires_grad_(True)
    transform = (rand(6) * 0.01).requires_grad_(True)
    low_t = torch.tensor(0.37, device=device)
    rows["spline"] = fwd_bwd(lambda: [
        spline_mod.interpolate_poses(knots, low_t, low_t + 0.1, 2, cfg.traj),
        spline_mod.interpolate_poses(knots + transform[None, :],
                                     batch.rgb_exp_ts[0], batch.rgb_exp_ts[1],
                                     P, cfg.traj)])

    g_noise = generator(5)
    rows["rng_noise"] = lambda: [
        volume.sigma_noise(g_noise, (R, S), std, device, torch.float32)
        for S, _ in levels for R in fams]

    # the loss terms on both levels' rendered maps of both families
    maps = [[rand(R, C, grad=True) for R in fams] for _ in levels]
    eta_target = torch.randint(-3, 4, (n_evt, 1), generator=g,
                               device=device).float()
    ray_idx_rgb = torch.randperm(hw_rgb, generator=g, device=device)[:n_rgb]
    kw = dict(dataset=cfg.dataset, channels=C,
              event_threshold=cfg.event_threshold,
              coeff_syn=cfg.event_coeff_syn, coeff_real=cfg.event_coeff_real)

    def losses():
        target = batch.image_flat[ray_idx_rgb]
        total = torch.zeros((), device=device)
        for evt, rgb in maps:
            total = total + loss_mod.event_loss_term(evt[:n_evt], evt[n_evt:],
                                                     eta_target, **kw)
            total = total + loss_mod.blur_rgb_loss_term(rgb, target,
                                                        cfg.rgb_coeff)
        return [total]

    rows["losses"] = fwd_bwd(losses)

    # the grad norms and Adam, as the step's body runs them after backward
    opt_params = step_mod.build_params(cfg, seed, device=device)
    optimizer = optim_mod.build_optimizer(cfg, opt_params)
    for t in tree_leaves(opt_params):
        t.grad = torch.rand(t.shape, generator=g, device=device) * 1e-3
    nerf_grads = [t.grad for c in ("nerf", "nerf_fine")
                  for t in tree_leaves(opt_params[c])]

    def optimizer_step():
        with torch.no_grad():
            torch.linalg.norm(opt_params["knots"].grad)
            torch.sqrt(sum(torch.sum(gr * gr) for gr in nerf_grads))
        optim_mod.set_learning_rates(optimizer, 100)
        optimizer.step()

    rows["optimizer"] = optimizer_step
    return rows


def _mlp_call(params, pts, vd, compute_dtype):
    """fn() -> [raw]: one MLP call as the step makes it, without the staging
    (the mlp_staging row): K1, and K2 in its backward, through
    ops/mlp_kernels.kernel_mlp on the card; on the CPU its plain version,
    fused_nerf_mlp. pts (R, S, 3), vd (R, 3)."""
    from benerf_tpu_torch.ops import fused_mlp, mlp_kernels

    pts.requires_grad_(True)
    vd.requires_grad_(True)
    if pts.device.type == "cpu":
        return lambda: [fused_mlp.fused_nerf_mlp(params, pts, vd,
                                                 compute_dtype=compute_dtype)]
    R, S, _ = pts.shape
    packed = mlp_kernels.pack_params(params).detach().requires_grad_(True)
    band = fused_mlp.band_weights(None, None, pts.device)
    flat = pts.detach().reshape(R * S, 3).contiguous().requires_grad_(True)
    C = params["rgb"]["w"].shape[1]
    return lambda: [mlp_kernels.kernel_mlp(
        mlp_kernels.FUSED, packed, flat, vd, band, S, C, compute_dtype)]


def measure(fn, reps, device):
    """fn's cost a call -> {eager_ms, device_ms, launches}: the wall time of
    `reps` calls after a warm-up call (CUDA events on the card), then on the
    card `reps` calls under torch.profiler; device_ms and launches None on
    the CPU."""
    import torch

    from benerf_tpu_torch.core.profiling import device_work

    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return {"eager_ms": (time.perf_counter() - t0) * 1e3 / reps,
                "device_ms": None, "launches": None}
    from torch.profiler import ProfilerActivity, profile

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    work = device_work(prof)
    return {"eager_ms": eager, "device_ms": sum(w[2] for w in work) / reps,
            "launches": sum(w[1] for w in work) / reps}


def main(argv=None, step=None):
    """Parse argv (None: sys.argv), time every row and the step, print the
    table (and write --json_out) -> the result dict. step: a cli.bench line
    of this mode with the profiled step's device busy (its --profile run),
    read as STEP_MEASURED instead of running the bench here."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--json_out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benerf_tpu_torch.cli import bench

    if not torch.cuda.is_available():
        sys.exit("torch_perf_breakdown: torch sees no CUDA card")
    device = torch.device("cuda")
    base = bench.bench_config(compute_dtype=args.dtype)
    H, W = base.event_height, base.event_width
    cfg, batch = bench.bench_batch(base, H, W, bench.N_EVENTS, device=device)
    rows = {name: measure(fn, args.reps, device)
            for name, fn in build_rows(cfg, batch, H, W, device).items()}

    prod = [r for n, r in rows.items() if n not in COMPARISON]
    total = {k: sum(r[k] for r in prod)
             for k in ("eager_ms", "device_ms", "launches")}
    if step is None:
        _, dt, summary = bench.run_step_bench(
            base, H, W, inner=STEP_INNER, chunks=STEP_CHUNKS, profile=True,
            device=device)
        step = {"compute_dtype": args.dtype, "ms_per_iter": dt * 1e3,
                **summary}
    elif (step["compute_dtype"] != args.dtype
            or step["device_busy_ms_per_step"] is None):
        raise ValueError("step: a profiled bench line of this mode, not "
                         f"{step}")
    step = {k: step[k] for k in ("ms_per_iter", "device_busy_ms_per_step",
                                 "launches_per_step")}
    result = {
        "card": bench.nvidia_smi_line(), "platform": device.type,
        "compute_dtype": args.dtype, "reps": args.reps, "rows": rows,
        "comparison_rows": list(COMPARISON), "sum_production_rows": total,
        "step_measured": step,
        "device_share_of_step": (total["device_ms"]
                                 / step["device_busy_ms_per_step"]),
    }
    report(result)
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(result, indent=1) + "\n")
    return result


def report(result):
    """Print main's result as a table, largest device ms first."""
    def num(x, fmt):
        return "n/m" if x is None else format(x, fmt)

    rows = result["rows"]
    print(f"component costs a call, {result['compute_dtype']}, "
          f"{result['reps']} reps, {result['card'] or result['platform']} "
          "(eager: wall with launch overhead; device: sum of kernels)")
    print(f"  {'row':18s} {'eager ms':>9s} {'device ms':>10s} {'launches':>9s}")
    order = sorted(rows, key=lambda n: -(rows[n]["device_ms"]
                                         or rows[n]["eager_ms"]))
    for n in order:
        r = rows[n]
        tag = "  (comparison)" if n in COMPARISON else ""
        print(f"  {n:18s} {r['eager_ms']:9.3f} {num(r['device_ms'], '10.3f')} "
              f"{num(r['launches'], '9.0f')}{tag}")
    t = result["sum_production_rows"]
    print(f"  {'SUM(prod rows)':18s} {t['eager_ms']:9.3f} "
          f"{num(t['device_ms'], '10.3f')} {num(t['launches'], '9.0f')}")
    s = result["step_measured"]
    print(f"  {'STEP_MEASURED':18s} {s['ms_per_iter']:9.3f} "
          f"{num(s['device_busy_ms_per_step'], '10.3f')} "
          f"{num(s['launches_per_step'], '9.0f')}  (ms/iter; device busy "
          "and launches a captured step)")
    if result["device_share_of_step"] is not None:
        print(f"  production rows' device ms / the step's device busy: "
              f"{result['device_share_of_step']:.3f}")


if __name__ == "__main__":
    main()
