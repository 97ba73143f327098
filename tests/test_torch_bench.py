"""The port's bench entry point (benerf_tpu_torch/cli/bench.py) and its step
breakdown (tools/torch_perf_breakdown.py) on the CPU, against the JAX
package's bench.py and __graft_entry__:

- bench_config equals _bench_config field by field, with overrides too;
- the FLOP arithmetic equals bench.py's exactly, over configs;
- the bench batch equals _random_batch's arrays exactly;
- the bench config's loss and gradients equal JAX's make_loss_fn on
  injected draws at tiny sizes, within tests/test_torch_step.py's envelope
  for the synthetic event loss;
- run_step_bench and main run end to end on a tiny config (one JSON line,
  every field), --profile refuses a run with no device time and writes its
  table from a profile's summary, no card without --device cpu exits
  non-zero, and two gloo ranks under the launcher's environment print one
  line from rank 0; the line gives rays/s and the share of the bf16 peak a
  card under a mesh;
- the breakdown's rows run at tiny sizes and name every row of the
  JAX tool plus losses and optimizer; its main needs a card.

The bench on the card: tests/test_torch_cuda.py.
"""

import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import bench as jbench
import test_torch_step as tts

from benerf_tpu.data import events as jevents
from benerf_tpu.train import step as jstep
from benerf_tpu_torch.cli import bench
from benerf_tpu_torch.models import bridge
from benerf_tpu_torch.train import step as tstep

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import torch_perf_breakdown as breakdown  # noqa: E402

# the bench config cut to a tiny scene: 16x12 image and sensor, 8 + 8
# points a ray, 2 x 16 event rays and 3 x 3 rgb rays (MLPs at full width)
TINY = dict(event_width=16, event_height=12, rgb_fx=20.0, rgb_fy=20.0,
            rgb_cx=8.0, rgb_cy=6.0, event_fx=20.0, event_fy=20.0,
            event_cx=8.0, event_cy=6.0, N_samples=8, N_importance=8,
            sampling_event_rays=16, sampling_rgb_rays=9,
            num_interpolated_pose=3)
TINY_EVENTS = 500
FIELDS = {"metric", "value", "unit", "ms_per_iter", "model_flops_per_iter",
          "delivered_tflops", "mfu_vs_bf16_peak", "compute_dtype", "platform",
          "mesh_devices", "card", "mesh_rays_per_sec",
          "device_busy_ms_per_step", "launches_per_step"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("overrides", [
    {}, {"compute_dtype": "bfloat16", "N_samples": 8},
    {"fast_ray_sampling": False, "event_width": 16}])
def test_bench_config_equals_the_jax_one(overrides):
    port = dataclasses.asdict(bench.bench_config(**overrides))
    want = dataclasses.asdict(graft._bench_config(**overrides))
    assert port == want
    assert port["fast_ray_sampling"] == overrides.get("fast_ray_sampling", True)


@pytest.mark.parametrize("overrides", [
    {}, {"channels": 1}, {"netwidth": 128}, {"N_importance": 128},
    {"sampling_rgb_rays": 1000}, {"num_interpolated_pose": 7}])
def test_flops_equal_bench_py(overrides):
    tcfg, jcfg = bench.bench_config(**overrides), graft._bench_config(**overrides)
    assert bench.workload_flops_per_iter(tcfg) == jbench.workload_flops_per_iter(jcfg)
    kw = dict(depth=tcfg.netdepth, width=tcfg.netwidth, channels=tcfg.channels)
    assert bench.mlp_flops_per_point(**kw) == jbench.mlp_flops_per_point(**kw)
    if not overrides:
        assert bench.mlp_flops_per_point() == 1_186_816
        assert bench.workload_flops_per_iter(tcfg) == 2_088_416_378_880


def test_bench_batch_equals_the_jax_random_batch():
    H, W = TINY["event_height"], TINY["event_width"]
    tcfg, batch = bench.bench_batch(bench.bench_config(**TINY), H, W,
                                    TINY_EVENTS, seed=0, device="cpu")
    jcfg = graft._bench_config(**TINY)
    jbatch = graft._random_batch(jcfg, H, W, n_events=TINY_EVENTS, seed=0)
    for name in ("pix_idx", "ts", "pol"):
        np.testing.assert_array_equal(getattr(batch.events, name).numpy(),
                                      np.asarray(getattr(jbatch.events, name)),
                                      err_msg=name)
    for name in ("image_flat", "rgb_exp_ts", "K_rgb", "K_evt"):
        got, want = getattr(batch, name).numpy(), np.asarray(getattr(jbatch, name))
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert tcfg.event_window_cap == jevents.window_cap(
        np.asarray(jbatch.events.ts), jcfg.accumulate_time_length)


def test_bench_config_loss_matches_jax():
    """The bench config's loss and every gradient, at tests/test_torch_step.py's
    tiny scene, against JAX's make_loss_fn on the same injected draws (JAX's
    MLP through its plain version, as on the CPU), within LOSS_CASES's
    envelope for the synthetic event loss."""
    _, _, _, loss_rtol, grad_rel = tts.LOSS_CASES["synthetic_gray"]
    size = dict(TINY, event_width=tts.W_EVT, event_height=tts.H_EVT,
                use_pallas=False)
    jcfg = graft._bench_config(**size)
    rng = np.random.default_rng(11)
    knots = (rng.normal(size=(4, 6)) * 0.05).astype(np.float32)
    jparams, jbatch = tts._jax_side(jcfg, 7, jcfg.channels, knots,
                                    np.zeros(6, np.float32))
    draws = tts._draws_np(rng, jcfg)
    jloss_fn, _ = jstep.make_loss_fn(jcfg, tts.H_RGB, tts.W_RGB)
    (jtotal, jm), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        jparams, jbatch, tts._to(draws, jnp.asarray), jnp.asarray(0, jnp.int32))

    tparams, tbatch = tts._port_side(jparams, 7, jcfg.channels)
    tloss_fn, _ = tstep.make_loss_fn(bench.bench_config(**size), tts.H_RGB,
                                     tts.W_RGB)
    ttotal, tm, tgrads = tts._port_value_and_grad(
        tloss_fn, tparams, tbatch,
        tts._to(draws, lambda a: torch.as_tensor(np.array(a))), 0)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=loss_rtol,
                                   err_msg=k)
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=loss_rtol)
    want = jax.tree.leaves(jax.tree.map(np.asarray, jgrads))
    got = [g.numpy() for g in bridge.tree_leaves(tgrads)]
    assert len(got) == len(want)
    for a, w in zip(got, want):
        assert a.shape == w.shape and np.all(np.isfinite(a))
        assert tts._rms(a - w) <= grad_rel * max(tts._rms(w), 1e-30), w.shape


def test_run_step_bench_on_the_cpu():
    cfg = bench.bench_config(**TINY)
    rays_s, s_iter, summary = bench.run_step_bench(
        cfg, TINY["event_height"], TINY["event_width"], inner=2, chunks=1,
        n_events=TINY_EVENTS, device="cpu")
    assert s_iter > 0 and summary is None
    assert rays_s == pytest.approx(bench.rays_per_iter(cfg) / s_iter)


def test_main_prints_one_json_line(capsys):
    cfg = bench.bench_config(**TINY)
    line = bench.main(["--device", "cpu", "--inner", "2", "--chunks", "1"],
                      cfg=cfg, n_events=TINY_EVENTS)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert set(line) == FIELDS
    assert line["metric"] == "train_rays_per_sec_per_chip"
    assert line["platform"] == "cpu" and line["mfu_vs_bf16_peak"] is None
    assert line["card"] is None and line["mesh_devices"] == 1
    assert line["device_busy_ms_per_step"] is None
    assert line["launches_per_step"] is None
    assert line["value"] == line["mesh_rays_per_sec"]
    assert line["compute_dtype"] == "float32"
    assert line["model_flops_per_iter"] == bench.workload_flops_per_iter(cfg)
    assert line["value"] == pytest.approx(
        bench.rays_per_iter(cfg) * 1e3 / line["ms_per_iter"])
    assert line["delivered_tflops"] == pytest.approx(
        line["model_flops_per_iter"] / line["ms_per_iter"] / 1e9)


def test_profile_without_device_time_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no device time"):
        bench.main(["--device", "cpu", "--inner", "1", "--chunks", "1",
                    "--profile", str(tmp_path)], cfg=bench.bench_config(**TINY),
                   n_events=TINY_EVENTS)
    assert not (tmp_path / "top_ops.md").exists()


def test_profile_summary_and_table(tmp_path, monkeypatch):
    """--profile's summary (busy and launches a step) and DIR/top_ops.md
    from it, with the device work of a card's profile planted (a CPU
    profile has none)."""
    from torch.profiler import ProfilerActivity, profile

    work = [("fmlp::k1", 8, 6.0), ("elementwise", 40, 1.0)]
    monkeypatch.setattr(bench, "device_work", lambda prof: work)
    monkeypatch.setattr(bench, "nvidia_smi_line", lambda: "CARD, 1 W")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(2).sum()
    summary = bench.profile_summary(prof, 4)
    assert summary["device_busy_ms_per_step"] == 7.0 / 4
    assert summary["launches_per_step"] == 48 / 4
    assert [k["name"] for k in summary["kernels"]] == ["fmlp::k1",
                                                       "elementwise"]
    bench.write_profile(prof, summary, tmp_path)
    top = (tmp_path / "top_ops.md").read_text()
    assert "CARD, 1 W; device busy 1.750 ms/step over 12 launches" in top
    assert "| 1 | 1.5000 | 0.8571 | 2 | `fmlp::k1` |" in top
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["top_ops.md",
                                                          "trace.json"]


@pytest.mark.parametrize("n", [1, 4])
def test_line_is_per_card_under_a_mesh(n, monkeypatch):
    """On n cards the line gives rays/s and the share of the bf16 peak a
    card, and the whole mesh's rays/s, ms/iter and TFLOP/s."""
    monkeypatch.setattr(bench, "nvidia_smi_line", lambda: "CARD, 1 W")
    cfg = bench.bench_config()
    rays_s, dt = 4.0e5, 0.03
    line = bench.bench_line(cfg, rays_s, dt, n, "cuda",
                            {"device_busy_ms_per_step": 25.0,
                             "launches_per_step": 3900.0})
    assert set(line) == FIELDS
    assert line["value"] == rays_s / n and line["mesh_rays_per_sec"] == rays_s
    flops = bench.workload_flops_per_iter(cfg)
    assert line["delivered_tflops"] == pytest.approx(flops / dt / 1e12)
    assert line["mfu_vs_bf16_peak"] == pytest.approx(
        flops / dt / n / 989e12)
    assert line["mesh_devices"] == n and line["card"] == "CARD, 1 W"
    assert line["device_busy_ms_per_step"] == 25.0


def test_main_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench.main(["--inner", "1"], cfg=bench.bench_config(**TINY),
                   n_events=TINY_EVENTS)
    assert e.value.code not in (0, None)
    assert "--device cpu" in str(e.value.code)


def test_two_gloo_ranks_print_one_line(tmp_path):
    """cli.bench --mesh 2 in two processes with the environment that
    torch.distributed.run gives each (as tests/test_torch_mesh.py starts
    them): rank 0 alone prints, mesh_devices 2, the mesh's rays/s beside
    a rank's half of it, no share of the peak off the card."""
    code = ("import json, sys, torch; torch.set_num_threads(1); "
            "from benerf_tpu_torch.cli import bench; "
            f"bench.main(sys.argv[1:], cfg=bench.bench_config(**json.loads("
            f"{json.dumps(json.dumps(TINY))})), n_events={TINY_EVENTS})")
    argv = ["--device", "cpu", "--mesh", "2", "--inner", "2", "--chunks", "1"]
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "2",
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, *argv],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    line = json.loads(outs[0][0])
    assert outs[1][0] == ""
    assert set(line) == FIELDS and line["mesh_devices"] == 2
    cfg = bench.bench_config(**TINY)
    assert line["mesh_rays_per_sec"] == pytest.approx(
        bench.rays_per_iter(cfg) * 1e3 / line["ms_per_iter"])
    assert line["value"] == line["mesh_rays_per_sec"] / 2
    assert line["mfu_vs_bf16_peak"] is None


def test_breakdown_rows_run_and_name_the_jax_rows():
    jax_rows = set(re.findall(r'results\["(\w+)"\]',
                              (REPO / "tools/perf_breakdown.py").read_text()))
    jax_rows -= {"STEP_MEASURED"}
    renamed = {"pv_pack": "mlp_staging", "z_sort_jnp": "z_sort_torch"}
    want = {renamed.get(r, r) for r in jax_rows} | {"losses", "optimizer"}
    H, W = TINY["event_height"], TINY["event_width"]
    cfg, batch = bench.bench_batch(bench.bench_config(**TINY), H, W,
                                   TINY_EVENTS, device="cpu")
    rows = breakdown.build_rows(cfg, batch, H, W, torch.device("cpu"))
    assert set(rows) == want
    assert set(breakdown.COMPARISON) <= want
    measured = {}
    for name, fn in rows.items():
        measured[name] = got = breakdown.measure(fn, 1, torch.device("cpu"))
        assert got["eager_ms"] > 0 and got["device_ms"] is None, name
        assert got["launches"] is None, name
    # the table of a CPU run: no device numbers, "n/m" in their place
    breakdown.report({
        "card": None, "platform": "cpu", "compute_dtype": "float32",
        "reps": 1, "rows": measured,
        "sum_production_rows": {"eager_ms": 1.0, "device_ms": None,
                                "launches": None},
        "step_measured": {"ms_per_iter": 1.0, "device_busy_ms_per_step": None,
                          "launches_per_step": None},
        "device_share_of_step": None})


def test_breakdown_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        breakdown.main(["--reps", "1"])
    assert e.value.code not in (0, None)


def test_bench_and_breakdown_import_nothing_of_the_jax_side():
    code = ("import sys; sys.path.insert(0, 'tools'); "
            "import benerf_tpu_torch.cli.bench, torch_perf_breakdown; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'benerf_tpu', 'bench', '__graft_entry__')]; "
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
