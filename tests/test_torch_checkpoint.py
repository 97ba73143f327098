"""The port's checkpoints, run directory and CLI on the CPU.

- save -> restore -> the next steps equal an uninterrupted run bit for bit
  (params, every Adam moment and Adam's own step), with one, four and all
  five optimizer groups, and in dispatches of two steps resumed at a
  dispatch boundary;
- restore refuses a checkpoint saved under other optimize_* flags and a
  checkpoint of the JAX package, with the JAX package's error;
- the run directory: args.txt and config.txt, the latter byte for byte the
  config file (as benerf_tpu/train/loop.py _write_run_config);
- cli.train.main(argv, device="cpu") on a scene written by the port's
  writer with eval, video and checkpoints on, in dispatches of two steps,
  then resumed: its files, and the keys of its metrics.jsonl records equal
  to those the JAX loop writes for the same run, at the same steps; without a card and without device="cpu" it raises.
"""

import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

import test_golden_grad as gg
import test_torch_step as ts

from benerf_tpu.core.config import config_from_cli as jconfig_from_cli
from benerf_tpu.train import checkpoint as jckpt
from benerf_tpu.train import loop as jloop
from benerf_tpu.train import step as jstep
from benerf_tpu_torch.cli import train as tcli
from benerf_tpu_torch.core import config as tconfig
from benerf_tpu_torch.data import synthetic as tsynthetic
from benerf_tpu_torch.models import bridge
from benerf_tpu_torch.train import checkpoint as tckpt
from benerf_tpu_torch.train import loop as tloop
from benerf_tpu_torch.train import step as tstep

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The tensors here are tiny: one intra-op thread, so that six test
    workers sharing the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(case, **kw):
    return tconfig.Config(**{**dataclasses.asdict(gg.build_cfg(case)),
                             "optimize_nerf": True, "optimize_pose": True,
                             "netwidth": 32, "netwidth_fine": 32, **kw})


def _state_arrays(state):
    out = {f"p{i}": t.detach().clone()
           for i, t in enumerate(bridge.tree_leaves(state.params))}
    for gi, g in enumerate(state.optimizer.param_groups):
        for pi, t in enumerate(g["params"]):
            for k, v in state.optimizer.state.get(t, {}).items():
                out[f"g{gi}/{pi}/{k}"] = v.clone()
    return out


def _assert_bit_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].device == b[k].device, k
        assert torch.equal(a[k], b[k]), k


_FIVE = {"optimize_trans": True, "optimize_rgb_crf": True,
         "optimize_event_crf": True}


@pytest.mark.parametrize("case,extra,g", [
    ("synthetic_gray", {"optimize_pose": False}, 1),
    ("real_color", {"optimize_trans": True}, 1),
    ("crf_gray", _FIVE, 1),
    ("crf_gray", _FIVE, 2)],
    ids=["one_group", "four_groups", "five_groups",
         "five_groups_dispatches_of_2"])
def test_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path, case, extra, g):
    """g = 1: single steps (make_train_step); g = 2: dispatches of two
    (make_multi_step), saved and resumed at a dispatch boundary, the resumed
    run with a dispatch function of its own, as a new train() makes."""
    cfg = _cfg(case, **extra)
    C = cfg.channels
    scene = ts._tiny_scene(C)
    batch = tloop.make_batch(scene, cfg, *tloop.intrinsics(cfg)[:2], "cpu")

    def stepper():
        if g == 1:
            return tstep.make_train_step(cfg, ts.H_RGB, ts.W_RGB)
        return tstep.make_multi_step(cfg, ts.H_RGB, ts.W_RGB, g)

    def run_to(state, step_fn, end):
        losses = []
        while state.step < end:
            state, m = step_fn(state, batch, cfg.seed)
            losses += m["loss"].reshape(-1).tolist()
        return state, losses

    step_fn = stepper()
    state, _ = run_to(tstep.init_state(cfg, cfg.seed, device="cpu"), step_fn, 2)
    path = tckpt.save(str(tmp_path), state)
    assert path.endswith("000002.ckpt.npz") and tckpt.latest_step(str(tmp_path)) == 2
    state, losses = run_to(state, step_fn, 4)
    want = _state_arrays(state)

    template = tstep.init_state(cfg, cfg.seed + 1, device="cpu")
    restored = tckpt.restore(str(tmp_path), template, device="cpu")
    assert restored.step == 2
    restored, got_losses = run_to(restored, stepper(), 4)
    assert len(got_losses) == 2 and got_losses == losses
    _assert_bit_equal(_state_arrays(restored), want)
    assert restored.step == state.step == 4


def test_restore_needs_a_card_unless_asked(tmp_path, monkeypatch):
    cfg = _cfg("synthetic_gray")
    state = tstep.init_state(cfg, 0, device="cpu")
    tckpt.save(str(tmp_path), state)
    with pytest.raises(ValueError, match="lives on cpu, not on meta"):
        tckpt.restore(str(tmp_path), state, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tckpt.restore(str(tmp_path), state)


def test_restore_refuses_another_structure(tmp_path):
    cfg = _cfg("synthetic_gray")
    tckpt.save(str(tmp_path), tstep.init_state(cfg, 0, device="cpu"))
    for other in (dict(optimize_pose=False), dict(optimize_trans=True),
                  dict(netwidth=16)):
        with pytest.raises(ValueError, match="checkpoint structure mismatch"):
            tckpt.restore(str(tmp_path), tstep.init_state(
                dataclasses.replace(cfg, **other), 0, device="cpu"), device="cpu")
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "empty"),
                      tstep.init_state(cfg, 0, device="cpu"), device="cpu")


def test_restore_refuses_a_jax_checkpoint(tmp_path):
    jcfg = dataclasses.replace(gg.build_cfg("synthetic_gray"), optimize_nerf=True,
                               optimize_pose=True, netwidth=32, netwidth_fine=32)
    jckpt.save(str(tmp_path), jstep.init_state(jcfg, jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="checkpoint structure mismatch"):
        tckpt.restore(str(tmp_path), tstep.init_state(
            tconfig.Config(**dataclasses.asdict(jcfg)), 0, device="cpu"),
            device="cpu")


def test_run_directory_holds_args_and_the_config_file(tmp_path):
    path = REPO / "configs" / "demo.txt"
    cfg = dataclasses.replace(tconfig.load_config(str(path)),
                              logdir=str(tmp_path))
    tloop._write_run_config(cfg, str(tmp_path))
    assert (tmp_path / "config.txt").read_bytes() == path.read_bytes()
    args = (tmp_path / "args.txt").read_text()
    assert f"config = {path}\n" in args and "pose_init = motion_scale\n" in args


# ---- the CLI: a written scene, trained, evaluated, saved and resumed ---------


def _argv(scene, logdir, *extra):
    hw = {"rgb": (40, 40, 50.0), "event": (40, 40, 50.0)}
    argv = ["--config", str(REPO / "configs" / "demo.txt"), "--datadir", scene,
            "--logdir", logdir, "--max_iter", "4", "--console_log_iter", "2",
            "--render_image_iter", "2", "--save_model_iter", "2",
            "--render_video_iter", "4", "--netwidth", "32", "--netwidth_fine",
            "32", "--N_samples", "8", "--N_importance", "8",
            "--sampling_event_rays", "32", "--sampling_rgb_rays", "38",
            "--chunk", "1600", "--use_pallas", "False"]
    for cam, (h, w, f) in hw.items():
        argv += [f"--{cam}_height", str(h), f"--{cam}_width", str(w),
                 f"--{cam}_fx", str(f), f"--{cam}_fy", str(f),
                 f"--{cam}_cx", str(w / 2), f"--{cam}_cy", str(h / 2)]
    return argv + list(extra)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The port's CLI on the port's scene: 4 iterations in dispatches of 2
    (g = gcd(2, 2, 4, 2)), then resumed to 6; the JAX loop for 4 iterations
    on the same files (without the video: g = 2, a scan of 2), for its
    records."""
    root = tmp_path_factory.mktemp("cli")
    scene = str(root / "scene")
    tsynthetic.write_benerf_blender_scene(scene, H=40, W=40, focal=50.0,
                                          n_virtual=7, n_images=1)
    first = tcli.main(_argv(scene, str(root / "port")), device="cpu")
    saved = tckpt.restore(
        str(root / "port" / "0"),
        tstep.init_state(tconfig.config_from_cli(_argv(scene, "x")), 0,
                         device="cpu"), step=4, device="cpu")
    resumed = tcli.main(_argv(scene, str(root / "port"), "--load_checkpoint",
                              "True", "--max_iter", "6"), device="cpu")
    jloop.train(jconfig_from_cli(_argv(scene, str(root / "jax"),
                                       "--render_video_iter", "0")))
    return root, first, saved, resumed


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_cli_trains_evaluates_saves_and_resumes(cli_run):
    root, first, saved, resumed = cli_run
    run = root / "port" / "0"
    assert first.step == 4 and resumed.step == 6
    _assert_bit_equal(_state_arrays(saved), _state_arrays(first))
    assert (run / "config.txt").read_bytes() == (REPO / "configs/demo.txt").read_bytes()
    assert "max_iter = 6\n" in (run / "args.txt").read_text()
    assert sorted(p.name for p in run.glob("*.ckpt.npz")) == [
        "000002.ckpt.npz", "000004.ckpt.npz", "000006.ckpt.npz"]
    for step in (2, 4, 6):
        poses = np.loadtxt(run / "poses_test" / f"poses_test_{step:06d}.txt")
        assert poses.shape == (19, 12) and np.all(np.isfinite(poses))
        assert len(list((run / "images_test" / f"img_test_{step:06d}").glob(
            "test*.png"))) == 19
    video = run / "0_spiral_000004_rgb.mp4"
    assert video.exists() or len(list(
        (run / "0_spiral_000004_rgb_frames").glob("*.png"))) == 90
    recs = _records(run / "metrics.jsonl")
    assert [r["step"] for r in recs if "train_loss" in r] == [1, 2, 3, 4, 5, 6]
    evals = [r for r in recs if "test_mid_psnr" in r]
    assert [r["step"] for r in evals] == [2, 4, 6]
    for r in evals:
        for k in ("test_mid_psnr", "test_mid_ssim", "pose_ate_rmse",
                  "pose_flow_rmse_px", "gt_flow_rms_px"):
            assert np.isfinite(r[k]), k


def test_cli_records_carry_the_keys_of_the_jax_loop(cli_run):
    root = cli_run[0]

    def kinds(path):
        return {frozenset(r) for r in _records(path)}

    assert kinds(root / "port" / "0" / "metrics.jsonl") == kinds(
        root / "jax" / "0" / "metrics.jsonl")


def test_cli_dispatches_record_at_the_jax_loops_iterations(cli_run):
    """The first run's records (4 iterations in dispatches of 2), in file
    order, carry the keys of the JAX loop's records at the same steps:
    one train record per iteration, then the console and eval record of
    each dispatch's last step."""
    root = cli_run[0]

    def steps_and_keys(path, last):
        return [(r["step"], sorted(r)) for r in _records(path)
                if r["step"] <= last]

    jax_recs = steps_and_keys(root / "jax" / "0" / "metrics.jsonl", 4)
    port = steps_and_keys(root / "port" / "0" / "metrics.jsonl", 4)
    assert [s for s, _ in jax_recs] == [1, 2, 2, 3, 4, 4]
    assert port == jax_recs


def test_cli_needs_a_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(_argv(str(tmp_path), str(tmp_path)))


def test_loadpose_refuses_poses_as_knots(cli_run):
    """loadpose hands train() the loaded (n, 3, 5) event poses as the
    initial knots (as benerf_tpu/train/loop.py:197-198 does); the port
    refuses them with a clear error instead of failing inside the spline."""
    root = cli_run[0]
    scene = str(root / "scene")
    rng = np.random.default_rng(4)
    for ev in ("", "_events"):
        R = np.linalg.qr(rng.normal(size=(2, 3, 3)))[0]
        arr = np.concatenate([R, rng.normal(size=(2, 3, 1)),
                              np.tile([[40], [40], [50.0]], (2, 1, 1))], -1)
        np.save(f"{scene}/poses_bounds{ev}.npy", np.concatenate(
            [arr.reshape(2, 15), rng.uniform(1, 5, (2, 2))], -1))
    with pytest.raises(ValueError, match=r"init_knots must be \(4, 6\)"):
        tcli.main(_argv(scene, str(root / "loadpose"), "--loadpose", "True"),
                  device="cpu")
