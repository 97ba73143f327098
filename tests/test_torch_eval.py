"""The port's eval slice against the JAX package and the golden frame.

- frames.render_image (deterministic) against the reference's recorded
  full-frame render (tests/golden/reference_golden_frame.npz) at the bounds
  of tests/test_eval.py `test_full_frame_golden_parity`, its params loaded
  through the JAX torch_compat and the port's bridge;
- chunk invariance; random mode reproducible from its key and different
  across keys; no card and no device given raises;
- renderer.render_rays / render_poses_with_ray_idx against the JAX
  renderer on the same params and rays (deterministic);
- psnr, ssim, compute_img_metric (margin, mask), ate_rmse, rpe,
  reproj_flow_error and the KITTI pose file equal to the JAX package's on
  the same arrays; LPIPS None without weights, as there;
- eval/io: images and video frames readable by imageio (frames where no
  mp4 backend or no imageio is installed), the JSONL records of the JAX
  logger.
"""

import json
import pathlib
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from imageio.v3 import imread

from benerf_tpu.eval import io as jio
from benerf_tpu.eval import metrics as jmetrics
from benerf_tpu.eval import pose_metrics as jpose
from benerf_tpu.geometry import spline as jspline
from benerf_tpu.models import nerf as jnerf
from benerf_tpu.models import torch_compat
from benerf_tpu.render import renderer as jrenderer
from benerf_tpu_torch.eval import frames as tframes
from benerf_tpu_torch.eval import io as tio
from benerf_tpu_torch.eval import metrics as tmetrics
from benerf_tpu_torch.eval import pose_metrics as tpose
from benerf_tpu_torch.models import bridge
from benerf_tpu_torch.render import renderer as trenderer

GOLDEN = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The tensors here are tiny: one intra-op thread, so that six test
    workers sharing the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_params(jparams):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


@pytest.fixture(scope="module")
def golden_case():
    sys.path.insert(0, str(GOLDEN))
    import param_gen

    g = dict(np.load(GOLDEN / "reference_golden_frame.npz"))
    params = {tag: _port_params(torch_compat.nerf_params_from_state_dict(
        param_gen.nerf_state_dict("frame_case", tag, 3)))
        for tag in ("nerf", "nerf_fine")}
    return g, params


def test_render_image_matches_the_golden_frame(golden_case):
    g, params = golden_case
    H, W = g["rgb_map"].shape[:2]
    settings = trenderer.RenderSettings(n_samples=8, n_importance=8, channels=3)
    out = tframes.render_image(params, g["pose"], g["K"], H, W, settings,
                               chunk=H * W, deterministic=True, device="cpu")
    # the bounds of tests/test_eval.py test_full_frame_golden_parity: a few
    # rays flip an inverse-CDF bin at fp32 (u = 1.0 boundary)
    np.testing.assert_allclose(out["rgb"], g["rgb_map"], atol=5e-3)
    np.testing.assert_allclose(out["acc"], g["acc_map"], atol=5e-3)
    dd = np.abs(out["disp"] - g["disp_map"])
    dd = dd[np.isfinite(dd)]
    assert np.quantile(dd, 0.98) < 2e-2, f"disp p98 {np.quantile(dd, 0.98):.3e}"
    assert dd.max() < 0.5, f"disp max {dd.max():.3e}"
    med = np.median(np.abs(out["rgb"] - g["rgb_map"]))
    assert med < 2e-6, f"median rgb error {med:.2e}"


def test_render_image_is_chunk_invariant_and_keyed(golden_case):
    g, params = golden_case
    H, W = g["rgb_map"].shape[:2]
    settings = trenderer.RenderSettings(n_samples=8, n_importance=8, channels=3)

    def render(chunk, **kw):
        return tframes.render_image(params, g["pose"], g["K"], H, W, settings,
                                    chunk=chunk, device="cpu", **kw)

    a, b = render(64, deterministic=True), render(H * W, deterministic=True)
    assert a["rgb"].shape == (H, W, 3) and a["acc"].shape == (H, W)
    assert np.all(np.isfinite(a["rgb"])) and np.all(np.isfinite(a["acc"]))
    for k in ("rgb", "disp", "acc"):
        np.testing.assert_allclose(a[k], b[k], atol=1e-5, equal_nan=True)
    r1, r2, r3 = render(64, key=(5, 1)), render(64, key=(5, 1)), render(64, key=(6, 1))
    np.testing.assert_array_equal(r1["rgb"], r2["rgb"])
    assert np.abs(r1["rgb"] - r3["rgb"]).max() > 1e-3
    assert np.abs(r1["rgb"] - a["rgb"]).max() > 1e-3  # z jitter + sigma noise
    frames = list(tframes.render_trajectory(
        params, np.stack([g["pose"]] * 2), g["K"], H, W, settings, chunk=64,
        deterministic=True, device="cpu"))
    np.testing.assert_array_equal(frames[1]["rgb"], a["rgb"])


def test_render_image_needs_a_card_unless_asked(golden_case, monkeypatch):
    g, params = golden_case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tframes.render_image(params, g["pose"], g["K"], 4, 4,
                             trenderer.RenderSettings(), deterministic=True)


def test_render_rays_and_pose_rays_match_jax():
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    jp = {"nerf": jnerf.init_params(k1, width=64),
          "nerf_fine": jnerf.init_params(k2, width=64)}
    tp = {k: _port_params(v) for k, v in jp.items()}
    rng = np.random.default_rng(4)
    H, W, f = 12, 16, 20.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    poses = np.asarray(jspline.cubic_bspline_pose(
        jnp.asarray(rng.normal(scale=0.05, size=(4, 6)), jnp.float32),
        jnp.linspace(0.2, 0.8, 3)))
    idx = rng.choice(H * W, 20, replace=False)
    js = jrenderer.RenderSettings(n_samples=8, n_importance=8, use_pallas=False)
    ts = trenderer.RenderSettings(n_samples=8, n_importance=8)
    want = jax.jit(jrenderer.render_poses_with_ray_idx,
                   static_argnames=("H", "W", "settings"))(
        jp["nerf"], jp["nerf_fine"], jnp.asarray(poses), jnp.asarray(idx),
        jnp.asarray(K), H=H, W=W, settings=js)
    got = trenderer.render_poses_with_ray_idx(
        tp["nerf"], tp["nerf_fine"], torch.as_tensor(poses.copy()),
        torch.as_tensor(idx), torch.as_tensor(K), H, W, ts)
    rays_o = rng.normal(scale=0.1, size=(30, 3)).astype(np.float32)
    rays_d = np.concatenate([rng.normal(scale=0.3, size=(30, 2)),
                             -np.ones((30, 1))], -1).astype(np.float32)
    want_r = jax.jit(jrenderer.render_rays,
                     static_argnames=("settings", "H", "W"))(
        jp["nerf"], jp["nerf_fine"], jnp.asarray(rays_o), jnp.asarray(rays_d),
        settings=js, H=H, W=W, focal=f)
    got_r = trenderer.render_rays(tp["nerf"], tp["nerf_fine"],
                                  torch.as_tensor(rays_o),
                                  torch.as_tensor(rays_d), ts, H, W, f)
    # deterministic fine samples sit at u = 0 and 1, where fp32 can flip an
    # inverse-CDF bin (measured 5.7e-5 on 6 of 180 elements); the bulk must
    # agree at fp32 noise
    for g_, w_ in ((got, want), (got_r, want_r)):
        assert set(g_) == set(w_)
        for k in ("rgb_map", "acc_map", "rgb0", "acc0"):
            a, b = g_[k].detach().numpy(), np.asarray(w_[k])
            np.testing.assert_allclose(a, b, atol=5e-3, err_msg=k)
            assert np.median(np.abs(a - b)) < 2e-6, k


# ---- metrics -----------------------------------------------------------------


def _images(seed=0, shape=(40, 40, 3)):
    rng = np.random.default_rng(seed)
    a = rng.random(shape)
    return a, np.clip(a + rng.normal(scale=0.05, size=shape), 0, 1)


@pytest.mark.parametrize("shape", [(40, 40, 3), (40, 40), (33, 27, 1)])
def test_image_metrics_equal_jax(shape):
    a, b = _images(1, shape)
    for name in ("mse", "psnr", "ssim"):
        assert getattr(tmetrics, name)(a, b) == getattr(jmetrics, name)(a, b)
    mask = np.ones(shape[:2], bool)
    mask[:3] = False
    for metric in ("mse", "psnr", "ssim"):
        for kw in ({}, {"margin": 0.1}, {"mask": mask}):
            assert (tmetrics.compute_img_metric(a, b, metric, **kw)
                    == jmetrics.compute_img_metric(a, b, metric, **kw))
    assert tmetrics.psnr(a, a) == float("inf")
    with pytest.raises(ValueError, match="not recognized"):
        tmetrics.compute_img_metric(a, b, "brisque")


def test_lpips_is_none_without_weights(monkeypatch):
    monkeypatch.delenv("BENERF_LPIPS_WEIGHTS", raising=False)
    a, b = _images()
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        assert tmetrics.lpips(a, b, device="cpu") is None
        assert jmetrics.lpips(a, b) is None


@pytest.mark.parametrize("call", ["lpips", "compute_img_metric", "compute"])
def test_lpips_without_a_device_or_a_card_raises(call, monkeypatch):
    """LPIPS runs on the card unless the caller passes device="cpu": with no
    card visible and no device it raises (before looking for weights)
    rather than running on the CPU."""
    from benerf_tpu_torch.eval import lpips_torch

    monkeypatch.delenv("BENERF_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, b = _images()
    fn = {"lpips": lambda: tmetrics.lpips(a, b),
          "compute_img_metric": lambda: tmetrics.compute_img_metric(a, b, "lpips"),
          "compute": lambda: lpips_torch.compute(a, b)}[call]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    with pytest.raises(FileNotFoundError):  # the CPU only when asked for
        lpips_torch.compute(a, b, device="cpu")


def _trajectories(seed):
    rng = np.random.default_rng(seed)
    knots = rng.normal(scale=0.05, size=(2, 4, 6)).astype(np.float32)
    return [np.asarray(jspline.cubic_bspline_pose(jnp.asarray(k),
                                                  jnp.linspace(0, 1, 19)),
                       np.float64) for k in knots]


@pytest.mark.parametrize("seed", [0, 1])
def test_pose_metrics_equal_jax(seed):
    est, gt = _trajectories(seed)
    assert tpose.ate_rmse(est, gt) == jpose.ate_rmse(est, gt)
    assert tpose.ate_rmse(est, gt, align=False) == jpose.ate_rmse(est, gt, align=False)
    assert tpose.rpe(est, gt) == jpose.rpe(est, gt)
    assert tpose.rpe(est, gt, delta=3) == jpose.rpe(est, gt, delta=3)
    K = np.array([[90.0, 0, 40], [0, 90.0, 40], [0, 0, 1]])
    assert (tpose.reproj_flow_error(est, gt, K, 4.0, 80, 80)
            == jpose.reproj_flow_error(est, gt, K, 4.0, 80, 80))
    np.testing.assert_array_equal(tpose.align_trajectories(est, gt),
                                  jpose.align_trajectories(est, gt))


# ---- io ------------------------------------------------------------------------


def test_kitti_poses_and_images_as_the_jax_package_writes_them(tmp_path):
    est, _ = _trajectories(2)
    pt = tio.save_poses_kitti(7, str(tmp_path / "t"), est[:, :3])
    pj = jio.save_poses_kitti(7, str(tmp_path / "j"), est[:, :3])
    assert pt.endswith("poses_test/poses_test_000007.txt")
    assert open(pt).read() == open(pj).read()
    for img in (_images(3)[0], _images(3, (40, 40, 1))[0]):
        tio.save_image(str(tmp_path / "t" / "a.png"), img)
        jio.save_image(str(tmp_path / "j" / "a.png"), img,
                       gray=img.shape[-1] == 1)
        np.testing.assert_array_equal(imread(tmp_path / "t" / "a.png"),
                                      imread(tmp_path / "j" / "a.png"))
    np.testing.assert_array_equal(tio.to8bit(img), jio.to8bit(img))


def test_video_frames_without_an_mp4_backend_or_imageio(tmp_path, monkeypatch):
    frames = [_images(s, (8, 10, 3))[0] for s in range(3)]
    path = tmp_path / "v" / "0_spiral_000004_rgb.mp4"
    with pytest.warns(UserWarning, match="no video backend"):
        tio.save_video(str(path), frames)
    if path.exists():  # this machine has an mp4 backend
        assert path.stat().st_size > 0
    else:
        for i, f in enumerate(frames):
            np.testing.assert_array_equal(
                imread(tmp_path / "v" / "0_spiral_000004_rgb_frames" / f"{i:04d}.png"),
                tio.to8bit(f))
    import builtins

    real_import = builtins.__import__

    def no_imageio(name, *a, **k):
        if name.startswith("imageio"):
            raise ImportError("No module named 'imageio'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_imageio)
    with pytest.warns(UserWarning, match="No module named 'imageio'"):
        tio.save_video(str(tmp_path / "w" / "b.mp4"), frames)
    assert len(list((tmp_path / "w" / "b_frames").iterdir())) == 3


def test_jsonl_logger_writes_the_records_of_the_jax_logger(tmp_path):
    recs = {}
    for name, mod in (("t", tio), ("j", jio)):
        log = mod.JsonlLogger(str(tmp_path / name / "m.jsonl"))
        log.write_record(1, {"train_loss": np.float32(0.5), "train_x": 2})
        log.update_buffer(1)  # empty buffer: no record
        log.write("rays_per_sec", 10.0)
        log.write("test_mid_psnr", np.float64(30.5))
        log.update_buffer(2)
        log.close()
        with open(tmp_path / name / "m.jsonl") as f:
            recs[name] = [json.loads(line) for line in f]
    for r in recs["t"] + recs["j"]:
        r.pop("time", None)
    assert recs["t"] == recs["j"] == [
        {"step": 1, "train_loss": 0.5, "train_x": 2.0},
        {"step": 2, "rays_per_sec": 10.0, "test_mid_psnr": 30.5}]
