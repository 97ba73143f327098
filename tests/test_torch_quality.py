"""The port's quality harness and BRISQUE against the JAX package.

- eval/brisque: the 36 features equal the JAX package's on seeded RGB and
  gray images; the contract, libsvm parser / predictor and score gating of
  tests/test_eval_gated.py; a malformed model file raises;
- eval/quality: on one scene written by the JAX package's run_quality and
  reused by the port's, for each of the three scene families, the baseline
  (the blurry input's PSNR / SSIM, and with the same knots injected into
  both packages' init_state, every initial pose error) and the gates equal
  the JAX package's, training replaced by one recorded eval;
  gt_pose_samples equal; the run isolation of tests/test_train.py
  test_quality_harness_run_isolation, trained by the port on the CPU; no
  card and no device given raises.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from benerf_tpu.data import datasets as jdatasets
from benerf_tpu.eval import brisque as jbrisque
from benerf_tpu.eval import quality as jquality
from benerf_tpu.train import loop as jloop
from benerf_tpu.train import step as jstep
from benerf_tpu_torch.data import datasets as tdatasets
from benerf_tpu_torch.eval import brisque as tbrisque
from benerf_tpu_torch.eval import quality as tquality
from benerf_tpu_torch.train import loop as tloop
from benerf_tpu_torch.train import step as tstep


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The tensors here are tiny: one intra-op thread, so that six test
    workers sharing the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- eval/brisque ---------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 64, 3), (48, 52)], ids=["rgb", "gray"])
def test_brisque_features_equal_jax(shape):
    img = np.random.default_rng(0).random(shape)
    img = gaussian_filter(img, 1.0)  # some structure beside the noise
    got, want = tbrisque.features(img), jbrisque.features(img)
    assert got.shape == (36,) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_brisque_features_contract():
    rng = np.random.default_rng(0)
    img = rng.random((64, 64, 3))
    f = tbrisque.features(img)
    assert f.shape == (36,)
    assert np.all(np.isfinite(f))
    # a heavily blurred image has measurably different MSCN statistics
    f2 = tbrisque.features(gaussian_filter(img, (4, 4, 0)))
    assert not np.allclose(f, f2, atol=1e-3)


_LIBSVM_MODEL = """svm_type epsilon_svr
kernel_type rbf
gamma 0.05
nr_class 2
total_sv 2
rho 0.25
SV
1.5 1:0.1 2:0.2 3:0.3
-0.7 1:1.0 36:2.0
"""


def test_brisque_libsvm_parser_and_predict(tmp_path):
    path = os.path.join(str(tmp_path), "model.txt")
    with open(path, "w") as f:
        f.write(_LIBSVM_MODEL)
    model = tbrisque._load_libsvm_model(path)
    assert model["gamma"] == 0.05 and model["rho"] == 0.25
    assert model["svs"].shape == (2, 36)
    np.testing.assert_allclose(model["coefs"], [1.5, -0.7])
    np.testing.assert_allclose(model["svs"][0, :3], [0.1, 0.2, 0.3])
    assert model["svs"][1, 35] == 2.0
    ref = jbrisque._load_libsvm_model(path)
    for k in ("coefs", "svs"):
        np.testing.assert_array_equal(model[k], ref[k])

    x = np.linspace(0.0, 1.0, 36)
    sv = model["svs"]
    k = np.exp(-0.05 * np.sum((sv - x) ** 2, axis=1))
    expected = 1.5 * k[0] - 0.7 * k[1] - 0.25
    assert tbrisque._svr_predict(model, x) == pytest.approx(expected, rel=1e-12)


def test_brisque_score_gating(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    img = rng.random((48, 48))
    monkeypatch.delenv("BENERF_BRISQUE_MODEL", raising=False)
    assert tbrisque.score(img) is None
    assert tbrisque.score(img, str(tmp_path / "absent.txt")) is None

    path = os.path.join(str(tmp_path), "model.txt")
    with open(path, "w") as f:
        f.write(_LIBSVM_MODEL)
    monkeypatch.setenv("BENERF_BRISQUE_MODEL", path)
    s = tbrisque.score(img)
    assert s is not None and np.isfinite(s)
    assert s == pytest.approx(jbrisque.score(img), rel=1e-12)
    # only a missing file gives None: a malformed one raises
    bad = tmp_path / "bad.txt"
    bad.write_text("gamma 0.05\nSV\n1.5 1:x\n")
    with pytest.raises(ValueError):
        tbrisque.score(img, str(bad))


# ---- eval/quality -----------------------------------------------------------------


_KNOTS = np.random.default_rng(11).normal(scale=0.02, size=(4, 6)).astype(np.float32)
_TINY = dict(iters=2, evals=1, H=24, W=24, seed=0, sampling_event_rays=16,
             sampling_rgb_rays=15, num_interpolated_pose=3, N_samples=8,
             N_importance=8, use_pallas=False, console_log_iter=1)


def _recorded_eval(cfg, *args, **kw):
    """In place of train(): one eval record, as periodic_eval logs it."""
    d = os.path.join(cfg.logdir, str(cfg.index))
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "metrics.jsonl"), "w") as f:
        f.write(json.dumps({"step": cfg.max_iter, "test_mid_psnr": 30.0,
                            "test_mid_ssim": 0.9, "pose_flow_rmse_px": 0.5,
                            "gt_flow_rms_px": 2.0}) + "\n")


@pytest.mark.parametrize("dataset", ["BeNeRF_Blender", "E2NeRF_Synthetic",
                                     "E2NeRF_Real"])
def test_quality_baseline_and_gates_equal_jax(tmp_path, monkeypatch, dataset):
    """The JAX package writes the scene; the port's run_quality reuses it.
    Both trajectories start from the same injected knots."""
    j_init, t_init = jstep.init_state, tstep.init_state
    monkeypatch.setattr(jstep, "init_state", lambda cfg, key, **kw: j_init(
        cfg, key, init_knots=jnp.asarray(_KNOTS)))
    monkeypatch.setattr(tstep, "init_state", lambda cfg, seed, device=None, **kw:
                        t_init(cfg, seed, device=device, init_knots=_KNOTS))
    monkeypatch.setattr(jloop, "train", _recorded_eval)
    monkeypatch.setattr(tloop, "train", _recorded_eval)
    kw = dict(_TINY, dataset=dataset, target_blur_px=4.0)
    ref = jquality.run_quality(str(tmp_path), **dict(kw))
    got = tquality.run_quality(str(tmp_path), device="cpu", **dict(kw))

    assert got.keys() == ref.keys() - {"platform"} | {"platform"}
    assert got["platform"] == "cpu" and got["run_dir"] != ref["run_dir"]
    assert got["scene"] == ref["scene"] and got["config"] == ref["config"]
    assert got["checkpoints"] == ref["checkpoints"] and got["passed"] == ref["passed"]
    assert got["baseline"].keys() == ref["baseline"].keys()
    b, r = got["baseline"], ref["baseline"]
    for k in ("blurry_input_psnr", "blurry_input_ssim"):
        assert b[k] == pytest.approx(r[k], rel=1e-12), k
    # the poses come from float32 splines on either side (~1e-7 apart):
    # flows in px and positions agree to that; a relative rotation's angle
    # is an arccos in float32, so one ulp of cos(theta) near 1 (2**-24)
    # moves it by 2**-24 / theta rad
    for k in ("pose_flow_rmse_px", "gt_flow_rms_px"):
        assert b[k] == pytest.approx(r[k], rel=1e-6), k
    for k in ("pose_ate_rmse", "pose_rpe_trans"):
        assert b[k] == pytest.approx(r[k], rel=0, abs=1e-8), k
    ulp_deg = np.degrees(2.0**-24 / np.radians(r["pose_rpe_rot_deg"]))
    assert b["pose_rpe_rot_deg"] == pytest.approx(
        r["pose_rpe_rot_deg"], rel=0, abs=8 * ulp_deg)
    assert r["gt_flow_rms_px"] > 0.5  # the scene moves


def test_gt_pose_samples_equal_jax(tmp_path):
    from benerf_tpu.data import synthetic

    synthetic.write_benerf_blender_scene(str(tmp_path), H=24, W=24, focal=90.0,
                                         n_images=1)
    jcfg = jquality.demo_config(str(tmp_path), "x", 2, H=24, W=24)
    tcfg = tquality.demo_config(str(tmp_path), "x", 2, H=24, W=24)
    js = jdatasets.load_scene(str(tmp_path), jcfg)
    ts = tdatasets.load_scene(str(tmp_path), tcfg, device="cpu")
    np.testing.assert_array_equal(ts.image, js.image)
    got = tquality.gt_pose_samples(ts, tcfg, 19)
    want = np.asarray(jquality.gt_pose_samples(js, jcfg, 19))
    assert got.shape == (19, 3, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_quality_harness_run_isolation(tmp_path):
    """Two quality runs in one workdir do not contaminate each other: each
    gets a fresh run-NNN logdir and harvests only its own evals (JsonlLogger
    appends)."""
    a1 = tquality.run_quality(str(tmp_path), device="cpu", **_TINY)
    a2 = tquality.run_quality(str(tmp_path), device="cpu", **_TINY)
    assert a1["run_dir"] != a2["run_dir"]
    assert len(a1["checkpoints"]) == 1 and len(a2["checkpoints"]) == 1
    assert a1["wall_s"] > 0 and a1["platform"] == "cpu"
    assert a1["scene"]["generator"]["scene_format_version"] >= 2
    c = a1["checkpoints"][0]
    assert c["step"] == 2
    assert all(np.isfinite(c[k]) for k in ("test_mid_psnr", "pose_flow_rmse_px"))
    assert set(a1["passed"]) == {"deblur_psnr_beats_blurry_input",
                                 "pose_flow_improves"}


def test_quality_needs_a_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tquality.run_quality(str(tmp_path), **_TINY)
