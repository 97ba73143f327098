"""The port's inference and evaluation entry points against the JAX package.

- models/torch_compat: the reference state dicts of tests/golden/param_gen.py
  (viewdirs, one and three channels), the no-viewdirs layout and the CRF
  layout of tests/test_robustness.py give the JAX package's trees leaf for
  leaf, bit for bit;
- cli/test: the same reference .tar (graph, global_step and five optimizer
  state dicts, read with weights_only=True) through both packages' import;
  load_params falls back to the latest checkpoint with the JAX warning;
  both packages' main, on the same params, write the same KITTI poses and,
  with render_trajectory made deterministic, the same images and depth
  maps; the video's 90 frames; nothing at step 0; no card and no device
  given raises;
- cli/evaluate: both packages' summaries on the same PNG folders (LPIPS
  too, on one seeded network's weights), the count mismatch, a .jpg
  without imageio; no card and no device given raises;
- geometry/bezier: poses and autograd gradients against the JAX function
  and jax.grad, in float32 and float64.
"""

import dataclasses
import functools
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from imageio.v3 import imread

from benerf_tpu.cli import evaluate as jevaluate
from benerf_tpu.cli import test as jtest
from benerf_tpu.core.config import Config as JConfig
from benerf_tpu.core.config import config_from_cli as jconfig_from_cli
from benerf_tpu.eval import frames as jframes
from benerf_tpu.eval import lpips_torch as jlpips
from benerf_tpu.geometry import bezier as jbezier
from benerf_tpu.models import torch_compat as jcompat
from benerf_tpu.train import checkpoint as jckpt
from benerf_tpu.train import step as jstep
from benerf_tpu_torch.cli import evaluate as tevaluate
from benerf_tpu_torch.cli import test as ttest
from benerf_tpu_torch.core import config as tconfig
from benerf_tpu_torch.data import png
from benerf_tpu_torch.eval import frames as tframes
from benerf_tpu_torch.eval import lpips_torch as tlpips
from benerf_tpu_torch.geometry import bezier as tbezier
from benerf_tpu_torch.models import bridge
from benerf_tpu_torch.models import torch_compat as tcompat
from benerf_tpu_torch.train import checkpoint as tckpt
from benerf_tpu_torch.train import step as tstep

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden"


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The tensors here are tiny: one intra-op thread, so that six test
    workers sharing the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def _assert_trees_bit_equal(port, ref):
    """Same nested keys, and every leaf of the same dtype and bits."""
    assert _paths(port) == _paths(ref)
    for p, t, j in zip(_paths(port), bridge.tree_leaves(port),
                       jax.tree.leaves(ref)):
        j = np.asarray(j)
        got = t.detach().cpu().numpy()
        assert got.dtype == j.dtype and got.shape == j.shape, p
        np.testing.assert_array_equal(got, j, err_msg=p)


# ---- models/torch_compat ----------------------------------------------------


def _golden_sd(channels):
    sys.path.insert(0, str(GOLDEN))
    import param_gen

    return param_gen.nerf_state_dict("frame_case", "nerf", channels)


def _no_viewdirs_sd(rng):
    sd = {}
    for i in range(8):
        fan_in = 63 if i == 0 else (256 + 63 if i == 5 else 256)
        sd[f"pts_linears.{i}.weight"] = rng.normal(size=(256, fan_in)).astype(np.float32)
        sd[f"pts_linears.{i}.bias"] = rng.normal(size=(256,)).astype(np.float32)
    sd["output_linear.weight"] = rng.normal(size=(4, 256)).astype(np.float32)
    sd["output_linear.bias"] = rng.normal(size=(4,)).astype(np.float32)
    return {"net." + k: v for k, v in sd.items()}


@pytest.mark.parametrize("layout", ["viewdirs_c3", "viewdirs_c1", "no_viewdirs"])
def test_nerf_state_dict_gives_the_jax_tree(layout):
    if layout == "no_viewdirs":
        sd, prefix = _no_viewdirs_sd(np.random.default_rng(0)), "net."
    else:
        sd, prefix = _golden_sd(1 if layout.endswith("c1") else 3), ""
    port = tcompat.nerf_params_from_state_dict(sd, prefix, device="cpu")
    _assert_trees_bit_equal(port, jcompat.nerf_params_from_state_dict(sd, prefix))
    # torch tensors in the state dict give the same tree, sharing no memory
    tsd = {k: torch.as_tensor(v) for k, v in sd.items()}
    port_t = tcompat.nerf_params_from_state_dict(tsd, prefix, device="cpu")
    _assert_trees_bit_equal(port_t, jcompat.nerf_params_from_state_dict(sd, prefix))
    with torch.no_grad():
        for t in bridge.tree_leaves(port_t):
            assert t.is_contiguous()
            t.add_(1.0)
    np.testing.assert_array_equal(tsd[prefix + "pts_linears.0.bias"].numpy(),
                                  sd[prefix + "pts_linears.0.bias"])


def _lin(gen, out_f, in_f):
    return (torch.randn(out_f, in_f, generator=gen) * 0.1,
            torch.randn(out_f, generator=gen) * 0.1)


def _crf_sd(gen, prefix, width=16):
    """tests/test_robustness.py's CRF layout: Linear layers at even indices
    of an nn.Sequential, 1 -> width -> width -> 1."""
    sd = {}
    for j, (o, i) in enumerate([(width, 1), (width, width), (1, width)]):
        sd[f"{prefix}{2 * j}.weight"], sd[f"{prefix}{2 * j}.bias"] = _lin(gen, o, i)
    return sd


def test_crf_state_dict_gives_the_jax_tree():
    gen = torch.Generator().manual_seed(1)
    for prefix in ("rgb_crf.mlp_gray.", "event_crf.mlp_luminance."):
        sd = _crf_sd(gen, prefix)
        np_sd = {k: v.numpy() for k, v in sd.items()}
        _assert_trees_bit_equal(
            tcompat.crf_params_from_state_dict(sd, prefix, device="cpu"),
            jcompat.crf_params_from_state_dict(np_sd, prefix))


# ---- cli/test: the reference .tar --------------------------------------------


def _reference_tar(path, with_crf):
    """A .tar in the reference's layout (test.py:98-107, SURVEY.md :330):
    global_step, the graph's state dict and five optimizer state dicts."""
    gen = torch.Generator().manual_seed(0)
    sd = {}
    for prefix in ("nerf.", "nerf_fine."):
        for i in range(8):
            in_f = 63 if i == 0 else (256 + 63 if i == 5 else 256)
            sd[f"{prefix}pts_linears.{i}.weight"], sd[f"{prefix}pts_linears.{i}.bias"] = (
                _lin(gen, 256, in_f))
        for name, (o, i) in {"feature_linear": (256, 256),
                             "alpha_linear": (1, 256),
                             "rgb_linear": (3, 128),
                             "views_linears.0": (128, 256 + 27)}.items():
            sd[f"{prefix}{name}.weight"], sd[f"{prefix}{name}.bias"] = _lin(gen, o, i)
    sd["evt_knot_pose_se3.params.weight"] = torch.randn(4, 6, generator=gen) * 0.1
    sd["transform.params.weight"] = torch.randn(1, 6, generator=gen) * 0.01
    if with_crf:
        sd.update(_crf_sd(gen, "rgb_crf.mlp_gray."))
        sd.update(_crf_sd(gen, "event_crf.mlp_luminance."))
    ckpt = {"global_step": 200000, "graph": sd}
    for name in ("nerf", "pose", "trans", "rgb_crf", "event_crf"):
        p = torch.nn.Parameter(torch.randn(5, generator=gen))
        opt = torch.optim.Adam([p], lr=5e-4)
        p.grad = torch.ones(5)
        opt.step()
        ckpt[f"optimizer_{name}_state_dict"] = opt.state_dict()
    torch.save(ckpt, path)


def _tar_cfgs(**kw):
    kw = dict(rgb_crf_net_hidden=1, rgb_crf_net_width=16,
              event_crf_net_hidden=1, event_crf_net_width=16, checkpoint=200000,
              **kw)
    return tconfig.Config(**kw), JConfig(**kw)


@pytest.mark.parametrize("with_crf", [True, False], ids=["crf", "no_crf"])
def test_tar_import_equals_jax(tmp_path, with_crf):
    path = str(tmp_path / "200000.tar")
    _reference_tar(path, with_crf)
    tcfg, jcfg = _tar_cfgs()
    port, step = ttest._params_from_torch_tar(tcfg, path, "cpu")
    ref, jstep_ = jtest._params_from_torch_tar(jcfg, path)
    assert step == jstep_ == 200000
    keys = ["nerf", "nerf_fine", "knots", "transform"]
    keys += ["rgb_crf", "event_crf"] if with_crf else []
    _assert_trees_bit_equal({k: port[k] for k in keys}, {k: ref[k] for k in keys})
    assert tuple(port["transform"].shape) == (6,)
    # the rest is build_params': the same structure as the JAX package's
    assert _paths(port) == _paths(ref)
    # load_params picks the requested .tar
    params, step = ttest.load_params(tcfg, str(tmp_path), "cpu")
    assert step == 200000
    assert torch.equal(params["knots"], port["knots"])


def test_load_params_falls_back_to_latest(tmp_path, capsys):
    """The counterpart of tests/test_robustness.py
    test_cli_load_params_falls_back_to_latest."""
    cfg = tconfig.Config(checkpoint=200000, netwidth=32, netwidth_fine=32,
                         optimize_nerf=True, optimize_pose=True)
    state = tstep.init_state(cfg, 0, device="cpu")._replace(step=7)
    tckpt.save(str(tmp_path), state)
    params, step = ttest.load_params(cfg, str(tmp_path), "cpu")
    assert step == 7
    assert "falling back to latest (7)" in capsys.readouterr().out
    assert torch.equal(params["knots"], state.params["knots"])
    # the requested checkpoint when it exists: no warning
    params, step = ttest.load_params(dataclasses.replace(cfg, checkpoint=7),
                                     str(tmp_path), "cpu")
    assert step == 7 and "WARN" not in capsys.readouterr().out


# ---- cli/test: the pipeline ---------------------------------------------------


def _test_argv(logdir, *extra):
    argv = ["--config", str(REPO / "configs" / "demo.txt"), "--logdir", logdir,
            "--checkpoint", "7", "--netwidth", "32", "--netwidth_fine", "32",
            "--N_samples", "8", "--N_importance", "8", "--chunk", "100",
            "--use_pallas", "False", "--rgb_height", "16", "--rgb_width", "16",
            "--rgb_fx", "20", "--rgb_fy", "20", "--rgb_cx", "8", "--rgb_cy", "8"]
    return argv + list(extra)


@pytest.fixture(scope="module")
def saved_runs(tmp_path_factory):
    """One JAX state (knots moved off their near-zero draw) saved by the JAX
    package, and the same params saved by the port, at step 7."""
    root = tmp_path_factory.mktemp("cli_test")
    jcfg = jconfig_from_cli(_test_argv("x"))
    state = jstep.init_state(jcfg, jax.random.PRNGKey(0))
    knots = np.random.default_rng(3).normal(scale=0.05, size=(4, 6))
    state.params["knots"] = jnp.asarray(knots, jnp.float32)
    state.params["transform"] = jnp.asarray([0.01, -0.02, 0.0, 0.03, 0.0, -0.01],
                                            jnp.float32)
    jckpt.save(str(root / "jax" / "0"), state._replace(step=state.step + 7))
    tcfg = tconfig.config_from_cli(_test_argv("x"))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, state.params),
                                      device="cpu")
    tckpt.save(str(root / "port" / "0"), tstep.init_state(
        tcfg, 0, device="cpu", params=params)._replace(step=7))
    return root


def _deterministic(monkeypatch, module):
    monkeypatch.setattr(module, "render_trajectory", functools.partial(
        module.render_trajectory, deterministic=True))


def test_cli_test_writes_the_poses_and_images_of_the_jax_cli(saved_runs,
                                                            monkeypatch):
    root = saved_runs
    _deterministic(monkeypatch, jframes)
    _deterministic(monkeypatch, tframes)
    flags = ("--extract_poses", "True", "--render_images", "True",
             "--num_extract_poses", "11", "--num_render_images", "3",
             "--depth", "True")
    jtest.main(_test_argv(str(root / "jax"), *flags))
    ttest.main(_test_argv(str(root / "port"), *flags), device="cpu")
    out = {k: root / k / "0" / "test_results" for k in ("jax", "port")}

    rel = "poses_test/poses_test_000007.txt"
    p_port, p_jax = np.loadtxt(out["port"] / rel), np.loadtxt(out["jax"] / rel)
    assert p_port.shape == (11, 12)
    np.testing.assert_allclose(p_port, p_jax, rtol=0, atol=1e-6)

    img_dir = "image_test/img_test_000007"
    names = sorted(p.name for p in (out["jax"] / img_dir).iterdir())
    assert names == sorted(p.name for p in (out["port"] / img_dir).iterdir())
    assert names == [f"{k}{j:03d}.png" for k in ("depth_", "test") for j in range(3)]
    for name in names:
        a = png.read(str(out["port"] / img_dir / name)).astype(int)
        b = np.asarray(imread(out["jax"] / img_dir / name)).astype(int)
        assert a.shape == b.shape and a.shape[:2] == (16, 16), name
        assert np.abs(a - b).max() <= 1, name  # within 1/255


def test_cli_test_writes_the_video_and_nothing_at_step_0(saved_runs, tmp_path):
    root = saved_runs
    ttest.main(_test_argv(str(root / "port"), "--render_video", "True"),
               device="cpu")
    out = root / "port" / "0" / "test_results"
    video = out / "0_spiral_000007_rgb.mp4"
    frames = list((out / "0_spiral_000007_rgb_frames").glob("*.png"))
    assert video.is_file() or len(frames) == 90
    # a checkpoint at step 0 writes nothing (as the JAX CLI)
    cfg = tconfig.config_from_cli(_test_argv(str(tmp_path)))
    tckpt.save(str(tmp_path / "0"), tstep.init_state(cfg, 0, device="cpu"))
    ttest.main(_test_argv(str(tmp_path), "--checkpoint", "0", "--extract_poses",
                          "True", "--render_images", "True", "--render_video",
                          "True"), device="cpu")
    assert list((tmp_path / "0" / "test_results").iterdir()) == []


def test_cli_test_needs_a_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttest.main(_test_argv(str(tmp_path)))


# ---- cli/evaluate -------------------------------------------------------------


def _write_folder(d, rng, n, shape, noise):
    d.mkdir()
    base = rng.random(shape)
    for i in range(n):
        img = np.clip(base + noise * rng.normal(size=shape), 0, 1)
        png.write(str(d / f"{i:03d}.png"), (255 * img).astype(np.uint8))
    (d / "notes.txt").write_text("not an image")


@pytest.mark.parametrize("shape", [(20, 24, 3), (20, 24)], ids=["rgb", "gray"])
def test_evaluate_equals_jax(tmp_path, shape, capsys):
    rng = np.random.default_rng(7)
    _write_folder(tmp_path / "res", rng, 4, shape, 0.05)
    _write_folder(tmp_path / "gt", rng, 4, shape, 0.0)
    port = tevaluate.evaluate(str(tmp_path / "res"), str(tmp_path / "gt"),
                              device="cpu")
    ref = jevaluate.evaluate(str(tmp_path / "res"), str(tmp_path / "gt"))
    assert port.keys() == ref.keys() >= {"psnr", "ssim"}
    for k in ref:
        assert np.isfinite(port[k])
        assert port[k] == pytest.approx(ref[k], rel=1e-12)
    tevaluate.main(["--result", str(tmp_path / "res"), "--groundtruth",
                    str(tmp_path / "gt")], device="cpu")
    port_out = capsys.readouterr().out
    jevaluate.main(["--result", str(tmp_path / "res"), "--groundtruth",
                    str(tmp_path / "gt")])
    assert port_out == capsys.readouterr().out


def test_evaluate_count_mismatch_and_jpg_without_imageio(tmp_path, monkeypatch):
    rng = np.random.default_rng(8)
    _write_folder(tmp_path / "res", rng, 3, (8, 8, 3), 0.1)
    _write_folder(tmp_path / "gt", rng, 2, (8, 8, 3), 0.0)
    with pytest.raises(AssertionError, match="3 results vs 2 GT images"):
        tevaluate.evaluate(str(tmp_path / "res"), str(tmp_path / "gt"),
                           device="cpu")
    with pytest.raises(AssertionError, match="3 results vs 2 GT images"):
        jevaluate.evaluate(str(tmp_path / "res"), str(tmp_path / "gt"))
    (tmp_path / "gt" / "x.jpg").write_bytes(b"")
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    with pytest.raises(ImportError, match="needs imageio"):
        tevaluate.evaluate(str(tmp_path / "res"), str(tmp_path / "gt"),
                           device="cpu")


def _lpips_weights(path):
    """A seeded LPIPS network's state dict, saved where both packages'
    lpips_torch read it; its linear heads nonnegative, as trained ones are."""
    empty = path.parent / "empty.pth"
    torch.save({}, empty)
    torch.manual_seed(0)
    sd = tlpips._build(str(empty)).state_dict()
    torch.save({k: v.abs() if k.startswith("lins.") else v
                for k, v in sd.items()}, path)
    return path


def test_evaluate_lpips_with_weights_equals_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(9)
    _write_folder(tmp_path / "res", rng, 2, (20, 24, 3), 0.05)
    _write_folder(tmp_path / "gt", rng, 2, (20, 24, 3), 0.0)
    monkeypatch.setenv("BENERF_LPIPS_WEIGHTS",
                       str(_lpips_weights(tmp_path / "lpips.pth")))
    monkeypatch.setattr(tlpips, "_MODEL", None)
    monkeypatch.setattr(jlpips, "_MODEL", None)
    port = tevaluate.evaluate(str(tmp_path / "res"), str(tmp_path / "gt"),
                              device="cpu")
    ref = jevaluate.evaluate(str(tmp_path / "res"), str(tmp_path / "gt"))
    assert port.keys() == ref.keys() == {"psnr", "ssim", "lpips"}
    assert np.isfinite(port["lpips"]) and port["lpips"] > 0
    assert port["lpips"] == pytest.approx(ref["lpips"], rel=1e-6)


def test_evaluate_needs_a_card_unless_asked(tmp_path, monkeypatch):
    rng = np.random.default_rng(10)
    _write_folder(tmp_path / "res", rng, 1, (8, 8, 3), 0.1)
    _write_folder(tmp_path / "gt", rng, 1, (8, 8, 3), 0.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
            lambda: tevaluate.evaluate(str(tmp_path / "res"), str(tmp_path / "gt")),
            lambda: tevaluate.main(["--result", str(tmp_path / "res"),
                                    "--groundtruth", str(tmp_path / "gt")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---- geometry/bezier ----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bezier_poses_and_gradients_equal_jax(dtype):
    rng = np.random.default_rng(5)
    knots = rng.normal(scale=0.2, size=(4, 6)).astype(dtype)
    u = np.concatenate([[0.0, 1.0], rng.random(6)]).astype(dtype)
    w = rng.normal(size=(len(u), 3, 4)).astype(dtype)
    tol = 1e-6 if dtype == "float32" else 1e-12

    def jloss(k, uu, ww):
        return jnp.sum(jbezier.cubic_bezier_pose(k, uu) * ww)

    with jax.enable_x64(dtype == "float64"):
        args = (jnp.asarray(knots), jnp.asarray(u))
        want = np.asarray(jax.jit(jbezier.cubic_bezier_pose)(*args))
        want_g = np.asarray(jax.jit(jax.grad(jloss))(*args, jnp.asarray(w)))
    assert want.dtype == dtype

    tk = torch.tensor(knots, requires_grad=True)
    got = tbezier.cubic_bezier_pose(tk, torch.as_tensor(u))
    assert got.dtype == getattr(torch, dtype) and got.shape == (len(u), 3, 4)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=tol)
    (got * torch.as_tensor(w)).sum().backward()
    scale = max(np.abs(want_g).max(), 1.0)
    np.testing.assert_allclose(tk.grad.numpy(), want_g, rtol=0, atol=tol * scale)
