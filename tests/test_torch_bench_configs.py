"""The benchmark's configurations beside tanabata's:

- `benchmark/configs/tanabata_bf16.json`: tanabata in the port's bf16
  mode, on the fused route (K1/K2), and in every other key the shipped
  tanabata configuration the float32 cells run, so that its cell measures
  neither the plain route nor a drifted copy;
- `benchmark/configs/tanabata_gray.json`: the shipped gray file
  (`channels = 1`) as the port resolves it, tanabata in every key the file
  leaves to the defaults, on the fused route; at a small size its step
  (the port's plain route on the CPU, through the benchmark's dispatch)
  gives the loss and gradients of the float64 reference
  (`benchmark/reference/train.py`), and a planted fault does not.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path

import pytest
import torch

from benchmark import inputs, train_cell
from benchmark.calibrate import planted
from benchmark.reference import train as ref_train
from benerf_tpu_torch.core.config import Config, load_config
from benerf_tpu_torch.data import events as events_mod
from benerf_tpu_torch.ops import mlp
from benerf_tpu_torch.render import renderer
from benerf_tpu_torch.train import step as step_mod

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "benchmark" / "configs"


def _conf(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_bf16_config_is_the_bf16_mode():
    conf = _conf("tanabata_bf16")
    cfg = Config(**conf["config"])
    assert cfg.compute_dtype == "bfloat16"
    assert conf["precision"] == "bfloat16"


def _routes(name):
    cfg = Config(**_conf(name)["config"])
    s = renderer.RenderSettings.from_config(cfg)
    params = step_mod.build_params(cfg, device="cpu")
    viewdirs = torch.ones(1, 3) if s.use_viewdirs else None
    return [mlp.route(params[family], viewdirs, s.multires, s.multires_views,
                      s.use_barf_c2f, s.use_pallas)
            for family in ("nerf", "nerf_fine")]


def test_bf16_config_takes_the_fused_route():
    assert _routes("tanabata_bf16") == ["fused", "fused"]


def test_bf16_config_is_tanabata_in_every_other_key():
    bf16, f32 = _conf("tanabata_bf16"), _conf("tanabata")

    def rest(conf):
        c = dict(conf["config"])
        del c["compute_dtype"]
        return c

    assert rest(bf16) == rest(f32)
    assert f32["config"]["compute_dtype"] == "float32"
    others = set(f32) - {"config", "precision", "assumed", "reduced"}
    assert set(bf16) == set(f32)
    assert {k: bf16[k] for k in others} == {k: f32[k] for k in others}
    assert bf16["reduced"] == f32["reduced"] + ["compute_dtype"]
    assert bf16["assumed"].items() >= f32["assumed"].items()
    assert set(bf16["assumed"]) - set(f32["assumed"]) == {"compute_dtype"}


def _shipped_keys(path):
    """The keys a shipped config file sets."""
    return {m.group(1) for m in re.finditer(r"^\s*(\w+)\s*=", path.read_text(),
                                            re.MULTILINE)}


def test_gray_config_is_the_shipped_gray_file():
    gray, f32 = _conf("tanabata_gray"), _conf("tanabata")
    shipped = ROOT / gray["source_config"]
    assert gray["source"].endswith(gray["source_config"])
    cfg = dataclasses.asdict(Config(**gray["config"]))
    want = dataclasses.asdict(load_config(str(shipped)))
    tanabata = dataclasses.asdict(Config(**f32["config"]))
    set_by_file = _shipped_keys(shipped) - {"datadir", "logdir", "project", "viewer"}
    assert "channels" in set_by_file and cfg["channels"] == 1
    for k in set_by_file & set(cfg):
        assert cfg[k] == want[k], k
    for k in set(cfg) - set_by_file:
        assert cfg[k] == tanabata[k], k
    assert gray["precision"] == "float32" and gray["reduced"] == []
    assert gray["published_widths"] == f32["published_widths"]
    assert gray["assumed"].items() >= f32["assumed"].items()
    assert set(gray["assumed"]) - set(f32["assumed"]) == {"image"}


def test_gray_config_takes_the_fused_route():
    assert _routes("tanabata_gray") == ["fused", "fused"]


# bench_small's shapes (benchmark/tests/bench_small.py): a 24 x 32 image and
# sensor, 16 event rays and 2 x 19 rgb rays, 8 + 8 points, 32-wide MLPs
SMALL = dict(rgb_height=24, rgb_width=32, event_height=24, event_width=32,
             rgb_fx=30.0, rgb_fy=30.0, rgb_cx=16, rgb_cy=12, event_fx=30.0,
             event_fy=30.0, event_cx=16, event_cy=12, sampling_event_rays=16,
             sampling_rgb_rays=38, N_samples=8, N_importance=8, netwidth=32,
             netwidth_fine=32)
GRAY_SEED = 3_000_000_019
# float32 against float64 at this size: the loss within 1e-4 (relative), each
# leaf's gradient within 5e-3 of max(its largest entry, the median leaf's).
# Over six seeds the sound step reads at most 8.1e-6 and 1.4e-3 (the worst
# leaf swings with the ray whose render sits at a jump of the method);
# `half_batch` reads at least 0.18 and 0.99
LOSS_TOL, GRAD_TOL = 1e-4, 5e-3


def _first_gray_step(seed):
    """(the port's loss and first gradient, the reference's), leaf by leaf,
    of step 1 of the small gray configuration."""
    conf = _conf("tanabata_gray")
    conf["config"].update(SMALL)
    conf["n_events"] = 3000
    c = conf["config"]
    cfg = Config(**c)
    scene = inputs.scene(conf, seed, "cpu")
    pix, ts, pol = scene["events"]
    cfg = dataclasses.replace(cfg, event_window_cap=events_mod.window_cap(
        ts.numpy(), cfg.accumulate_time_length))
    batch = step_mod.SceneBatch(
        events=events_mod.EventArrays(pix, ts, pol), image_flat=scene["image"],
        rgb_exp_ts=scene["rgb_exp_ts"], K_rgb=scene["K_rgb"], K_evt=scene["K_evt"])
    params = inputs.weights(c, seed, "cpu")
    p0 = {k: v.detach().clone().double().requires_grad_(True)
          for k, v in ref_train.leaves(params)}
    for _, t in ref_train.leaves(params):
        t.requires_grad_(True)
    state = step_mod.init_state(cfg, params=params)
    multi = step_mod.make_multi_step(cfg, scene["H"], scene["W"], 4)
    _, losses, read = train_cell.first_steps(multi, state, batch, seed, 4)
    grads = {k: m / (1 - train_cell.BETA1) for k, m in read["m1"].items()}
    sc = dict(scene, image=scene["image"].double(),
              rgb_exp_ts=scene["rgb_exp_ts"].double(),
              K_rgb=scene["K_rgb"].double(), K_evt=scene["K_evt"].double())
    tree = ref_train.rebuild(params, p0)
    ref_loss, ref_grads = ref_train.gradient(c, tree, sc, seed, 0,
                                             ref_train.trained_paths(c, tree))
    return (losses[0], grads), (ref_loss, ref_grads)


@pytest.mark.parametrize("fault", [None, "half_batch"])
def test_gray_step_gives_the_references_loss_and_gradients(fault):
    with planted(fault):
        (loss, grads), (ref_loss, ref_grads) = _first_gray_step(GRAY_SEED)
    assert all(ref_grads[f"/{m}/rgb/w"].shape[-1] == 1 for m in ("nerf", "nerf_fine"))
    scale = {k: float(g.abs().max()) for k, g in ref_grads.items()}
    med = sorted(scale.values())[len(scale) // 2]
    assert set(grads) == set(ref_grads)
    gaps = {k: float((grads[k].double() - g).abs().max()) / max(scale[k], med)
            for k, g in ref_grads.items()}
    loss_gap = abs(loss - ref_loss) / abs(ref_loss)
    within = loss_gap <= LOSS_TOL and max(gaps.values()) <= GRAD_TOL
    assert within is (fault is None), (loss_gap, max(gaps.items(), key=lambda x: x[1]))

