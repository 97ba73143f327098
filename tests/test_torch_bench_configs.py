"""The benchmark's bf16 configuration, `benchmark/configs/tanabata_bf16.json`:
tanabata in the port's bf16 mode, on the fused route (K1/K2), and in
every other key the shipped tanabata configuration the float32 cells run,
so that its cell measures neither the plain route nor a drifted copy."""

from __future__ import annotations

import json
from pathlib import Path

import torch

from benerf_tpu_torch.core.config import Config
from benerf_tpu_torch.ops import mlp
from benerf_tpu_torch.render import renderer
from benerf_tpu_torch.train import step as step_mod

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "benchmark" / "configs"


def _conf(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_bf16_config_is_the_bf16_mode():
    conf = _conf("tanabata_bf16")
    cfg = Config(**conf["config"])
    assert cfg.compute_dtype == "bfloat16"
    assert conf["precision"] == "bfloat16"


def test_bf16_config_takes_the_fused_route():
    cfg = Config(**_conf("tanabata_bf16")["config"])
    s = renderer.RenderSettings.from_config(cfg)
    params = step_mod.build_params(cfg, device="cpu")
    viewdirs = torch.ones(1, 3) if s.use_viewdirs else None
    for family in ("nerf", "nerf_fine"):
        assert mlp.route(params[family], viewdirs, s.multires,
                         s.multires_views, s.use_barf_c2f,
                         s.use_pallas) == "fused"


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
