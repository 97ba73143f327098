"""The PyTorch port's train step as a whole vs the JAX package and the
golden fixtures of the original PyTorch BeNeRF, plus the train loop's
contract on the CPU.

- loss_fn (loss and every gradient) vs JAX make_loss_fn with the same
  injected draws, at the tests/test_golden_grad.py sizes;
- vs tests/golden/reference_golden_grad.npz under that file's CASES
  envelopes in float32, and its *_f64 cases in float64 at <= 1e-9 relative;
- three optimizer steps vs the JAX optax update;
- losses, CRF and config parsing vs JAX; the train loop on the CPU, its
  refusal to guess a device, and an import check that the port loads
  neither jax nor benerf_tpu.
"""

import dataclasses
import json
import math
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_golden_grad as gg  # CASES, build_cfg and param_gen's weights

from benerf_tpu.core import config as jconfig
from benerf_tpu.data import events as jevents
from benerf_tpu.models import crf as jcrf
from benerf_tpu.models import torch_compat
from benerf_tpu.train import loss as jloss
from benerf_tpu.train import optim as joptim
from benerf_tpu.train import step as jstep
from benerf_tpu_torch.core import config as tconfig
from benerf_tpu_torch.core import rng as trng
from benerf_tpu_torch.data import datasets as tdatasets
from benerf_tpu_torch.data import events as tevents
from benerf_tpu_torch.models import bridge
from benerf_tpu_torch.models import crf as tcrf
from benerf_tpu_torch.train import loop as tloop
from benerf_tpu_torch.train import loss as tloss
from benerf_tpu_torch.train import optim as toptim
from benerf_tpu_torch.train import step as tstep

REPO = pathlib.Path(__file__).resolve().parents[1]
H_RGB, W_RGB, H_EVT, W_EVT = gg.H_RGB, gg.W_RGB, gg.H_EVT, gg.W_EVT


def _port_cfg(jcfg, **overrides):
    return tconfig.Config(**{**dataclasses.asdict(jcfg), **overrides})


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _crf_np(sd):
    """torch nn.Sequential CRF state dict -> port layout, in numpy (keeps
    float64, which the JAX converter would not in an f32 process)."""
    idx = sorted({int(k.split(".")[0]) for k in sd})
    return {"layers": [{"w": sd[f"{i}.weight"].T, "b": sd[f"{i}.bias"]}
                       for i in idx]}


def _rms(x):
    return float(np.sqrt(np.mean(np.square(np.asarray(x, np.float64)))))


# ---- inputs from a seed -------------------------------------------------


def _scene_np(seed, C, n_events=3000):
    rng = np.random.default_rng(seed)
    ev = (rng.integers(0, W_EVT, n_events), rng.integers(0, H_EVT, n_events),
          rng.random(n_events).astype(np.float32),
          rng.choice([-1.0, 1.0], n_events).astype(np.float32))
    img = rng.random((H_RGB * W_RGB, C)).astype(np.float32)
    K = np.array([[20.0, 0.0, 8.0], [0.0, 20.0, 6.0], [0.0, 0.0, 1.0]], np.float32)
    return ev, img, K


def _draws_np(rng, cfg):
    R_e = cfg.sampling_event_rays
    R_r = cfg.sampling_rgb_rays // cfg.num_interpolated_pose
    n_e, n_r = 2 * R_e, cfg.num_interpolated_pose * R_r
    S, N = cfg.N_samples, cfg.N_importance
    low = np.float32(rng.random() * (1.0 - cfg.accumulate_time_length))
    d = {"low_t": low, "up_t": np.float32(low + cfg.accumulate_time_length),
         "ray_idx_evt": rng.choice(H_EVT * W_EVT, R_e, replace=False),
         "ray_idx_rgb": rng.choice(H_RGB * W_RGB, R_r, replace=False)}
    for fam, n in (("evt", n_e), ("rgb", n_r)):
        d[f"keys_{fam}"] = {
            "z_u": rng.random((n, S)).astype(np.float32),
            "pdf_u": rng.random((n, N)).astype(np.float32),
            "noise_c_vals": rng.normal(size=(n, S)).astype(np.float32),
            "noise_f_vals": rng.normal(size=(n, S + N)).astype(np.float32)}
    return d


def _to(draws, fn):
    return {k: ({kk: fn(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else fn(v)) for k, v in draws.items()}


def _jax_side(jcfg, seed, C, knots, transform):
    ev, img, K = _scene_np(seed, C)
    params = jstep.build_params(jcfg, jax.random.PRNGKey(seed),
                                init_knots=knots, init_transform=transform)
    batch = jstep.SceneBatch(
        events=jevents.prepare(*ev, width=W_EVT), image_flat=jnp.asarray(img),
        rgb_exp_ts=jnp.asarray([0.35, 0.65]), K_rgb=jnp.asarray(K),
        K_evt=jnp.asarray(K))
    return params, batch


def _port_side(jparams, seed, C, dtype=torch.float32):
    ev, img, K = _scene_np(seed, C)
    params = bridge.tree_map(lambda t: t.to(dtype).requires_grad_(True),
                             bridge.params_from_numpy(_np_tree(jparams), device="cpu"))
    batch = tstep.SceneBatch(
        events=tevents.prepare(*ev, width=W_EVT, device="cpu", dtype=dtype),
        image_flat=torch.as_tensor(img, dtype=dtype),
        rgb_exp_ts=torch.tensor([0.35, 0.65], dtype=dtype),
        K_rgb=torch.as_tensor(K, dtype=dtype), K_evt=torch.as_tensor(K, dtype=dtype))
    return params, batch


def _port_value_and_grad(loss_fn, params, batch, draws, step):
    total, metrics = loss_fn(params, batch, draws, step)
    leaves = bridge.tree_leaves(params)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(l) if g is None else g for l, g in zip(leaves, grads)]
    return total, metrics, bridge.tree_unflatten(params, grads)


# (golden case, config overrides, step, rtol of the loss terms, gradient
# bound as relative RMS per leaf). The last case runs the capped event
# window, the linear trajectory and BARF's coarse-to-fine weights. Each
# bound is ~2-5x the measured distance between the two fp32 results, and
# both sit about as far from a float64 run of the port: synthetic_gray's
# safe_log of dark pixels puts its coarse event loss 2e-4 and its trunk
# gradients 1.1e-3 apart; real_color's L2-normalized event loss and
# crf_gray's sigmoid CRFs amplify ReLU-boundary flips to 4.8e-3 and 2.1e-2
# (tests/test_golden_grad.py's CASES name the same amplifiers). The capped
# case runs on draws moved away from ReLU ties (_away_from_relu_ties), so
# no fp32 rounding on either side flips a ReLU and its bound stays tight.
LOSS_CASES = {
    "synthetic_gray": ("synthetic_gray", {}, 0, 1e-3, 5e-3),
    "real_color": ("real_color", {}, 0, 1e-4, 2.5e-2),
    "crf_gray": ("crf_gray", {}, 0, 1e-4, 5e-2),
    "capped_linear_barf": ("real_color", dict(
        event_window_cap=1024, traj="linear", use_barf_c2f=True,
        max_iter=1000), 300, 1e-4, 1e-5),
}
# Cases whose draws _away_from_relu_ties moves, and the margin. With the
# seed's own draws the capped case hinged on one tie: a coarse layer-5
# input of -1.59e-7 in a float64 run of the port, which the port's fp32
# run (its point one ulp off in y, from a 3e-8 rounding difference in the
# ray origin that NDC amplifies) put on the other side. Measured against
# float64 there, the port's fp32 gradients were 9.4e-4 (knots), 2.3e-3
# (coarse trunk) and 4.4e-3 (transform) away and JAX's within 1.5e-6; on
# another CPU the tie fell the other way and the two sides were 1.2e-6
# apart. Neither side is less accurate: pre-NDC ray origins are 1.60e-8
# (port) and 1.47e-8 (JAX) RMS from float64. The fp32 error of a ReLU
# input near 0 is up to ~4e-6 in this case, so the margin is 1e-5.
AWAY_FROM_TIES = ("capped_linear_barf",)
RELU_TIE = 1e-5


def _relu_margins(jcfg, jparams, draws, step):
    """Per ray (the event rays, then the rgb rays, as the renderer
    concatenates them), the smallest |ReLU input| of a float64 run of the
    port's loss: both MLPs' trunks and views layers and the density's
    relu(sigma + noise)."""
    n_evt, n_rgb = len(draws["keys_evt"]["z_u"]), len(draws["keys_rgb"]["z_u"])
    params, batch = _port_side(jparams, 7, jcfg.channels, dtype=torch.float64)
    d64 = _to(draws, lambda a: torch.as_tensor(np.array(a)))
    d64 = _to(d64, lambda a: a.double() if a.is_floating_point() else a)
    loss_fn, _ = tstep.make_loss_fn(_port_cfg(jcfg), H_RGB, W_RGB)
    margin = torch.full((n_evt + n_rgb,), math.inf, dtype=torch.float64)
    relu = torch.relu

    def record(x):
        # the MLPs see both families at once, (rays x samples, width);
        # volume.composite one family at a time, (rays, samples)
        rows = {n_evt: slice(0, n_evt), n_rgb: slice(n_evt, None)}.get(
            x.shape[0], slice(None))
        m = x.detach().abs().reshape(margin[rows].shape[0], -1).amin(dim=1)
        margin[rows] = torch.minimum(margin[rows], m)
        return relu(x)

    torch.relu = record
    try:
        with torch.no_grad():
            loss_fn(params, batch, d64, step)
    finally:
        torch.relu = relu
    return margin.numpy()


def _away_from_relu_ties(jcfg, jparams, draws, step, seed=0):
    """-> (draws with every draw of each ray whose float64 ReLU inputs come
    within RELU_TIE of 0 drawn again, the number of rays redrawn)."""
    rng = np.random.default_rng(seed)
    draws = _to(draws, np.array)
    n_evt, redrawn = len(draws["keys_evt"]["z_u"]), set()
    for _ in range(100):
        tied = np.flatnonzero(_relu_margins(jcfg, jparams, draws, step) < RELU_TIE)
        if tied.size == 0:
            return draws, len(redrawn)
        redrawn.update(tied.tolist())
        for r in tied:
            keys, row = ((draws["keys_evt"], r) if r < n_evt
                         else (draws["keys_rgb"], r - n_evt))
            for k, v in keys.items():
                v[row] = (rng.normal(size=v.shape[1:]) if k.startswith("noise")
                          else rng.random(v.shape[1:])).astype(v.dtype)
    raise AssertionError("could not draw rays away from ReLU ties")


def _loss_case(name):
    """(JAX config, step, JAX params, JAX batch, draws) of LOSS_CASES[name]."""
    case, overrides, step, _, _ = LOSS_CASES[name]
    jcfg = dataclasses.replace(gg.build_cfg(case), **overrides)
    rng = np.random.default_rng(len(name))
    knots = (rng.normal(size=(4, 6)) * 0.05).astype(np.float32)
    # the transform starts at exactly zero, where |x| has no derivative
    jparams, jbatch = _jax_side(jcfg, 7, jcfg.channels, knots,
                                np.zeros(6, np.float32))
    draws = _draws_np(rng, jcfg)
    if name in AWAY_FROM_TIES:
        draws = _away_from_relu_ties(jcfg, jparams, draws, step)[0]
    return jcfg, step, jparams, jbatch, draws


def test_capped_case_draws_away_from_relu_ties():
    """The seed's own draws of the capped case put a ReLU input within
    RELU_TIE of 0 (the tie LOSS_CASES names); the moved draws put none
    there, and change only the rays that had one."""
    name = "capped_linear_barf"
    case, overrides, step, _, _ = LOSS_CASES[name]
    jcfg = dataclasses.replace(gg.build_cfg(case), **overrides)
    rng = np.random.default_rng(len(name))
    knots = (rng.normal(size=(4, 6)) * 0.05).astype(np.float32)
    jparams, _ = _jax_side(jcfg, 7, jcfg.channels, knots, np.zeros(6, np.float32))
    draws = _draws_np(rng, jcfg)
    before = _relu_margins(jcfg, jparams, draws, step)
    assert before.min() < 1e-6
    moved, n_redrawn = _away_from_relu_ties(jcfg, jparams, draws, step)
    assert _relu_margins(jcfg, jparams, moved, step).min() >= RELU_TIE
    assert 0 < n_redrawn < len(before)
    keep = np.concatenate([d["z_u"] for d in (draws["keys_evt"], draws["keys_rgb"])])
    got = np.concatenate([d["z_u"] for d in (moved["keys_evt"], moved["keys_rgb"])])
    same = np.all(keep == got, axis=1)
    assert same.sum() == len(before) - n_redrawn
    assert np.all(before[same] >= RELU_TIE)


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_loss_fn_matches_jax(name):
    _, _, _, loss_rtol, grad_rel = LOSS_CASES[name]
    jcfg, step, jparams, jbatch, draws = _loss_case(name)
    C = jcfg.channels

    jloss_fn, _ = jstep.make_loss_fn(jcfg, H_RGB, W_RGB)
    (jtotal, jm), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        jparams, jbatch, _to(draws, jnp.asarray), jnp.asarray(step, jnp.int32))

    tparams, tbatch = _port_side(jparams, 7, C)
    tloss_fn, _ = tstep.make_loss_fn(_port_cfg(jcfg), H_RGB, W_RGB)
    ttotal, tm, tgrads = _port_value_and_grad(
        tloss_fn, tparams, tbatch, _to(draws, lambda a: torch.as_tensor(np.array(a))),
        step)

    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=loss_rtol,
                                   err_msg=k)
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=loss_rtol)
    want = bridge.tree_leaves(_np_tree(jgrads))
    got = [g.numpy() for g in bridge.tree_leaves(tgrads)]
    assert len(got) == len(want)
    for a, w in zip(got, want):
        assert a.shape == w.shape and np.all(np.isfinite(a))
        assert _rms(a - w) <= grad_rel * max(_rms(w), 1e-30), (w.shape, _rms(a - w), _rms(w))
    if name in AWAY_FROM_TIES:
        # the port's fp32 gradients against its float64 run, at the same
        # bound (measured: worst leaf 1.5e-6 from float64, JAX's 1.4e-6,
        # the two fp32 sides 2.1e-6 apart)
        p64, b64 = _port_side(jparams, 7, C, dtype=torch.float64)
        d64 = _to(draws, lambda a: torch.as_tensor(np.array(a)))
        d64 = _to(d64, lambda a: a.double() if a.is_floating_point() else a)
        g64 = _port_value_and_grad(tloss_fn, p64, b64, d64, step)[2]
        for a, w in zip(got, bridge.tree_leaves(g64)):
            w = w.detach().numpy()
            assert _rms(a - w) <= grad_rel * max(_rms(w), 1e-30), (w.shape, _rms(a - w))


def test_loss_fn_float64_matches_jax(tmp_path):
    """The capped event window, the linear trajectory and BARF's
    coarse-to-fine weights (LOSS_CASES["capped_linear_barf"]) in float64 on
    both sides, from the same float32 parameters, scene and draws: loss
    terms to 1e-11 and every gradient leaf to 1e-9 relative, as
    test_golden_grad_parity_float64 holds the recorded cases. JAX runs in a
    subprocess (tests/x64_torch_step_child.py): jax_enable_x64 is
    process-global."""
    name = "capped_linear_barf"
    jcfg, step, jparams, _, draws = _loss_case(name)
    C = jcfg.channels
    flat = {}
    for k, v in draws.items():
        for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)]):
            flat[f"d:{k}:{kk}" if kk else f"d:{k}"] = np.asarray(vv)
    np.savez(tmp_path / "in.npz", name=name, step=step, **flat,
             **{f"p{i}": np.asarray(a) for i, a in enumerate(jax.tree.leaves(jparams))})
    child = REPO / "tests" / "x64_torch_step_child.py"
    res = subprocess.run([sys.executable, str(child), str(tmp_path)],
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    out = np.load(tmp_path / "out.npz")
    jgrads = jax.tree.unflatten(jax.tree.structure(jparams), [
        out[f"g{i}"] for i in range(len(jax.tree.leaves(jparams)))])

    tparams, tbatch = _port_side(jparams, 7, C, dtype=torch.float64)
    d64 = _to(draws, lambda a: torch.as_tensor(np.array(a)))
    d64 = _to(d64, lambda a: a.double() if a.is_floating_point() else a)
    tloss_fn, _ = tstep.make_loss_fn(_port_cfg(jcfg), H_RGB, W_RGB)
    ttotal, tm, tgrads = _port_value_and_grad(tloss_fn, tparams, tbatch, d64, step)
    assert ttotal.dtype == torch.float64
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(out[f"m:{k}"]), rtol=1e-11,
                                   err_msg=k)
    np.testing.assert_allclose(float(ttotal), float(out["total"]), rtol=1e-11)
    want = bridge.tree_leaves(_np_tree(jgrads))
    got = [g.detach().numpy() for g in bridge.tree_leaves(tgrads)]
    assert len(got) == len(want)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype == np.float64
        np.testing.assert_allclose(a, w, rtol=1e-9,
                                   atol=1e-9 * max(np.abs(w).max(), 1e-300))


# ---- golden fixtures of the original PyTorch BeNeRF ------------------------


@pytest.fixture(scope="module")
def gold():
    return np.load(gg.GOLD_PATH)


def _golden_inputs(g, case, cfg, dtype):
    p = f"{case}::"
    f64 = dtype == torch.float64
    C = cfg.channels

    def nerf(tag):
        # param_gen draws float32 values: a cast to float64 is exact
        sd = gg.param_gen.nerf_state_dict(case, tag, C)
        return bridge.params_from_numpy(_np_tree(
            torch_compat.nerf_params_from_state_dict(sd)), device="cpu")

    params = tstep.build_params(cfg, device="cpu")
    params = {k: bridge.tree_map(lambda t: t.detach().to(dtype), v)
              for k, v in params.items()}
    params["nerf"], params["nerf_fine"] = nerf("nerf"), nerf("nerf_fine")
    params["knots"] = torch.as_tensor(g[p + "knots"])
    params["transform"] = torch.as_tensor(g[p + "transform"][0])
    if cfg.optimize_rgb_crf:
        for crf in ("rgb_crf", "event_crf"):
            params[crf] = bridge.params_from_numpy(_crf_np(
                {k[len(p + crf) + 2:]: g[k] for k in g.files
                 if k.startswith(f"{p}{crf}::")}), device="cpu")
    params = bridge.tree_map(lambda t: t.to(dtype).requires_grad_(True), params)

    events = tevents.EventArrays(
        pix_idx=torch.as_tensor(g[p + "evt_y"].astype(np.int64) * W_EVT
                                + g[p + "evt_x"]),
        ts=torch.as_tensor(g[p + "evt_ts"], dtype=dtype),
        pol=torch.as_tensor(g[p + "evt_pol"], dtype=dtype))
    if not f64:  # as events.prepare makes them: time-sorted
        events = tevents.prepare(g[p + "evt_x"], g[p + "evt_y"], g[p + "evt_ts"],
                                 g[p + "evt_pol"], width=W_EVT, device="cpu")
    batch = tstep.SceneBatch(
        events=events,
        image_flat=torch.as_tensor(g[p + "img"][0].reshape(-1, C), dtype=dtype),
        rgb_exp_ts=torch.as_tensor(g[p + "rgb_exp_ts"], dtype=dtype),
        K_rgb=torch.as_tensor(g[p + "K_rgb"], dtype=dtype),
        K_evt=torch.as_tensor(g[p + "K_evt"], dtype=dtype))
    t = lambda k: torch.as_tensor(g[p + k], dtype=dtype)
    draws = {"low_t": t("low_t"), "up_t": t("up_t"),
             "ray_idx_evt": torch.as_tensor(g[p + "ray_idx_evt"]),
             "ray_idx_rgb": torch.as_tensor(g[p + "ray_idx_rgb"])}
    for fam in ("evt", "rgb"):
        draws[f"keys_{fam}"] = {
            "z_u": t(f"z_u_{fam}"), "pdf_u": t(f"pdf_u_{fam}"),
            "noise_c_vals": t(f"noise_c_{fam}"), "noise_f_vals": t(f"noise_f_{fam}")}
    return params, batch, draws


def _golden_grads(g, case, tgrads):
    """(name, port gradient, recorded reference gradient) triples."""
    p = f"{case}::"
    out = [("knots", tgrads["knots"], g[p + "grad_knots"]),
           ("transform", tgrads["transform"], g[p + "grad_transform"][0])]
    for tag in ("nerf", "nerf_fine"):
        gp = tgrads[tag]
        out += [(f"{tag} l0 w", gp["pts"][0]["w"], g[f"{p}grad_{tag}_l0_w"].T),
                (f"{tag} l0 b", gp["pts"][0]["b"], g[f"{p}grad_{tag}_l0_b"]),
                (f"{tag} rgb w", gp["rgb"]["w"], g[f"{p}grad_{tag}_rgb_w"].T),
                (f"{tag} alpha b", gp["alpha"]["b"], g[f"{p}grad_{tag}_alpha_b"])]
    if any(k.startswith(f"{p}grad_rgb_crf::") for k in g.files):
        for crf in ("rgb_crf", "event_crf"):
            want = _crf_np({k[len(f"{p}grad_{crf}::"):]: g[k] for k in g.files
                            if k.startswith(f"{p}grad_{crf}::")})
            for i, layer in enumerate(want["layers"]):
                out += [(f"{crf} l{i} w", tgrads[crf]["layers"][i]["w"], layer["w"]),
                        (f"{crf} l{i} b", tgrads[crf]["layers"][i]["b"], layer["b"])]
    return [(n, a.detach().numpy(), d) for n, a, d in out]


def _run_golden(gold, case, cfg_case, dtype):
    cfg = _port_cfg(gg.build_cfg(cfg_case))
    params, batch, draws = _golden_inputs(gold, case, cfg, dtype)
    loss_fn, _ = tstep.make_loss_fn(cfg, H_RGB, W_RGB)
    total, metrics, grads = _port_value_and_grad(loss_fn, params, batch, draws, 0)
    eta, _ = tevents.eta_time_window(batch.events, H_EVT * W_EVT,
                                     draws["low_t"], draws["up_t"])
    np.testing.assert_array_equal(eta.numpy().reshape(H_EVT, W_EVT),
                                  gold[f"{case}::eta"])
    return total, metrics, grads


@pytest.mark.parametrize("case", list(gg.CASES))
def test_golden_grad_parity_float32(case, gold):
    """The port against the original PyTorch BeNeRF under the CASES
    envelopes of tests/test_golden_grad.py (same check as check_case)."""
    total, metrics, grads = _run_golden(gold, case, case, torch.float32)
    p = f"{case}::"
    for k in ("event_loss_fine", "event_loss_coarse", "rgb_loss_fine",
              "rgb_loss_coarse"):
        np.testing.assert_allclose(float(metrics[k]), gold[p + k], rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(total), gold[p + "loss"], rtol=1e-4)
    rel_bound, frac_bound = gg.CASES[case]["grad_rel"], gg.CASES[case]["grad_frac"]
    for name, a, d in _golden_grads(gold, case, grads):
        d = np.asarray(d, np.float64)
        assert _rms(a - d) / max(_rms(d), 1e-30) < rel_bound, name
        tol = 2e-3 * np.abs(d) + 8e-2 * max(_rms(d), 1e-30)
        assert float((np.abs(a - d) > tol).mean()) < frac_bound, name


@pytest.mark.parametrize("case", list(gg.CASES))
def test_golden_grad_parity_float64(case, gold):
    """The same function in float64 (torch runs it in-process): loss terms to
    1e-11 and every recorded gradient to 1e-9 relative, as
    tests/x64_parity_child.py holds the JAX package."""
    f64 = f"{case}_f64"
    total, metrics, grads = _run_golden(gold, f64, case, torch.float64)
    assert total.dtype == torch.float64
    p = f"{f64}::"

    def close(a, d, name, rtol=1e-9):
        a, d = np.asarray(a), np.asarray(d)
        np.testing.assert_allclose(a, d, rtol=rtol,
                                   atol=rtol * max(np.abs(d).max(), 1e-300),
                                   err_msg=f"{f64}: {name}")

    for k in ("event_loss_fine", "event_loss_coarse", "rgb_loss_fine",
              "rgb_loss_coarse"):
        close(float(metrics[k]), gold[p + k], k, rtol=1e-11)
    close(float(total), gold[p + "loss"], "loss", rtol=1e-11)
    for name, a, d in _golden_grads(gold, f64, grads):
        assert a.dtype == np.float64
        close(a, d, name)


# ---- optimizer ------------------------------------------------------------


def test_learning_rates_match_optax_schedules():
    jcfg = dataclasses.replace(
        gg.build_cfg("crf_gray"), optimize_nerf=True, optimize_pose=True,
        optimize_trans=True, pose_lrate_warmup=5, lrate_decay=1)
    params = tstep.build_params(_port_cfg(jcfg), device="cpu")
    opt = toptim.build_optimizer(_port_cfg(jcfg), params)
    assert [g["name"] for g in opt.param_groups] == list(toptim.GROUPS)
    expect = {
        "nerf": optax.exponential_decay(jcfg.lrate, 1000, jcfg.decay_rate),
        "knots": optax.join_schedules(
            [optax.linear_schedule(0.0, jcfg.pose_lrate, 5),
             optax.exponential_decay(jcfg.pose_lrate, 1000, jcfg.decay_rate_pose)],
            [5]),
        "event_crf": optax.exponential_decay(jcfg.event_crf_lrate, 1000,
                                             jcfg.decay_rate_event_crf),
    }
    for step in (0, 1, 4, 5, 6, 999, 2500):
        toptim.set_learning_rates(opt, step)
        lrs = {g["name"]: g["lr"] for g in opt.param_groups}
        for name, sched in expect.items():
            np.testing.assert_allclose(lrs[name], float(sched(step)), rtol=1e-6)


def test_three_optimizer_steps_match_jax(monkeypatch):
    """Three full steps from the same parameters and the same injected draws:
    the port's step function (loss, backward, grad norms, lr schedule, Adam
    groups) against value_and_grad + the optax update of the JAX step body.
    Pose warm-up of 2 steps; the transform and CRF groups are disabled and
    must stay untouched. Adam moves an element by ~lr whatever its
    gradient's size, so elements whose gradient is rounding noise move
    differently on the two sides: measured, the updates differ by 2.1% RMS
    and the knots' gradient norms by 0.8% after two steps (bounds 2.5x)."""
    jcfg = dataclasses.replace(
        gg.build_cfg("synthetic_gray"), optimize_nerf=True, optimize_pose=True,
        optimize_trans=False, pose_lrate_warmup=2, lrate_decay=1)
    C = jcfg.channels
    rng = np.random.default_rng(3)
    knots = (rng.normal(size=(4, 6)) * 0.05).astype(np.float32)
    transform = (rng.normal(size=6) * 0.01).astype(np.float32)
    jparams, jbatch = _jax_side(jcfg, 5, C, knots, transform)
    draws = [_draws_np(rng, jcfg) for _ in range(3)]

    tparams, tbatch = _port_side(jparams, 5, C)
    start = bridge.params_to_numpy(tparams)

    # JAX: the lines of benerf_tpu/train/step.py _make_step_body
    jloss_fn, _ = jstep.make_loss_fn(jcfg, H_RGB, W_RGB)
    tx = joptim.build_optimizer(jcfg)
    opt_state = tx.init(jparams)
    vg = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))
    jnorms = []
    for i, d in enumerate(draws):
        _, grads = vg(jparams, jbatch, _to(d, jnp.asarray), jnp.asarray(i, jnp.int32))
        jnorms.append((float(jnp.linalg.norm(grads["knots"])), float(
            optax.global_norm({"c": grads["nerf"], "f": grads["nerf_fine"]}))))
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    # the port: its own step function, with draw_fn replaced by the draws
    queue = iter(_to(d, lambda a: torch.as_tensor(np.array(a))) for d in draws)
    real = tstep.make_loss_fn
    monkeypatch.setattr(tstep, "make_loss_fn", lambda *a, **k: (
        real(*a, **k)[0], lambda gens: next(queue)))
    tcfg = _port_cfg(jcfg)
    state = tstep.init_state(tcfg, params=tparams)
    step_fn = tstep.make_train_step(tcfg, H_RGB, W_RGB)
    for i in range(3):
        state, metrics = step_fn(state, tbatch, 0)
        np.testing.assert_allclose(
            [float(metrics["grad_norm_knots"]), float(metrics["grad_norm_nerf"])],
            jnorms[i], rtol=2e-2)
    assert state.step == 3

    _assert_updates_close(start, bridge.params_to_numpy(state.params),
                          _np_tree(jparams), frozen=("transform", "rgb_crf",
                                                     "event_crf"), rel=5e-2)


def _assert_updates_close(start, got, want, frozen, rel):
    for name in start:
        for b, a, w in zip(bridge.tree_leaves(start[name]),
                           bridge.tree_leaves(got[name]),
                           bridge.tree_leaves(want[name])):
            if name in frozen:  # a disabled group is never stepped
                np.testing.assert_array_equal(a, b, err_msg=name)
                np.testing.assert_array_equal(w, b, err_msg=name)
                continue
            du, dw = a - b, w - b
            assert _rms(dw) > 0, name
            assert _rms(du - dw) <= rel * _rms(dw), (name, _rms(du - dw), _rms(dw))


def test_adam_groups_match_optax_on_equal_gradients():
    """The five Adam groups alone: the same gradients fed to the port's
    optimizer and to the JAX package's optax transform for three steps,
    every group enabled, pose warm-up of 2 steps, decay over 1000 steps."""
    jcfg = dataclasses.replace(
        gg.build_cfg("crf_gray"), optimize_nerf=True, optimize_pose=True,
        optimize_trans=True, pose_lrate_warmup=2, lrate_decay=1)
    jparams = _np_tree(jstep.build_params(jcfg, jax.random.PRNGKey(0)))
    tparams = bridge.tree_map(lambda t: t.requires_grad_(True),
                              bridge.params_from_numpy(jparams, device="cpu"))
    opt = toptim.build_optimizer(_port_cfg(jcfg), tparams)
    tx = joptim.build_optimizer(jcfg)
    jp = jax.tree.map(jnp.asarray, jparams)
    opt_state = tx.init(jp)
    rng = np.random.default_rng(0)
    for step in range(3):
        grads = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 10.0 ** rng.integers(
            -6, 1)).astype(np.float32), jparams)
        for t, g in zip(bridge.tree_leaves(tparams), bridge.tree_leaves(grads)):
            t.grad = torch.as_tensor(g)
        toptim.set_learning_rates(opt, step)
        opt.step()
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
    for name in jparams:
        for a, w, b in zip(bridge.tree_leaves(bridge.params_to_numpy(tparams[name])),
                           bridge.tree_leaves(_np_tree(jp[name])),
                           bridge.tree_leaves(jparams[name])):
            assert _rms(w - b) > 0, name
            # atol: the float32 rounding of parameters of size ~1
            np.testing.assert_allclose(a - b, w - b, rtol=1e-4, atol=1e-7,
                                       err_msg=name)


# ---- losses, CRF, config ------------------------------------------------------


@pytest.mark.parametrize("dataset,threshold,C", [
    ("BeNeRF_Blender", 0.1, 1), ("BeNeRF_Blender", 0.1, 3),
    ("E2NeRF_Real", -1.0, 3), ("E2NeRF_Synthetic", 0.2, 1)])
def test_loss_terms_match_jax(dataset, threshold, C):
    rng = np.random.default_rng(C)
    a, b = (rng.random((16, C)).astype(np.float32) for _ in range(2))
    a[0] = 0.0  # safe_log / lin_log at black
    eta = rng.integers(-3, 4, (16, 1)).astype(np.float32)
    kw = dict(dataset=dataset, channels=C, event_threshold=threshold,
              coeff_syn=0.1, coeff_real=2.0)
    want = float(jloss.event_loss_term(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(eta), **kw))
    got = float(tloss.event_loss_term(torch.as_tensor(a), torch.as_tensor(b),
                                      torch.as_tensor(eta), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    per_pose = rng.random((3 * 16, C)).astype(np.float32)
    np.testing.assert_allclose(
        float(tloss.blur_rgb_loss_term(torch.as_tensor(per_pose), torch.as_tensor(a), 1.5)),
        float(jloss.blur_rgb_loss_term(jnp.asarray(per_pose), jnp.asarray(a), 1.5)),
        rtol=1e-5)
    np.testing.assert_allclose(
        tloss.brightness_log(torch.as_tensor(a), dataset).numpy(),
        np.asarray(jloss.brightness_log(jnp.asarray(a), dataset)), rtol=1e-5, atol=1e-5)


def test_crf_matches_jax():
    jp = _np_tree(jcrf.init_params(jax.random.PRNGKey(0), hidden=1, width=16,
                                   bias_init=1.0))
    x = np.random.default_rng(0).random((20, 1)).astype(np.float32)
    np.testing.assert_allclose(
        tcrf.apply(bridge.params_from_numpy(jp, device="cpu"), torch.as_tensor(x)).numpy(),
        np.asarray(jcrf.apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(x))),
        rtol=1e-6, atol=1e-7)
    g = torch.Generator()
    g.manual_seed(0)
    tp = tcrf.init_params(g, hidden=1, width=16, bias_init=1.0)
    assert [tuple(l["w"].shape) for l in tp["layers"]] == [(1, 16), (16, 16), (16, 1)]
    assert all(torch.all(l["b"] == 1.0) for l in tp["layers"])


CONFIGS = sorted(str(p.relative_to(REPO)) for p in REPO.glob("configs/**/*.txt"))


@pytest.mark.parametrize("path", CONFIGS)
def test_config_copy_parses_like_jax(path):
    want = dataclasses.asdict(jconfig.load_config(str(REPO / path)))
    got = dataclasses.asdict(tconfig.load_config(str(REPO / path)))
    assert got == want


def test_config_from_cli_matches_jax():
    argv = ["--config", str(REPO / "configs/benerf_blender/tanabata.txt"),
            "--max_iter", "7", "--use_barf_c2f", "True", "--rgb_dist", "[0.1, 0.2]"]
    assert (dataclasses.asdict(tconfig.config_from_cli(argv))
            == dataclasses.asdict(jconfig.config_from_cli(argv)))


# ---- draws, train loop, device, imports ---------------------------------------


@pytest.mark.parametrize("fast", [False, True])
def test_draw_fn_from_step_generators(fast):
    cfg = tconfig.Config(**{**dataclasses.asdict(gg.build_cfg("real_color")),
                            "fast_ray_sampling": fast})
    _, draw_fn = tstep.make_loss_fn(cfg, H_RGB, W_RGB)
    a = draw_fn(trng.step_generators(0, 5, "cpu"))
    b = draw_fn(trng.step_generators(0, 5, "cpu"))
    c = draw_fn(trng.step_generators(0, 6, "cpu"))
    assert set(trng.CONSUMERS) >= {"window", "ray_evt", "ray_rgb"}
    for k in ("low_t", "ray_idx_evt", "ray_idx_rgb"):
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["ray_idx_evt"], c["ray_idx_evt"])
    idx = a["ray_idx_evt"]
    assert idx.shape == (cfg.sampling_event_rays,)
    assert len(set(idx.tolist())) == idx.numel() and 0 <= idx.min() and idx.max() < H_EVT * W_EVT
    assert 0.0 <= float(a["low_t"]) <= 1.0 - cfg.accumulate_time_length + 1e-6


def _tiny_train_cfg(tmp_path, **kw):
    return tconfig.Config(**{**dataclasses.asdict(gg.build_cfg("synthetic_gray")),
                             "optimize_nerf": True, "optimize_pose": True,
                             "max_iter": 2, "console_log_iter": 1,
                             "render_image_iter": 0, "render_video_iter": 0,
                             "save_model_iter": 0, "logdir": str(tmp_path),
                             "netwidth": 64, "netwidth_fine": 64, **kw})


def _tiny_scene(C=1):
    ev, img, _ = _scene_np(0, C)
    return tdatasets.SceneData(
        events=tevents.prepare(*ev, width=W_EVT, device="cpu"),
        image=img.reshape(1, H_RGB, W_RGB, C), imgtest=None,
        rgb_exp_ts=np.array([0.35, 0.65]))


def test_train_two_iterations_on_cpu(tmp_path, capsys):
    cfg = _tiny_train_cfg(tmp_path)
    knots0 = np.full((4, 6), 0.01, np.float32)
    state = tloop.train(cfg, _tiny_scene(), init_knots=knots0, device="cpu")
    assert state.step == 2
    assert not np.array_equal(state.params["knots"].detach().numpy(), knots0)
    with open(tmp_path / "0" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    steps = [r for r in recs if "train_loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    for r in steps:
        assert math.isfinite(r["train_loss"])
        assert {"train_grad_norm_knots", "train_grad_norm_nerf",
                "train_eta_window_overflow", "train_event_loss"} <= set(r)
    assert sum("rays_per_sec" in r for r in recs) == 2
    assert "[TRAIN] iter 2" in capsys.readouterr().out


def test_train_without_device_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloop.train(_tiny_train_cfg(tmp_path), _tiny_scene())


def test_train_refuses_a_mesh_without_a_launcher(tmp_path, monkeypatch):
    """mesh_devices = 2 in a process no launcher started: a ValueError that
    names the torch.distributed.run line, before anything is written."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="torch.distributed.run "
                       "--nproc_per_node 2 "):
        tloop.train(_tiny_train_cfg(tmp_path, mesh_devices=2), _tiny_scene(),
                    device="cpu")
    assert not any(tmp_path.iterdir())


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = sorted("benerf_tpu_torch." + ".".join(p.relative_to(
        REPO / "benerf_tpu_torch").with_suffix("").parts)
        for p in (REPO / "benerf_tpu_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'benerf_tpu' or m.startswith('benerf_tpu.')]\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(mods) >= 20
    assert {"benerf_tpu_torch.parallel.mesh", "benerf_tpu_torch.data._native",
            "benerf_tpu_torch.train.step"} <= set(mods)
