"""The port's multi-step dispatch (train/step.py make_multi_step, the
counterpart of the JAX package's lax.scan of steps) and what it needs, on
the CPU, where a dispatch runs its steps eagerly (the card captures one step
in a CUDA graph: tests/test_torch_cuda.py):

- n_inner steps of make_multi_step equal as many make_train_step calls from
  the same state, bit for bit: every metric, every parameter and every Adam
  moment and step, across two dispatches (BARF reads the step counter;
  warm-up moves the lrs; per-term knot gradients on);
- the lrs are 0-d float32 tensors, written in place, equal to optax's
  schedules of the JAX package for every group over warm-up and decay;
- log_knot_grad_terms: the knots' gradient norms of the event and rgb
  losses equal jax.grad of the JAX loss_fn's terms on the same draws, and
  leave the step itself unchanged;
- train() with g > 1 writes the records of single steps, at the same
  iterations; profile_iter writes a trace; debug_nans runs single steps;
- the renderer's capturable cumprod has torch.cumprod's values and
  gradient, bit for bit.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_golden_grad as gg
import test_torch_step as ts

from benerf_tpu.train import step as jstep
from benerf_tpu_torch.core import config as tconfig
from benerf_tpu_torch.models import bridge
from benerf_tpu_torch.train import loop as tloop
from benerf_tpu_torch.train import optim as toptim
from benerf_tpu_torch.train import step as tstep


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


# (case, overrides): BARF from step 0 over 8 iterations, so its band weights
# change every step; a pose warm-up of 2 steps, so the lrs do; every group
# and the per-term knot gradients on
MULTI_CASES = {
    "plain": ("synthetic_gray", {}),
    "barf_reads_the_step": ("real_color", dict(
        use_barf_c2f=True, barf_c2f_start=0.0, barf_c2f_end=0.5, max_iter=8,
        optimize_trans=True)),
    "warmup_all_groups_knot_terms": ("crf_gray", dict(
        pose_lrate_warmup=2, optimize_trans=True, optimize_rgb_crf=True,
        optimize_event_crf=True, log_knot_grad_terms=True)),
}


@pytest.mark.parametrize("name", list(MULTI_CASES))
def test_multi_step_equals_single_steps(name):
    case, kw = MULTI_CASES[name]
    cfg = _cfg(case, **kw)
    batch = tloop.make_batch(ts._tiny_scene(cfg.channels), cfg,
                             *tloop.intrinsics(cfg)[:2], "cpu")
    step_fn = tstep.make_train_step(cfg, ts.H_RGB, ts.W_RGB)
    multi_fn = tstep.make_multi_step(cfg, ts.H_RGB, ts.W_RGB, 3)

    single = tstep.init_state(cfg, cfg.seed, device="cpu")
    multi = tstep.init_state(cfg, cfg.seed, device="cpu")
    for _ in range(2):
        rows = []
        for _ in range(3):
            single, m = step_fn(single, batch, cfg.seed)
            rows.append(m)
        multi, stacked = multi_fn(multi, batch, cfg.seed)
        assert multi.step == single.step
        assert list(stacked) == list(rows[0])
        for k, v in stacked.items():
            want = torch.stack([r[k] for r in rows])
            assert v.dtype == want.dtype and torch.equal(v, want), k
    assert multi.step == 6
    if cfg.log_knot_grad_terms:
        assert {"knot_grad_event", "knot_grad_rgb"} <= set(stacked)
    got, want = _state_arrays(multi), _state_arrays(single)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_multi_step_refuses_an_empty_dispatch():
    with pytest.raises(ValueError, match="n_inner must be >= 1"):
        tstep.make_multi_step(_cfg("synthetic_gray"), ts.H_RGB, ts.W_RGB, 0)


def test_tensor_learning_rates_match_optax_schedules():
    """Every group's lr against optax's schedule of the JAX package
    (benerf_tpu/train/optim.py _chain): a linear warm-up of 5 updates on
    the knots and the transform, then each group's exponential decay over
    1000 updates. Each lr is a 0-d float32 tensor, written in place."""
    jcfg = dataclasses.replace(
        gg.build_cfg("crf_gray"), optimize_nerf=True, optimize_pose=True,
        optimize_trans=True, optimize_rgb_crf=True, optimize_event_crf=True,
        pose_lrate_warmup=5, lrate_decay=1)
    params = tstep.build_params(ts._port_cfg(jcfg), device="cpu")
    opt = toptim.build_optimizer(ts._port_cfg(jcfg), params)

    def decay(lr, rate):
        return optax.exponential_decay(lr, 1000, rate)

    def warm(lr, rate):
        return optax.join_schedules(
            [optax.linear_schedule(0.0, lr, 5), decay(lr, rate)], [5])

    expect = {
        "nerf": decay(jcfg.lrate, jcfg.decay_rate),
        "knots": warm(jcfg.pose_lrate, jcfg.decay_rate_pose),
        "transform": warm(jcfg.transform_lrate, jcfg.decay_rate_transform),
        "rgb_crf": decay(jcfg.rgb_crf_lrate, jcfg.decay_rate_rgb_crf),
        "event_crf": decay(jcfg.event_crf_lrate, jcfg.decay_rate_event_crf),
    }
    assert [g["name"] for g in opt.param_groups] == list(expect)
    tensors = [g["lr"] for g in opt.param_groups]
    for t in tensors:
        assert t.shape == () and t.dtype == torch.float32
    for step in (0, 1, 2, 4, 5, 6, 500, 999, 1000, 2500):
        toptim.set_learning_rates(opt, step)
        for g, t in zip(opt.param_groups, tensors):
            assert g["lr"] is t  # in place: a captured step reads it
            np.testing.assert_allclose(float(t), float(expect[g["name"]](step)),
                                       rtol=1e-6, atol=0, err_msg=g["name"])


def test_knot_grad_terms_match_jax(monkeypatch):
    """log_knot_grad_terms on the capped case's injected draws (moved away
    from ReLU ties, where both float32 sides agree to ~1e-6): each term's
    knot gradient norm against jax.grad of the JAX loss_fn's term
    (benerf_tpu/train/step.py _make_step_body), relative 1e-5; the step's
    other metrics and its update are those of a step without them."""
    jcfg, step, jparams, jbatch, draws = ts._loss_case("capped_linear_barf")
    assert jcfg.event_loss and jcfg.rgb_loss
    jloss_fn, _ = jstep.make_loss_fn(jcfg, ts.H_RGB, ts.W_RGB)
    jdraws = ts._to(draws, jnp.asarray)

    def term(knots, name):
        return jloss_fn({**jparams, "knots": knots}, jbatch, jdraws,
                        jnp.asarray(step, jnp.int32))[1][name]

    want = {key: float(jnp.linalg.norm(jax.grad(term)(jparams["knots"], name)))
            for key, name in (("knot_grad_event", "event_loss"),
                              ("knot_grad_rgb", "rgb_loss"))}

    real = tstep.make_loss_fn
    tdraws = ts._to(draws, lambda a: torch.as_tensor(np.array(a)))
    monkeypatch.setattr(tstep, "make_loss_fn", lambda *a, **k: (
        real(*a, **k)[0], lambda gens: tdraws))
    runs = {}
    for on in (True, False):
        tcfg = ts._port_cfg(jcfg, log_knot_grad_terms=on, optimize_nerf=True,
                            optimize_pose=True)
        tparams, tbatch = ts._port_side(jparams, 7, jcfg.channels)
        state = tstep.init_state(tcfg, params=tparams)._replace(step=step)
        state, m = tstep.make_train_step(tcfg, ts.H_RGB, ts.W_RGB)(
            state, tbatch, 0)
        runs[on] = (m, _state_arrays(state))
    m_on, m_off = runs[True][0], runs[False][0]
    for key, w in want.items():
        np.testing.assert_allclose(float(m_on[key]), w, rtol=1e-5, err_msg=key)
    assert set(m_on) - set(m_off) == set(want)
    for k in m_off:
        assert torch.equal(m_on[k], m_off[k]), k
    for k, v in runs[False][1].items():
        assert torch.equal(runs[True][1][k], v), k


def _train_records(tmp_path, **kw):
    cfg = ts._tiny_train_cfg(tmp_path, max_iter=5, **kw)
    state = tloop.train(cfg, ts._tiny_scene(), device="cpu")
    with open(tmp_path / "0" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    return state, recs


def test_train_in_dispatches_records_what_single_steps_do(tmp_path):
    """console_log_iter 2 gives g = 2: two dispatches of 2, then the tail
    step alone; every iteration's record equals that of a run of single
    steps (g = 1), and the console records fall at every second step."""
    single, recs1 = _train_records(tmp_path / "g1", console_log_iter=1)
    multi, recs2 = _train_records(tmp_path / "g2", console_log_iter=2)
    train1 = [r for r in recs1 if "train_loss" in r]
    train2 = [r for r in recs2 if "train_loss" in r]
    assert [r["step"] for r in train2] == [1, 2, 3, 4, 5]
    assert train2 == train1
    assert [r["step"] for r in recs2 if "rays_per_sec" in r] == [2, 4, 5]
    got, want = _state_arrays(multi), _state_arrays(single)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_profile_iter_writes_a_trace(tmp_path, capsys):
    """profile_iter 3 falls in the second dispatch of 2 (iterations 3-4):
    one Chrome trace of it under profile_dir, its path printed."""
    trace_dir = tmp_path / "trace"
    tloop.train(ts._tiny_train_cfg(tmp_path, max_iter=4, console_log_iter=2,
                                   profile_iter=3, profile_dir=str(trace_dir)),
                ts._tiny_scene(), device="cpu")
    files = sorted(trace_dir.iterdir())
    assert [f.name for f in files] == ["trace_iter000003.json"]
    trace = json.loads(files[0].read_text())
    assert trace["traceEvents"]
    assert f"wrote profiler trace to {files[0]}" in capsys.readouterr().out


def test_debug_nans_takes_single_uncaptured_steps(tmp_path, capsys,
                                                  monkeypatch):
    made = []
    real = tstep.make_multi_step
    monkeypatch.setattr(tstep, "make_multi_step",
                        lambda *a, **k: made.append(a) or real(*a, **k))
    _, recs = _train_records(tmp_path, console_log_iter=2, debug_nans=True)
    assert "every step runs alone and uncaptured" in capsys.readouterr().out
    assert not made
    assert [r["step"] for r in recs if "train_loss" in r] == [1, 2, 3, 4, 5]


def test_metrics_to_host_reads_scalars_and_stacks():
    host = tstep.metrics_to_host({
        "loss": torch.tensor([0.5, 0.25], dtype=torch.float32),
        "eta_window_overflow": torch.tensor([0, 3])})
    assert list(host) == ["loss", "eta_window_overflow"]
    np.testing.assert_array_equal(host["loss"], [0.5, 0.25])
    np.testing.assert_array_equal(host["eta_window_overflow"], [0, 3])
    one = tstep.metrics_to_host({"loss": torch.tensor(1.5)})
    assert one["loss"].shape == (1,) and one["loss"][0] == 1.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_positive_cumprod_has_torch_cumprods_values_and_gradient(dtype):
    """volume._PositiveCumprod (a capturable cumprod: torch's backward reads
    the host) against torch.cumprod on 1 - alpha + 1e-10, alpha in [0, 1]
    with ones among it, bit for bit in the values and the gradient."""
    from benerf_tpu_torch.render import volume

    g = torch.Generator().manual_seed(0)
    alpha = torch.rand((50, 64), generator=g, dtype=dtype)
    alpha[0, 3] = 1.0
    alpha[1] = 1.0
    cot = torch.randn((50, 64), generator=g, dtype=dtype)
    a1, a2 = (alpha.clone().requires_grad_(True) for _ in range(2))
    y1 = volume._PositiveCumprod.apply(1.0 - a1 + 1e-10)
    y2 = torch.cumprod(1.0 - a2 + 1e-10, dim=-1)
    g1, = torch.autograd.grad(y1, a1, cot)
    g2, = torch.autograd.grad(y2, a2, cot)
    assert torch.equal(y1, y2) and torch.equal(g1, g2)
