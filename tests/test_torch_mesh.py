"""The port's ray-data parallelism (parallel/mesh.py and the mesh path of the
loss, the step and the loop) on the CPU, in two gloo processes started as
torch.distributed.run starts them (tests/torch_mesh_child.py), against:

- JAX's make_loss_fn under its 2-device mesh on tier-1's virtual CPU
  devices, from the same parameters, scene and injected global draws: the
  loss, every metric and every gradient, summed over the ranks, within
  tests/test_torch_step.py's LOSS_CASES envelopes;
- the port's own one-process step in float64, over three Adam steps from
  the same state and seed: every metric and parameter to 1e-9, the two
  ranks' parameters bit for bit (synthetic and real-data event losses,
  BARF, both ray samplers, an uneven rgb split, the multi-step dispatch);
- a one-process train(): the run directory rank 0 writes, its log and its
  checkpoint within 1e-5, and a resume.

Also make_mesh's semantics and refusals, the JAX package's divisibility
error, and the refusal to capture a gloo mesh on the card.
"""

import dataclasses
import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_golden_grad as gg
import test_torch_step as tts
import torch_mesh_child as child

from benerf_tpu.parallel import mesh as jmesh
from benerf_tpu.train import step as jstep
from benerf_tpu_torch.core import config as tconfig
from benerf_tpu_torch.models import bridge
from benerf_tpu_torch.parallel import mesh as mesh_mod
from benerf_tpu_torch.train import loop as tloop
from benerf_tpu_torch.train import step as tstep

REPO = Path(__file__).resolve().parents[1]
CHILD = Path(__file__).resolve().parent / "torch_mesh_child.py"
H, W = tts.H_RGB, tts.W_RGB


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(mode, payload, tmp, world=2, timeout=300):
    """Run torch_mesh_child.py MODE in `world` processes with the launch
    environment of torch.distributed.run -> each rank's results."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    inp = tmp / f"{mode}_in.pkl"
    with open(inp, "wb") as f:
        pickle.dump(payload, f)
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port()), "WORLD_SIZE": str(world),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(CHILD), mode, str(inp), str(tmp / f"{mode}_{r}.pkl")],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    results = []
    for r in range(world):
        with open(tmp / f"{mode}_{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


# ---- (i) the 2-rank loss against JAX's 2-device mesh ----------------------


@pytest.fixture(scope="module")
def loss_runs(tmp_path_factory):
    """Each LOSS_CASES case: the JAX mesh's (loss, metrics, grads) and the
    port's two ranks' summed ones, from one launch."""
    jm = jmesh.make_mesh(2)
    if jm is None:
        pytest.skip("needs 2 virtual JAX devices")
    cases, want = [], {}
    for name in tts.LOSS_CASES:
        jcfg, step, jparams, jbatch, draws = tts._loss_case(name)
        loss_fn, _ = jstep.make_loss_fn(jcfg, H, W, mesh=jm)
        with jm:
            (total, m), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                jparams, jbatch, tts._to(draws, jnp.asarray),
                jnp.asarray(step, jnp.int32))
        want[name] = (float(total), {k: float(v) for k, v in m.items()},
                      bridge.tree_leaves(tts._np_tree(grads)))
        cases.append(dict(cfg=dataclasses.asdict(tts._port_cfg(jcfg)),
                          params=tts._np_tree(jparams),
                          scene=tts._scene_np(7, jcfg.channels), draws=draws,
                          step=step, H=H, W=W))
    ranks = _launch("loss", cases, tmp_path_factory.mktemp("mesh_loss"))
    return {name: (want[name], [r[i] for r in ranks])
            for i, name in enumerate(tts.LOSS_CASES)}


@pytest.mark.parametrize("name", list(tts.LOSS_CASES))
def test_two_rank_loss_matches_the_jax_mesh(loss_runs, name):
    _, _, _, loss_rtol, grad_rel = tts.LOSS_CASES[name]
    (jtotal, jm, jgrads), ranks = loss_runs[name]
    # both ranks hold the summed values, bit for bit
    for k, v in ranks[0]["metrics"].items():
        assert v == ranks[1]["metrics"][k], k
    for a, b in zip(ranks[0]["grads"], ranks[1]["grads"]):
        assert np.array_equal(a, b)
    got = ranks[0]
    assert set(got["metrics"]) | {"eta_window_overflow"} == set(jm) | {"total"}
    for k, v in got["metrics"].items():
        np.testing.assert_allclose(v, jtotal if k == "total" else jm[k],
                                   rtol=loss_rtol, err_msg=k)
    assert got["overflow"] == jm["eta_window_overflow"]
    assert len(got["grads"]) == len(jgrads)
    for a, w in zip(got["grads"], jgrads):
        assert a.shape == w.shape and np.all(np.isfinite(a))
        assert tts._rms(a - w) <= grad_rel * max(tts._rms(w), 1e-30), (
            w.shape, tts._rms(a - w), tts._rms(w))


# ---- (ii) the 2-rank step against the 1-rank step, float64 ----------------


def _step_case(base, seed, n_steps=3, multi=False, **overrides):
    cfg = tts._port_cfg(gg.build_cfg(base), optimize_nerf=True,
                        optimize_pose=True, optimize_trans=True,
                        netwidth=64, netwidth_fine=64, **overrides)
    params = tstep.build_params(cfg, seed, device="cpu")
    return dict(cfg=dataclasses.asdict(cfg),
                params=bridge.params_to_numpy(params),
                scene=tts._scene_np(seed, cfg.channels), seed=seed, H=H, W=W,
                n_steps=n_steps, multi=multi)


# name -> (golden case, seed, overrides): 16 event pixels split 8 / 8; the
# rgb pixels 2 / 1 (3 poses x 3 pixels), or 6 / 5 (5 poses x 11)
STEP_CASES = {
    "synthetic_randperm": ("synthetic_gray", 1, {}),
    "real_topk_knot_terms": ("real_color", 2, dict(
        fast_ray_sampling=True, log_knot_grad_terms=True)),
    "barf_topk": ("synthetic_gray", 3, dict(
        fast_ray_sampling=True, use_barf_c2f=True, barf_c2f_start=0.0,
        barf_c2f_end=0.8, max_iter=10)),
    "uneven_rgb_crf": ("crf_gray", 4, dict(
        num_interpolated_pose=5, sampling_rgb_rays=55)),
    "multi_step_capped": ("real_color", 5, dict(
        multi=True, event_window_cap=1024)),
}


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    cases = []
    for base, seed, kw in STEP_CASES.values():
        kw = dict(kw)
        cases.append(_step_case(base, seed, multi=kw.pop("multi", False), **kw))
    ranks = _launch("step", cases, tmp_path_factory.mktemp("mesh_step"))
    return {name: (case, [r[i] for r in ranks])
            for i, (name, case) in enumerate(zip(STEP_CASES, cases))}


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_two_rank_steps_match_one_rank_in_float64(step_runs, name):
    case, ranks = step_runs[name]
    want = child.run_steps(case, None)
    a, b = ranks
    for x, y in zip(bridge.tree_leaves(a["params"]), bridge.tree_leaves(b["params"])):
        assert np.array_equal(x, y)  # the ranks stay equal, bit for bit
    assert len(a["metrics"]) == case["n_steps"]
    for got, ref in zip(a["metrics"], want["metrics"]):
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-9, atol=1e-15,
                                       err_msg=k)
    start = bridge.tree_leaves(case["params"])
    for got, ref, p0 in zip(bridge.tree_leaves(a["params"]),
                            bridge.tree_leaves(want["params"]), start):
        np.testing.assert_allclose(got, ref, rtol=1e-9,
                                   atol=1e-9 * max(1.0, np.abs(ref).max()))
    moved = [not np.array_equal(np.asarray(p0, np.float64), ref)
             for p0, ref in zip(start, bridge.tree_leaves(want["params"]))]
    assert any(moved)


# ---- (iii) make_mesh, the divisibility check, the collectives -------------


def test_make_mesh_without_a_launcher(monkeypatch):
    for k in mesh_mod.LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    assert mesh_mod.initialize_distributed("cpu") is None
    for n in (-1, 0, 1):
        assert mesh_mod.make_mesh(n) is None
    for n in (2, 4):
        with pytest.raises(ValueError, match=(
                f"torch.distributed.run --nproc_per_node {n} ")):
            mesh_mod.make_mesh(n)
    x = torch.arange(5)
    assert mesh_mod.shard_rows(x, None) is x
    mesh_mod.all_reduce_flat([x], None)
    assert mesh_mod.all_reduce_sum(x, None) is x


def test_mesh_checks_under_a_two_process_launch(tmp_path):
    r0, r1 = _launch("mesh", None, tmp_path)
    for r, out in enumerate((r0, r1)):
        assert (out["size"], out["rank"], out["backend"]) == (2, r, "gloo")
        assert out["make_mesh_2"] == (2, r)
        for n in (1, 3):
            assert "the launch started 2 processes" in out[f"make_mesh_{n}"]
            assert f"--nproc_per_node {n} " in out[f"make_mesh_{n}"]
        # 11 rows: 6 / 5
        want = np.arange(33).reshape(11, 3)[:6] if r == 0 else \
            np.arange(33).reshape(11, 3)[6:]
        np.testing.assert_array_equal(out["shard_rows"], want)
        np.testing.assert_array_equal(out["replicated"][0], np.zeros(3))
        np.testing.assert_array_equal(out["replicated"][1], np.arange(4.0))
        # y = x0^2 + x1^2 over the ranks: (1 + 4, 4 + 4); the loss sums
        # y . c over the ranks, so dL/dx_r = 2 x_r (c_0 + c_1)
        y, gx = out["all_reduce_sum"]
        np.testing.assert_array_equal(y, [5.0, 8.0])
        np.testing.assert_array_equal(gx, 2 * np.array([1.0 + r, 2.0])
                                      * np.array([6.0, 11.0]))
        assert out["collectives"] == {"all_reduce": 2, "broadcast": 1}


def test_divisibility_error_matches_the_jax_package():
    jcfg = gg.build_cfg("synthetic_gray")  # 16 event rays: 32 rows
    jm = jmesh.make_mesh(3)
    with pytest.raises(ValueError) as want:
        jstep.make_loss_fn(jcfg, H, W, mesh=jm)
    fake = mesh_mod.RayMesh(None, 0, 3, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError) as got:
        tstep.make_loss_fn(tts._port_cfg(jcfg), H, W, mesh=fake)
    assert str(got.value) == str(want.value)
    assert "choose a multiple of 3" in str(got.value)


def test_a_gloo_mesh_on_the_card_is_not_captured():
    cfg = tts._port_cfg(gg.build_cfg("synthetic_gray"))
    gloo_card = mesh_mod.RayMesh(None, 0, 2, torch.device("cuda", 0), "gloo")
    with pytest.raises(ValueError, match="cannot be captured"):
        tstep.make_multi_step(cfg, H, W, 4, mesh=gloo_card)
    gloo_cpu = dataclasses.replace(gloo_card, device=torch.device("cpu"))
    assert tstep.make_multi_step(cfg, H, W, 4, mesh=gloo_cpu) is not None


# ---- (iv) train() on two ranks ---------------------------------------------


def _train_payload(logdir, **kw):
    cfg = tts._tiny_train_cfg(logdir, mesh_devices=2, max_iter=4,
                              console_log_iter=2, save_model_iter=2, **kw)
    return dict(cfg=dataclasses.asdict(cfg), scene=tts._scene_np(0, 1), H=H,
                W=W, init_knots=np.full((4, 6), 0.01, np.float32))


def _train_alone(payload, **kw):
    cfg = tconfig.Config(**{**payload["cfg"], "mesh_devices": 1, **kw})
    scene = tts._tiny_scene()
    return tloop.train(cfg, scene, init_knots=payload["init_knots"],
                       device="cpu")


def _records(logdir):
    with open(Path(logdir) / "0" / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _assert_runs_match(mesh_dir, alone_dir):
    got, want = _records(mesh_dir), _records(alone_dir)
    train_keys = lambda r: {k: v for k, v in r.items() if k.startswith("train_")}
    got = [(r["step"], train_keys(r)) for r in got if "train_loss" in r]
    want = [(r["step"], train_keys(r)) for r in want if "train_loss" in r]
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-12,
                                       err_msg=k)
    saved = sorted(p.name for p in (Path(alone_dir) / "0").glob("*.ckpt.npz"))
    assert saved == sorted(
        p.name for p in (Path(mesh_dir) / "0").glob("*.ckpt.npz"))
    for name in saved:
        a = np.load(Path(mesh_dir) / "0" / name)
        b = np.load(Path(alone_dir) / "0" / name)
        assert set(a.files) == set(b.files)
        for k in b.files:
            if np.issubdtype(b[k].dtype, np.floating):
                # 1e-5 x the array's scale, as tests/test_sharding.py holds
                # the JAX mesh's parameters at 1e-5
                scale = max(1.0, float(np.abs(b[k]).max(initial=0.0)))
                np.testing.assert_allclose(a[k], b[k], rtol=0,
                                           atol=1e-5 * scale, err_msg=k)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_on_two_ranks_matches_one_process(tmp_path):
    mesh_dir, alone_dir = tmp_path / "mesh", tmp_path / "alone"
    payload = _train_payload(mesh_dir)
    r0, r1 = _launch("train", payload, tmp_path / "io")
    assert r0["step"] == r1["step"] == 4
    for a, b in zip(bridge.tree_leaves(r0["params"]),
                    bridge.tree_leaves(r1["params"])):
        assert np.array_equal(a, b)
    _train_alone({**payload, "cfg": {**payload["cfg"], "logdir": str(alone_dir)}})
    # one run directory, each file written once (by rank 0)
    assert sorted(p.name for p in mesh_dir.iterdir()) == ["0"]
    assert sorted(p.name for p in (mesh_dir / "0").iterdir()) == sorted(
        p.name for p in (alone_dir / "0").iterdir())
    assert len([r for r in _records(mesh_dir) if "train_loss" in r]) == 4
    _assert_runs_match(mesh_dir, alone_dir)


def test_train_on_two_ranks_resumes_as_it_runs_on(tmp_path):
    """Resumed from its checkpoint at 4 for 2 more iterations, the 2-rank run
    equals one that ran 6 uninterrupted, bit for bit. (Against one process,
    the fp32 rounding of the two sum orders grows through Adam past 1e-5 by
    then, so the resume is held against the 2-rank run.)"""
    mesh_dir, through_dir = tmp_path / "mesh", tmp_path / "through"
    payload = _train_payload(mesh_dir)
    _launch("train", payload, tmp_path / "io")
    more = dict(load_checkpoint=True, max_iter=6, save_model_iter=6)
    r0, _ = _launch("train", {**payload, "cfg": {**payload["cfg"], **more}},
                    tmp_path / "io_resume")
    through = {**payload, "cfg": {**payload["cfg"], "max_iter": 6,
                                  "logdir": str(through_dir)}}
    t0, _ = _launch("train", through, tmp_path / "io_through")
    assert r0["step"] == t0["step"] == 6
    for a, b in zip(bridge.tree_leaves(r0["params"]),
                    bridge.tree_leaves(t0["params"])):
        assert np.array_equal(a, b)
    got = [r for r in _records(mesh_dir) if "train_loss" in r]
    want = [r for r in _records(through_dir) if "train_loss" in r]
    assert [r["step"] for r in got] == list(range(1, 7))
    for a, b in zip(got, want):
        assert {k: v for k, v in a.items() if k.startswith("train_")} == {
            k: v for k, v in b.items() if k.startswith("train_")}
