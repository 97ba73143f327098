"""One rank of a two-process CPU mesh of the PyTorch port, for
tests/test_torch_mesh.py.

    python tests/torch_mesh_child.py MODE IN.pkl OUT.pkl

started with the environment torch.distributed.run gives each process
(WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), so the port joins
its gloo group through parallel/mesh.initialize_distributed as a launched
run does. Reads its inputs from IN.pkl and writes its results to OUT.pkl
(both written by the test). MODE:
  loss   loss_fn under the mesh on injected global draws, then the loss,
         metrics and gradients summed over the ranks (all_reduce_flat);
  step   make_train_step / make_multi_step under the mesh for a few steps:
         every step's metrics and the final parameters;
  mesh   make_mesh, shard_rows, replicate_tree and all_reduce_sum;
  train  train() under the launch (rank 0 writes the run directory).
Imports torch and the port only.
"""

import pickle
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benerf_tpu_torch.core import config as tconfig  # noqa: E402
from benerf_tpu_torch.data import datasets as tdatasets  # noqa: E402
from benerf_tpu_torch.data import events as tevents  # noqa: E402
from benerf_tpu_torch.models import bridge  # noqa: E402
from benerf_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from benerf_tpu_torch.train import loop as tloop  # noqa: E402
from benerf_tpu_torch.train import step as tstep  # noqa: E402


def port_inputs(case, dtype):
    """(params, batch) of a case's numpy params and scene, in `dtype`."""
    params = bridge.tree_map(
        lambda t: t.to(dtype).requires_grad_(True),
        bridge.params_from_numpy(case["params"], device="cpu"))
    ev, img, K = case["scene"]
    batch = tstep.SceneBatch(
        events=tevents.prepare(*ev, width=case["cfg"]["event_width"],
                               device="cpu", dtype=dtype),
        image_flat=torch.as_tensor(img, dtype=dtype),
        rgb_exp_ts=torch.tensor([0.35, 0.65], dtype=dtype),
        K_rgb=torch.as_tensor(K, dtype=dtype),
        K_evt=torch.as_tensor(K, dtype=dtype))
    return params, batch


def draws_to_torch(draws):
    return {k: ({kk: torch.as_tensor(np.array(vv)) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.as_tensor(np.array(v)))
            for k, v in draws.items()}


def run_loss(case, mesh):
    cfg = tconfig.Config(**case["cfg"])
    params, batch = port_inputs(case, torch.float32)
    loss_fn, _ = tstep.make_loss_fn(cfg, case["H"], case["W"], mesh)
    total, metrics = loss_fn(params, batch, draws_to_torch(case["draws"]),
                             case["step"])
    leaves = bridge.tree_leaves(params)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    partial = {k: v.detach().clone() for k, v in metrics.items()
               if k not in tstep.REPLICATED_METRICS}
    partial["total"] = total.detach().clone()
    mesh_mod.all_reduce_flat(grads + list(partial.values()), mesh)
    return {"metrics": {k: float(v) for k, v in partial.items()},
            "overflow": float(metrics["eta_window_overflow"]),
            "grads": [g.numpy() for g in grads]}


def run_steps(case, mesh):
    cfg = tconfig.Config(**case["cfg"])
    params, batch = port_inputs(case, torch.float64)
    state = tstep.init_state(cfg, params=params)
    H, W = case["H"], case["W"]
    if case["multi"]:
        state, m = tstep.make_multi_step(cfg, H, W, case["n_steps"], mesh)(
            state, batch, case["seed"])
        rows = [{k: float(v[i]) for k, v in m.items()}
                for i in range(case["n_steps"])]
    else:
        step_fn = tstep.make_train_step(cfg, H, W, mesh)
        rows = []
        for _ in range(case["n_steps"]):
            state, m = step_fn(state, batch, case["seed"])
            rows.append({k: float(v) for k, v in m.items()})
    return {"metrics": rows, "params": bridge.params_to_numpy(state.params)}


def run_mesh_checks(mesh):
    out = {"size": mesh.size, "rank": mesh.rank, "backend": mesh.backend}
    again = mesh_mod.make_mesh(2, "cpu")
    out["make_mesh_2"] = (again.size, again.rank)
    for n in (1, 3):
        try:
            mesh_mod.make_mesh(n)
            out[f"make_mesh_{n}"] = None
        except ValueError as e:
            out[f"make_mesh_{n}"] = str(e)
    x = torch.arange(11 * 3).reshape(11, 3)
    out["shard_rows"] = mesh_mod.shard_rows(x, mesh).numpy()
    tree = {"a": torch.full((3,), float(mesh.rank)),
            "b": {"w": torch.arange(4.0) + 10 * mesh.rank}}
    mesh_mod.replicate_tree(tree, mesh)
    out["replicated"] = [t.numpy() for t in bridge.tree_leaves(tree)]
    x = torch.tensor([1.0 + mesh.rank, 2.0], requires_grad=True)
    y = mesh_mod.all_reduce_sum(x * x, mesh)
    (y * torch.tensor([3.0, 5.0 + mesh.rank])).sum().backward()
    out["all_reduce_sum"] = (y.detach().numpy(), x.grad.numpy())
    out["collectives"] = dict(mesh_mod.COLLECTIVES)
    return out


def run_train(payload):
    cfg = tconfig.Config(**payload["cfg"])
    ev, img, _ = payload["scene"]
    scene = tdatasets.SceneData(
        events=tevents.prepare(*ev, width=cfg.event_width, device="cpu"),
        image=img.reshape(1, payload["H"], payload["W"], -1), imgtest=None,
        rgb_exp_ts=np.array([0.35, 0.65]))
    state = tloop.train(cfg, scene, init_knots=payload["init_knots"],
                        device="cpu")
    return {"step": state.step,
            "params": bridge.params_to_numpy(state.params)}


def main():
    mode, in_path, out_path = sys.argv[1:4]
    torch.set_num_threads(1)
    with open(in_path, "rb") as f:
        payload = pickle.load(f)
    if mode == "train":
        out = run_train(payload)
    else:
        device = mesh_mod.initialize_distributed("cpu")
        mesh = mesh_mod.make_mesh(-1, device)
        if mode == "loss":
            out = [run_loss(case, mesh) for case in payload]
        elif mode == "step":
            out = [run_steps(case, mesh) for case in payload]
        elif mode == "mesh":
            out = run_mesh_checks(mesh)
        else:
            raise ValueError(f"unknown mode {mode!r}")
    mesh_mod.finalize_distributed()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
