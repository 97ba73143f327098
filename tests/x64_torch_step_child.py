"""JAX side of test_torch_step.py::test_loss_fn_float64_matches_jax (a
subprocess child: jax_enable_x64 is process-global).

    python tests/x64_torch_step_child.py DIR

Reads DIR/in.npz (the case name, the float32 parameter leaves in
jax.tree.leaves order, the injected draws and the step), runs JAX
make_loss_fn's value_and_grad with every array cast to float64, and writes
the loss terms and the gradient leaves to DIR/out.npz.
"""

import dataclasses
import os
import pathlib
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import test_golden_grad as gg  # noqa: E402
import test_torch_step as ts  # noqa: E402

from benerf_tpu.train import step as jstep  # noqa: E402


def _f64(a):
    a = jnp.asarray(a)
    return a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a


def main(d):
    d = pathlib.Path(d)
    g = np.load(d / "in.npz")
    name = str(g["name"])
    case, overrides, _, _, _ = ts.LOSS_CASES[name]
    jcfg = dataclasses.replace(gg.build_cfg(case), **overrides)
    C = jcfg.channels
    jparams, jbatch = ts._jax_side(jcfg, 7, C, np.zeros((4, 6), np.float32),
                                   np.zeros(6, np.float32))
    leaves = [g[f"p{i}"] for i in range(len(jax.tree.leaves(jparams)))]
    params = jax.tree.map(_f64, jax.tree.unflatten(jax.tree.structure(jparams),
                                                   leaves))
    batch = jax.tree.map(_f64, jbatch)
    draws = {}
    for k in g.files:
        if k.startswith("d:"):
            *outer, inner = k[2:].split(":")
            (draws.setdefault(outer[0], {}) if outer else draws)[inner] = _f64(g[k])
    loss_fn, _ = jstep.make_loss_fn(jcfg, ts.H_RGB, ts.W_RGB)
    (total, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, batch, draws, jnp.asarray(int(g["step"]), jnp.int32))
    assert jnp.asarray(total).dtype == jnp.float64
    np.savez(d / "out.npz", total=np.asarray(total),
             **{f"m:{k}": np.asarray(v) for k, v in metrics.items()},
             **{f"g{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(grads))})


if __name__ == "__main__":
    main(sys.argv[1])
