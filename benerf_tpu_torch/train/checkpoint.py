"""Checkpoint save/restore with working resume.

Port of benerf_tpu/train/checkpoint.py. A checkpoint holds the whole
TrainState: every parameter, the torch.optim.Adam state of every parameter
that has one (exp_avg, exp_avg_sq and Adam's own per-parameter step, group
by group in group order) and the step. The format is one .npz of named
arrays, `{step:06d}.ckpt.npz` in the run directory as in the JAX package:
no pickle. Its `tree_signature` names every parameter's path and shape and
every optimizer group with its parameters' paths; restore refuses a file
whose signature differs from the template state's (most often from changed
optimize_* flags), so arrays are never loaded into the wrong places. A
checkpoint of the JAX package fails that check the same way.
Adam's step is saved from either device and restored onto the device the
restored optimizer keeps it on (the card when it is capturable), so a
checkpoint written on the card resumes on the CPU and the reverse.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

from benerf_tpu_torch import resolve_device
from benerf_tpu_torch.models import bridge
from benerf_tpu_torch.train import step as step_mod

_MOMENTS = ("exp_avg", "exp_avg_sq", "step")


def _ckpt_path(logdir: str, step: int) -> str:
    return os.path.join(logdir, f"{step:06d}.ckpt.npz")


def _named_params(tree, prefix=""):
    """[(path, tensor)] in the order of bridge.tree_leaves."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named_params(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _named_params(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _tree_signature(state) -> str:
    named = _named_params(state.params)
    path_of = {id(t): p for p, t in named}
    params = ";".join(f"{p}{tuple(t.shape)}" for p, t in named)
    groups = ";".join(
        g["name"] + ":" + ",".join(path_of[id(t)] for t in g["params"])
        for g in state.optimizer.param_groups)
    return f"params[{params}]|adam[{groups}]"


def save(logdir: str, state) -> str:
    """Write the state to logdir/{step:06d}.ckpt.npz; returns the path."""
    os.makedirs(logdir, exist_ok=True)
    arrays = {f"param/{p}": t.detach().cpu().numpy()
              for p, t in _named_params(state.params)}
    path_of = {id(t): p for p, t in _named_params(state.params)}
    for g in state.optimizer.param_groups:
        for t in g["params"]:
            for k, v in state.optimizer.state.get(t, {}).items():
                arrays[f"adam/{g['name']}/{path_of[id(t)]}/{k}"] = (
                    v.detach().cpu().numpy())
    arrays["step"] = np.array(state.step, np.int64)
    arrays["tree_signature"] = np.array(_tree_signature(state))
    path = _ckpt_path(logdir, state.step)
    np.savez_compressed(path, **arrays)
    return path


def latest_step(logdir: str) -> Optional[int]:
    if not os.path.isdir(logdir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(logdir)
             if (m := re.fullmatch(r"(\d{6})\.ckpt\.npz", f))]
    return max(steps) if steps else None


def restore(logdir: str, template, step: Optional[int] = None, device=None):
    """The TrainState saved at `step` (default: the latest), rebuilt on
    `template` (init_state's state for the same config, on `device`): its
    parameters are overwritten in place and its optimizer gets the saved
    Adam state. device: None is the card (raises without one)."""
    device = resolve_device(device)
    for t in bridge.tree_leaves(template.params):
        if t.device.type != device.type or (
                device.index is not None and t.device != device):
            raise ValueError(f"the template state lives on {t.device}, not "
                             f"on {device}")
    if step is None:
        step = latest_step(logdir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {logdir}")
    path = _ckpt_path(logdir, step)
    with np.load(path) as data:
        saved_sig = str(data["tree_signature"]) if "tree_signature" in data else ""
        want_sig = _tree_signature(template)
        if saved_sig != want_sig:
            raise ValueError(
                f"checkpoint structure mismatch for {path}: the saved "
                "TrainState treedef/shapes differ from the current config's "
                "(most often from changed optimize_* flags). Saved:\n  "
                f"{saved_sig[:300]}...\nexpected:\n  {want_sig[:300]}...")
        named = _named_params(template.params)
        with torch.no_grad():
            for p, t in named:
                t.copy_(torch.as_tensor(data[f"param/{p}"]))
        path_of = {id(t): p for p, t in named}
        opt = template.optimizer
        sd = opt.state_dict()  # params are numbered in group order
        sd["state"] = {}
        i = 0
        for g in opt.param_groups:
            for t in g["params"]:
                key = f"adam/{g['name']}/{path_of[id(t)]}/"
                if key + "step" in data:
                    sd["state"][i] = {k: torch.as_tensor(data[key + k])
                                      for k in _MOMENTS}
                    # Adam's step: on the parameter's device for a
                    # capturable Adam, on the CPU otherwise, float32 both
                    sd["state"][i]["step"] = sd["state"][i]["step"].to(
                        device=t.device if g["capturable"] else "cpu",
                        dtype=torch.float32)
                i += 1
        lrs = [g["lr"] for g in opt.param_groups]
        opt.load_state_dict(sd)
        # load_state_dict copies the groups: keep the lr tensors a captured
        # step reads
        for g, lr in zip(opt.param_groups, lrs):
            g["lr"] = lr
        saved_step = int(data["step"])
    return step_mod.TrainState(template.params, opt, saved_step)
