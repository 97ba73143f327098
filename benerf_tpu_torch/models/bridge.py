"""Parameter bridge between the JAX pytree layout and the port's tensors.

The port keeps the JAX package's parameter layout (nested dicts and lists
with the same keys), so the bridge only converts leaves: numpy arrays in,
tensors out, and back. Parity tests build parameters on the JAX side, pass
them through `np.asarray` leaf by leaf and hand them to the port here.
"""

from __future__ import annotations

import numpy as np
import torch

from benerf_tpu_torch import resolve_device


def tree_map(fn, tree):
    """Apply fn to every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    """Leaves in a fixed order: dict keys sorted (as JAX flattens), lists
    in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree shaped like `tree` with its leaves replaced, in the order of
    tree_leaves, by `leaves`."""
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v) for v in t)
        return next(it)

    return rebuild(tree)


def params_from_numpy(tree, device=None):
    """Tree of numpy arrays (any array-likes) -> tree of tensors on
    `device` (default: the card, raising without one; see
    benerf_tpu_torch.resolve_device), dtype kept."""
    device = resolve_device(device)
    return tree_map(
        lambda x: torch.as_tensor(np.array(x), device=device), tree
    )


def params_to_numpy(tree):
    """Tree of tensors -> tree of numpy arrays (copies: the optimizer
    updates the tensors in place)."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)
