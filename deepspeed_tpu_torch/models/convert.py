"""Carry JAX parameters into the port's modules.

The two frameworks' random generators cannot make the same weights, so a
test that holds the port against the JAX package builds the JAX params
once and moves them across: ``load_jax_params(model, tree)`` takes the
nested dict of numpy arrays that ``jax.tree.map(np.asarray,
DecoderLM.init(key))`` gives and copies every leaf into the module's
parameter of the same path (``"layers/wq"`` for ``tree["layers"]["wq"]``).
"""

from __future__ import annotations

import numpy as np
import torch


def flatten_tree(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict -> {"a/b": leaf}."""
    out: dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flatten_tree(value, path + "/"))
        else:
            out[path] = value
    return out


def _to_numpy(leaf) -> np.ndarray:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: torch can't
        arr = arr.astype(np.float32)   # wrap it; the widening is exact
    return arr


@torch.no_grad()
def load_jax_params(model, tree: dict) -> None:
    """Copy a JAX parameter tree into ``model.params`` (cast to each
    parameter's dtype and device). Every name must match both ways and
    every shape exactly."""
    flat = flatten_tree(tree)
    have, want = set(flat), set(model.params.keys())
    if have != want:
        raise ValueError(
            f"parameter names differ: missing {sorted(want - have)}, "
            f"unexpected {sorted(have - want)}")
    for name, leaf in flat.items():
        arr = _to_numpy(leaf)
        param = model.params[name]
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != "
                             f"{tuple(param.shape)}")
        param.copy_(torch.from_numpy(np.array(arr)))   # a writable copy
