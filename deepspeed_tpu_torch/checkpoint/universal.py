"""Universal checkpoint: canonical per-parameter fp32 fragments that load at
any parallelism degree (counterpart of
``deepspeed_tpu/checkpoint/universal.py``; reference:
deepspeed/checkpoint/ds_to_universal.py and universal_checkpoint.py:22).

The layout is the JAX package's, letter for letter (names, shapes, fp32
``.npy`` files and the moments' order), so either package loads what the
other wrote:

    <out>/ds_universal_meta.json
    <out>/zero/<param/name>/fp32.npy
    <out>/zero/<param/name>/exp_avg.npy      # first param-shaped moment
    <out>/zero/<param/name>/exp_avg_sq.npy   # second, if present

:func:`ds_to_universal` reads a checkpoint of ``engine.save_checkpoint``
one entry at a time (each rank's pieces concatenated along the recorded
split dim: peak host memory is one leaf) and writes the fragments;
:func:`load_universal_checkpoint` puts them into a live engine at its own
ZeRO stage and world size.
"""

from __future__ import annotations

import json
import os
from collections import namedtuple
from typing import Any, Iterator, Optional

import numpy as np
import torch

from ..runtime.checkpoint_engine import MEMORY_TIERS
from ..runtime.checkpointing import opt_entries, put_master, put_param
from ..utils.logging import log_dist, logger
from .zero_to_fp32 import _find_tag, hp_names, open_checkpoint

META_FILE = "ds_universal_meta.json"
ZERO_DIR = "zero"
MOMENT_NAMES = ["exp_avg", "exp_avg_sq", "exp_moment_3", "exp_moment_4"]

_Leaf = namedtuple("_Leaf", "shape")


def _paths(tree, prefix=()) -> Iterator[tuple[tuple, Any]]:
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from _paths(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def flatten_with_names(tree) -> list[tuple[str, Any]]:
    """(slash-joined name, leaf) pairs of a nested dict, or of a flat
    mapping of "/"-joined names, in the JAX flatten's order (every level's
    keys sorted)."""
    nested: dict = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            nested[key] = value
            continue
        node = nested
        *parents, last = str(key).split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = value
    return [("/".join(p), v) for p, v in _paths(nested)]


def _is_moment_of(leaf_name: str, leaf_shape: tuple, pname: str,
                  param_shapes: dict[str, tuple]) -> bool:
    """An opt-state leaf whose name *ends with* a parameter's name and
    whose shape matches is a moment of that parameter."""
    return (leaf_name == pname or leaf_name.endswith("/" + pname)) \
        and tuple(leaf_shape) == param_shapes[pname]


def _match_moments(opt_state: dict, param_names: list[str],
                   param_shapes: dict[str, tuple]) -> dict[str, list]:
    """Find the optimizer-state leaves (``opt_state``: name -> leaf with a
    ``shape``, in the state's order) that are per-parameter moments. Order
    of appearance determines exp_avg vs exp_avg_sq, as in the reference
    (ds_to_universal.py:112) and the JAX package."""
    moments: dict[str, list] = {n: [] for n in param_names}
    for name, leaf in opt_state.items():
        for pname in param_names:
            if _is_moment_of(name, leaf.shape, pname, param_shapes):
                moments[pname].append((name, leaf))
                break
    return moments


def ds_to_universal(checkpoint_dir: str, output_dir: str,
                    tag: Optional[str] = None) -> str:
    """Convert a saved engine checkpoint to universal format (reference:
    ds_to_universal.py main). Streamed: each parameter's and moment's
    pieces are read, written and freed one at a time."""
    checkpoint_dir = os.path.abspath(checkpoint_dir)
    tag = _find_tag(checkpoint_dir, tag)
    streamed_file = os.path.join(checkpoint_dir, tag, "streamed_state.npz")
    if os.path.exists(streamed_file):
        raise NotImplementedError(
            f"{streamed_file!r} is a checkpoint of the JAX package's "
            f"layer-streamed engine (runtime/infinity.py), not ported yet "
            f"({MEMORY_TIERS})")
    ckpt = open_checkpoint(checkpoint_dir, tag)
    src, names = hp_names(ckpt)
    names = [n for n, _ in flatten_with_names({n: n for n in names})]
    shapes = {n: tuple(ckpt.entries[f"{src}/{n}"]["shape"]) for n in names}
    opt = {k[len("opt_state/"):]: _Leaf(tuple(e["shape"]))
           for k, e in ckpt.entries.items() if k.startswith("opt_state/")}
    moments = _match_moments(opt, names, shapes)

    zdir = os.path.join(os.path.abspath(output_dir), ZERO_DIR)
    for name in names:
        pdir = os.path.join(zdir, name)
        os.makedirs(pdir, exist_ok=True)
        np.save(os.path.join(pdir, "fp32.npy"),
                ckpt.full(f"{src}/{name}").float().numpy())
        for i, (key, _) in enumerate(moments[name]):
            mname = MOMENT_NAMES[i] if i < len(MOMENT_NAMES) else f"moment_{i}"
            np.save(os.path.join(pdir, f"{mname}.npy"),
                    ckpt.full(f"opt_state/{key}").float().numpy())

    step = int(ckpt.full("step")) if "step" in ckpt else 0
    _write_universal_meta(checkpoint_dir, output_dir, tag, step, names,
                          {n: len(m) for n, m in moments.items()})
    return output_dir


def _write_universal_meta(checkpoint_dir: str, output_dir: str, tag: str,
                          step: int, names: list[str],
                          n_moments: dict[str, int]) -> None:
    meta = {
        "tag": tag,
        "step": step,
        "param_names": names,
        "n_moments": n_moments,
    }
    src_meta = os.path.join(checkpoint_dir, tag, "ds_meta.json")
    if os.path.exists(src_meta):
        with open(src_meta) as f:
            meta["ds_meta"] = json.load(f)
    with open(os.path.join(os.path.abspath(output_dir), META_FILE), "w") as f:
        json.dump(meta, f)
    log_dist(f"universal checkpoint written to {output_dir} "
             f"({len(names)} params)")


def _iter_param_files(universal_dir: str) -> Iterator[tuple[str, str]]:
    zdir = os.path.join(universal_dir, ZERO_DIR)
    for root, _dirs, files in os.walk(zdir):
        if "fp32.npy" in files:
            yield os.path.relpath(root, zdir), root


@torch.no_grad()
def load_universal_checkpoint(engine, universal_dir: str) -> dict:
    """Load universal fragments into a live engine at its own ZeRO stage
    and world size (reference: universal_checkpoint.py:22): the
    parameters (cast to the compute dtype), the master, the moments
    matched by order, the optimizer's step counter and the engine's
    ``_step`` at the checkpoint's step (or Adam's bias correction would
    restart at t = 1), and the counters of ``ds_meta``. The loss scale is
    not restored, as in JAX. Every rank calls it; each reads the whole
    fragments (mapped from the files) and keeps its piece. Returns the
    client_state persisted at save time."""
    universal_dir = os.path.abspath(universal_dir)
    if not os.path.exists(os.path.join(universal_dir, META_FILE)):
        raise FileNotFoundError(
            f"{universal_dir} is not a universal checkpoint "
            f"(missing {META_FILE})")
    with open(os.path.join(universal_dir, META_FILE)) as f:
        meta = json.load(f)

    # copy-on-write maps: each piece is read from the page cache as it is
    # put, never the whole state at once
    fp32: dict[str, np.ndarray] = {}
    moments: dict[str, list[np.ndarray]] = {}
    for name, pdir in _iter_param_files(universal_dir):
        fp32[name] = np.load(os.path.join(pdir, "fp32.npy"), mmap_mode="c")
        moments[name] = []
        for mname in MOMENT_NAMES:
            mpath = os.path.join(pdir, f"{mname}.npy")
            if os.path.exists(mpath):
                moments[name].append(np.load(mpath, mmap_mode="c"))

    # --- params / master ------------------------------------------------
    plan = engine.plan
    for name in plan.shapes:
        if name not in fp32:
            logger.warning(f"universal ckpt missing param {name}; keeping "
                           "current value")
            continue
        if tuple(fp32[name].shape) != plan.shapes[name]:
            raise ValueError(f"{name}: shape {tuple(fp32[name].shape)} in "
                             f"the checkpoint, {plan.shapes[name]} in the "
                             f"engine")
        full = torch.from_numpy(fp32[name])

        def get(dim, full=full):
            return engine._own(full, dim)

        put_param(engine, name, get)
        if engine._mixed:
            put_master(engine, name, get)

    # --- optimizer moments ---------------------------------------------
    # matched on the full shapes (a rank holds its shard of each moment)
    names = list(fp32)
    shapes = {n: tuple(v.shape) for n, v in fp32.items()}
    entries = opt_entries(engine)
    opt = {k[len("opt_state/"):]: _Leaf(() if n is None else plan.shapes[n])
           for k, (_, n) in entries.items()}
    slot_map = _match_moments(opt, names, shapes)
    for pname, slots in slot_map.items():
        for i, (key, _) in enumerate(slots):
            if pname in moments and i < len(moments[pname]):
                entries["opt_state/" + key][0].copy_(engine._own(
                    torch.from_numpy(moments[pname][i]),
                    plan.master_dims[pname]))

    step = int(meta.get("step", 0))
    # the optimizer's step counter is a scalar the fragments don't carry:
    # resume it at the checkpoint's step (JAX bump_counts)
    for key, (t, pname) in entries.items():
        if pname is None and key.rsplit("/", 1)[-1] == "count" \
                and not t.dtype.is_floating_point:
            t.fill_(step)
    engine._step.fill_(step)
    ds_meta = meta.get("ds_meta", {})
    engine.global_steps = int(ds_meta.get("global_steps", step))
    engine.global_samples = int(ds_meta.get("global_samples", 0))
    engine.skipped_steps = int(ds_meta.get("skipped_steps", 0))
    log_dist(f"loaded universal checkpoint from {universal_dir} "
             f"({len(fp32)} params, step={step})")
    return ds_meta.get("client_state", {})
