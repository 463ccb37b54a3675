"""Engine checkpoint save/load (counterpart of
``deepspeed_tpu/runtime/checkpointing.py``; reference: runtime/engine.py:2794,
3140 and runtime/checkpoint_engine/).

The directory is JAX's: ``<save_dir>/latest`` names the newest tag, and
``<save_dir>/<tag>/`` holds ``ds_meta.json`` (JAX's keys: ``global_steps``,
``global_samples``, ``skipped_steps``, ``zero_stage``, ``dtype``,
``client_state``) and ``state/``, the engine state written by
``runtime/checkpoint_engine.py`` (one safetensors file a rank and the
index of the layout). The state holds the counterpart of every key of the
JAX engine's state, by "/"-joined name:

- ``step``: the applied-step counter (``engine._step``);
- ``params/<name>``: the compute-dtype parameters;
- ``master/<name>``: the fp32 master, in mixed precision only (JAX's
  master is None in fp32, where the parameters are the master);
- ``opt_state/<key>/<name>`` and ``opt_state/<key>``: the optimizer's
  per-parameter moments (Adam's ``exp_avg``, ``exp_avg_sq``; Lion's
  ``exp_avg``) and its scalar ``count``;
- ``loss_scale/{scale,good_steps,hysteresis}``: the dynamic loss scaler.

Each rank writes its own pieces (ZeRO's shards along the plan's split
dim) and rank 0 the entries no rank splits; the index records each
entry's full shape and split dim, so a plain load at another world size
or ZeRO stage re-cuts the pieces (JAX: orbax reshards on read). That
covers the meshes the port has, pure ``fsdp`` or ``dp``.

The JAX package's NVMe-offload host files (``host_opt_rank*.npz``) have no
counterpart until the memory tiers are ported: the port writes none, and
a directory holding them is refused. The telemetry hooks of the JAX
module are its telemetry-off branch here (ROADMAP Slice G).
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Optional

import numpy as np
import torch

from ..comm import comm
from ..utils.logging import log_dist, logger
from .checkpoint_engine import (INDEX_FILE, LATEST_FILE, FORMAT,
                                build_checkpoint_engine, check_tag_dir,
                                rank_file)
from .loss_scaler import LossScaleState

_LOSS_SCALE = LossScaleState._fields          # scale, good_steps, hysteresis
_NP_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
             torch.float16: "float16"}


def _tag(engine, tag: Optional[str]) -> str:
    return tag if tag is not None else f"global_step{engine.global_steps}"


def _ckpt_engine(engine):
    ce = getattr(engine, "checkpoint_engine", None)
    if ce is None:
        ce = build_checkpoint_engine(engine.config, engine.group)
        engine.checkpoint_engine = ce
    return ce


def opt_entries(engine) -> dict[str, tuple[torch.Tensor, Optional[str]]]:
    """The optimizer state by entry key: (tensor, parameter name) for a
    flat per-parameter buffer's views, (tensor, None) for a scalar."""
    views = engine.master_state_dict()
    numel = engine._master.numel()
    out = {}
    for key, value in engine.opt_state.items():
        if not isinstance(value, torch.Tensor):
            raise NotImplementedError(f"optimizer state {key!r} of type "
                                      f"{type(value).__name__}: a "
                                      f"checkpoint holds tensors")
        if value.dim() == 0:
            out[f"opt_state/{key}"] = (value, None)
        elif value.shape == (numel,):
            layout = engine._layout
            for name in views:
                o, k, s = layout[name]
                out[f"opt_state/{key}/{name}"] = (value[o:o + k].view(s), name)
        else:
            raise NotImplementedError(
                f"optimizer state {key!r} of shape {tuple(value.shape)}: "
                f"neither a scalar nor a flat per-parameter buffer")
    return out


def state_entries(engine) -> dict[str, tuple[torch.Tensor, tuple,
                                             Optional[int]]]:
    """Every entry of the engine's state: key -> (this rank's piece, the
    full shape, the dim the ranks split it on or None)."""
    plan = engine.plan
    out = {"step": (engine._step, (), None)}
    for name, p in engine.module_state_dict().items():
        out[f"params/{name}"] = (p, plan.shapes[name], plan.param_dims[name])
    if engine._mixed:
        for name, m in engine.master_state_dict().items():
            out[f"master/{name}"] = (m, plan.shapes[name],
                                     plan.master_dims[name])
    for key, (t, name) in opt_entries(engine).items():
        out[key] = ((t, (), None) if name is None
                    else (t, plan.shapes[name], plan.master_dims[name]))
    for field, t in zip(_LOSS_SCALE, engine._loss_scale):
        out[f"loss_scale/{field}"] = (t, (), None)
    return out


def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[dict] = None,
                    save_latest: bool = True) -> bool:
    """Every rank calls it. Writes this rank's file (the async engine: in
    the background), rank 0 the index and ``ds_meta.json``, and points
    ``latest`` at the tag once every file is written."""
    tag = _tag(engine, tag)
    _validate_tag(engine, tag)
    save_dir = os.path.abspath(save_dir)
    path = os.path.join(save_dir, tag)
    ce = _ckpt_engine(engine)
    ce.create(tag)
    ce.makedirs(os.path.join(path, "state"))
    rank, world = engine.dp_rank, engine.plan.world
    entries = state_entries(engine)
    mine = {k: t for k, (t, _, dim) in entries.items()
            if dim is not None or rank == 0}
    if rank == 0:
        index = {"format": FORMAT, "world": world,
                 "zero_stage": engine.zero_stage,
                 "compute_dtype": _NP_NAMES[engine.compute_dtype],
                 "entries": {k: {"shape": list(shape),
                                 "dtype": str(t.dtype).removeprefix(
                                     "torch."), "dim": dim}
                             for k, (t, shape, dim) in entries.items()}}
        with open(os.path.join(path, "state", INDEX_FILE), "w") as f:
            json.dump(index, f)
        meta = {
            "global_steps": engine.global_steps,
            "global_samples": engine.global_samples,
            "skipped_steps": engine.skipped_steps,
            "zero_stage": engine.zero_stage,
            "dtype": _NP_NAMES[engine.compute_dtype],
            "client_state": client_state or {},
        }
        with open(os.path.join(path, "ds_meta.json"), "w") as f:
            json.dump(meta, f)
    ce.save(mine, os.path.join(path, "state", rank_file(rank)),
            {"format": "pt", "rank": str(rank), "world": str(world)})
    if save_latest:
        # the latest pointer must only name written checkpoints: sync
        # engines write it now, async engines defer to commit()/next save
        ce.register_latest(save_dir, tag)
    log_dist(f"saved checkpoint {tag} to {save_dir}")
    return True


def _validate_tag(engine, tag: str) -> None:
    """reference: engine.py _checkpoint_tag_validation — every rank must
    save under one tag: the crc32 of the tag, its max and min over the
    ranks (crc32 is the same in every interpreter, unlike ``hash``)."""
    mode = engine.config.checkpoint.tag_validation
    if mode == "Ignore" or engine.dp_world == 1:
        return
    h = zlib.crc32(tag.encode())
    hi = comm.all_reduce(torch.tensor(h, dtype=torch.int64,
                                      device=engine.device),
                         comm.ReduceOp.MAX, engine.group)
    lo = comm.all_reduce(torch.tensor(h, dtype=torch.int64,
                                      device=engine.device),
                         comm.ReduceOp.MIN, engine.group)
    if int(hi) != int(lo):
        msg = f"checkpoint tag {tag!r} differs across processes"
        if mode == "Fail":
            raise ValueError(msg)
        logger.warning(msg)


def find_tag(load_dir: str, tag: Optional[str]) -> Optional[str]:
    """``tag``, or the one ``<load_dir>/latest`` names (None without it)."""
    if tag is not None:
        return tag
    latest = os.path.join(load_dir, LATEST_FILE)
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        return f.read().strip()


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                    load_optimizer_states: bool = True,
                    load_module_only: bool = False):
    """Every rank calls it. Returns ``(path, client_state)``, or ``(None,
    {})`` with a warning where ``load_dir`` has no ``latest`` and no tag
    is given. ``load_module_only`` restores the parameters alone,
    ``load_optimizer_states=False`` the parameters, master, step and loss
    scale (JAX's subsets); the counters and ``client_state`` come from
    ``ds_meta.json`` in every case."""
    load_dir = os.path.abspath(load_dir)
    tag = find_tag(load_dir, tag)
    if tag is None:
        logger.warning(f"no checkpoint found at {load_dir}")
        return None, {}
    path = os.path.join(load_dir, tag)

    if engine.config.checkpoint.load_universal:
        from ..checkpoint.universal import load_universal_checkpoint
        client_state = load_universal_checkpoint(engine, path)
        return path, client_state

    check_tag_dir(path)
    ckpt = _ckpt_engine(engine).load(os.path.join(path, "state"))
    if load_module_only:
        groups = ("params",)
    elif not load_optimizer_states:
        groups = ("params", "master", "step", "loss_scale")
    else:
        groups = ("params", "master", "step", "loss_scale", "opt_state")
    restore_state(engine, ckpt, groups)

    meta_path = os.path.join(path, "ds_meta.json")
    client_state = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        engine.global_steps = meta.get("global_steps", 0)
        engine.global_samples = meta.get("global_samples", 0)
        engine.skipped_steps = meta.get("skipped_steps", 0)
        client_state = meta.get("client_state", {})
    log_dist(f"loaded checkpoint {tag} from {load_dir}")
    return path, client_state


@torch.no_grad()
def restore_state(engine, ckpt, groups) -> None:
    """Copy the entries of ``groups`` from the checkpoint ``ckpt`` into
    the engine, each cut to this rank's piece of the engine's plan. Names
    and shapes must be the engine's; the master, where the checkpoint has
    none (an fp32 run), is the parameters."""
    plan, world, rank = engine.plan, engine.plan.world, engine.dp_rank
    want = state_entries(engine)
    for key, (_, shape, _) in want.items():
        if key.split("/")[0] not in groups:
            continue
        if key.startswith("master/") and key not in ckpt:
            key_from = "params/" + key[len("master/"):]
        else:
            key_from = key
        if key_from not in ckpt:
            raise ValueError(f"{ckpt.path!r} holds no {key_from!r}")
        saved = tuple(ckpt.entries[key_from]["shape"])
        if saved != tuple(shape):
            raise ValueError(f"{key_from}: shape {saved} in the checkpoint, "
                             f"{tuple(shape)} in the engine")

    def piece(key):
        return lambda dim: ckpt.piece(key, world, rank, dim)

    if "params" in groups:
        for name in plan.shapes:
            put_param(engine, name, piece(f"params/{name}"))
    if "master" in groups and engine._mixed:
        for name in plan.shapes:
            key = f"master/{name}"
            put_master(engine, name,
                       piece(key if key in ckpt else f"params/{name}"))
    if "step" in groups:
        engine._step.copy_(ckpt.full("step"))
    if "loss_scale" in groups:
        engine._loss_scale = LossScaleState(*(
            t.clone().copy_(ckpt.full(f"loss_scale/{f}"))
            for f, t in zip(_LOSS_SCALE, engine._loss_scale)))
    if "opt_state" in groups:
        for key, (t, name) in opt_entries(engine).items():
            dim = None if name is None else plan.master_dims[name]
            t.copy_(ckpt.piece(key, world, rank, dim))


@torch.no_grad()
def put_param(engine, name: str, get) -> None:
    """Set parameter ``name`` from ``get(dim)``, the value's piece for
    this rank when the ranks split it on ``dim`` (None: the whole value),
    in any dtype: the compute-dtype view the optimizer writes (this rank's
    master-layout piece; in fp32 it is the master) and, where stages 1-2
    replicate a split leaf, the full replica the model reads."""
    engine._compute_views[name].copy_(get(engine.plan.master_dims[name]))
    if name in engine._replica_views:
        engine._replica_views[name].copy_(get(None))


@torch.no_grad()
def put_master(engine, name: str, get) -> None:
    """Set this rank's piece of the fp32 master of ``name`` (see
    :func:`put_param`)."""
    engine.master_state_dict()[name].copy_(get(engine.plan.master_dims[name]))


def save_16bit_model(engine, save_dir: str,
                     checkpoint_name: str = "model_weights.npz") -> bool:
    """Consolidated 16-bit weights export (reference: engine.py
    save_16bit_model:3638 / _zero3_consolidated_16bit_state_dict:3569).

    Gathers every (possibly ZeRO-3-split) parameter, a collective every
    rank calls, and rank 0 writes one ``.npz`` of name -> array, the names
    those of ``checkpoint.universal.flatten_with_names``. bfloat16 is
    upcast losslessly to float32 (numpy's npz format cannot represent it);
    float16 is stored as it is."""
    from ..checkpoint.universal import flatten_with_names
    os.makedirs(save_dir, exist_ok=True)
    out = {}
    for name, leaf in flatten_with_names(engine.gathered_params()):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.numpy()
    if comm.get_rank(engine.group) == 0:
        np.savez(os.path.join(save_dir, checkpoint_name), **out)
    log_dist(f"saved 16-bit model weights to {save_dir}/{checkpoint_name}")
    return True
