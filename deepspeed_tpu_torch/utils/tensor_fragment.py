"""Debug APIs over the engine's sharded state (counterpart of
``deepspeed_tpu/utils/tensor_fragment.py``; reference:
deepspeed/utils/tensor_fragment.py safe_get/set_full_fp32_param /
safe_get_full_grad / safe_get/set_full_optimizer_state, :132-243).

The reference maps each lp parameter to its fragment of a flat hp
partition (``get_hp_fragment_mapping`` :312). The port's engine keeps the
same kind of layout: the fp32 master, the grads and each optimizer moment
are flat buffers with a view per parameter (``runtime/engine.py``
``_flat_layout``), holding this rank's shard along the ZeRO plan's split
dim. A getter takes the view and, where the plan splits the leaf across
ranks, all-gathers it (a collective: every rank calls it); a setter writes
this rank's slice of the full value. Names are the "/"-joined parameter
names (``"layers/wq"``), matched exactly or by a unique suffix, as in the
JAX module. Getters return fp32 numpy arrays.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..comm import comm

_MOMENT_KEYS = {"mu": "exp_avg", "nu": "exp_avg_sq"}   # optax -> torch names


def _match(names, name: str) -> Optional[str]:
    """Exact name wins; otherwise a unique suffix match (the same rule for
    getters and setters, so what can be read can be written)."""
    if name in names:
        return name
    hits = [k for k in names if k.endswith("/" + name)]
    return hits[0] if len(hits) == 1 else None


def _numpy(t: torch.Tensor) -> np.ndarray:
    """An fp32 copy on the host (never a view of the engine's state)."""
    return t.detach().to("cpu", torch.float32, copy=True).numpy()


def _full(engine, piece: torch.Tensor, dim) -> np.ndarray:
    if dim is not None:
        piece = comm.all_gather(piece, group=engine.group, axis=dim)
    return _numpy(piece)


def _views(engine, flat: torch.Tensor) -> dict[str, torch.Tensor]:
    return {n: flat[o:o + k].view(s)
            for n, (o, k, s) in engine._layout.items()}


def safe_get_full_fp32_param(engine, name: str) -> Optional[np.ndarray]:
    """Full fp32 master weight (reference: tensor_fragment.py:193)."""
    hit = _match(engine.plan.shapes, name)
    if hit is None:
        return None
    return _full(engine, engine.master_state_dict()[hit],
                 engine.plan.master_dims[hit])


@torch.no_grad()
def safe_set_full_fp32_param(engine, name: str, value) -> bool:
    """Overwrite a master weight and its compute-dtype copy (reference:
    tensor_fragment.py:212 safe_set_full_fp32_param)."""
    hit = _match(engine.plan.shapes, name)
    if hit is None:
        return False   # ambiguous or absent: refuse, like the getter
    value = torch.as_tensor(np.asarray(value, np.float32))
    if tuple(value.shape) != engine.plan.shapes[hit]:
        raise ValueError(f"shape mismatch for {name}: "
                         f"{engine.plan.shapes[hit]} vs {tuple(value.shape)}")
    own = engine._own(value, engine.plan.master_dims[hit])
    engine.master_state_dict()[hit].copy_(own)
    engine._compute_views[hit].copy_(own)
    if hit in engine._replica_views:
        engine._replica_views[hit].copy_(value)
    return True


def safe_get_full_grad(engine, name: str) -> Optional[np.ndarray]:
    """The gradient accumulated by ``backward`` since the last ``step``
    (the loss-scaled sum over the micro-batches, as JAX's ``_accum_grads``;
    reference: tensor_fragment.py:132), or None where no backward is in
    flight (``train_batch`` consumes its grads inside the step). At ZeRO
    stage < 2 across ranks the grads wait unreduced for the boundary, so
    the ranks' shares are reduced here."""
    hit = _match(engine.plan.shapes, name)
    if hit is None or engine._micro_count == 0:
        return None
    if engine._defer_reduce:
        g = engine._local_grad_views[hit].clone()
        op = (comm.ReduceOp.AVG if engine._per_rank_mean
              else comm.ReduceOp.SUM)
        return _numpy(comm.all_reduce(g, op, engine.group))
    return _full(engine, engine._grad_views[hit],
                 engine.plan.grad_dims[hit])


def _moment(engine, state_key: str) -> Optional[torch.Tensor]:
    buf = engine.opt_state.get(_MOMENT_KEYS.get(state_key, state_key))
    if isinstance(buf, torch.Tensor) and buf.shape == engine._master.shape:
        return buf
    return None


def safe_get_full_optimizer_state(engine, name: str,
                                  state_key: str) -> Optional[np.ndarray]:
    """Optimizer moment of a parameter; ``state_key`` is the reference's
    torch name ("exp_avg"/"exp_avg_sq") or optax's ("mu"/"nu")
    (reference: tensor_fragment.py:160)."""
    buf = _moment(engine, state_key)
    hit = _match(engine.plan.shapes, name)
    if buf is None or hit is None:
        return None
    return _full(engine, _views(engine, buf)[hit],
                 engine.plan.master_dims[hit])


@torch.no_grad()
def safe_set_full_optimizer_state(engine, name: str, state_key: str,
                                  value) -> bool:
    """reference: tensor_fragment.py:227 safe_set_full_optimizer_state."""
    buf = _moment(engine, state_key)
    hit = _match(engine.plan.shapes, name)
    if buf is None or hit is None:
        return False   # ambiguous or absent: refuse, like the getter
    value = torch.as_tensor(np.asarray(value, np.float32))
    if tuple(value.shape) != engine.plan.shapes[hit]:
        raise ValueError(f"shape mismatch for {name}.{state_key}: "
                         f"{engine.plan.shapes[hit]} vs "
                         f"{tuple(value.shape)}")
    _views(engine, buf)[hit].copy_(
        engine._own(value, engine.plan.master_dims[hit]))
    return True
