"""Optimizer factory (counterpart of ``deepspeed_tpu/runtime/optimizers.py``;
reference: engine.py:1280 _configure_optimizer).

The reference's spellings map to canonical names so DeepSpeed JSON
configs work unchanged: Adam/AdamW/FusedAdam/CPUAdam -> adam(w), and so
on. Adam, AdamW and Lion are ported: with ``"fused_kernel": true`` (the
JAX package's switch to its Pallas ``fused_adam``/``fused_lion``) every
step is one launch of the fused-Adam or fused-Lion kernel; without it the
step is the same arithmetic in plain PyTorch (the JAX engine runs
``optax.adamw``/``optax.lion`` there, no kernel of its own). Every other
optimizer raises ``NotImplementedError`` naming its queue.
"""

from __future__ import annotations

from typing import Any, Callable

from ..ops.fused_optimizers import Adam, Lion

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
LION_OPTIMIZER = "lion"
SGD_OPTIMIZER = "sgd"
ADAGRAD_OPTIMIZER = "adagrad"
ADAFACTOR_OPTIMIZER = "adafactor"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"

# reference names -> canonical
_NAME_ALIASES = {
    "adam": ADAM_OPTIMIZER,
    "adamw": ADAMW_OPTIMIZER,
    "fusedadam": ADAM_OPTIMIZER,
    "fusedadamw": ADAMW_OPTIMIZER,
    "cpuadam": ADAM_OPTIMIZER,       # offload placement handled by engine
    "deepspeedcpuadam": ADAM_OPTIMIZER,
    "lamb": LAMB_OPTIMIZER,
    "fusedlamb": LAMB_OPTIMIZER,
    "lion": LION_OPTIMIZER,
    "fusedlion": LION_OPTIMIZER,
    "cpulion": LION_OPTIMIZER,
    "sgd": SGD_OPTIMIZER,
    "adagrad": ADAGRAD_OPTIMIZER,
    "cpuadagrad": ADAGRAD_OPTIMIZER,
    "adafactor": ADAFACTOR_OPTIMIZER,
    "onebitadam": ONEBIT_ADAM_OPTIMIZER,
    "zerooneadam": ZERO_ONE_ADAM_OPTIMIZER,
    "onebitlamb": ONEBIT_LAMB_OPTIMIZER,
}

# canonical name -> the ROADMAP queue entry that ports it
_NOT_PORTED = {
    LAMB_OPTIMIZER: "Queue 1, Slice F (other optimizers)",
    SGD_OPTIMIZER: "Queue 1, Slice F (other optimizers)",
    ADAGRAD_OPTIMIZER: "Queue 1, Slice F (other optimizers)",
    ADAFACTOR_OPTIMIZER: "Queue 1, Slice F (other optimizers)",
    ONEBIT_ADAM_OPTIMIZER: "Queue 1, Slice F (runtime/onebit.py)",
    ZERO_ONE_ADAM_OPTIMIZER: "Queue 1, Slice F (runtime/onebit.py)",
    ONEBIT_LAMB_OPTIMIZER: "Queue 1, Slice F (runtime/onebit.py)",
}


def build_optimizer(opt_type: str, params: dict[str, Any],
                    lr_schedule: Callable, dp_world: int = 1) -> Adam | Lion:
    """Build the optimizer from reference-style config params (lr comes
    from the schedule; betas, eps, weight_decay, adam_w_mode,
    fused_kernel)."""
    name = _NAME_ALIASES.get(opt_type.lower().replace("_", ""))
    if name is None:
        raise ValueError(f"unknown optimizer type {opt_type!r}; known: "
                         f"{sorted(set(_NAME_ALIASES))}")
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {opt_type!r} is not ported yet (ROADMAP: port "
            f"{_NOT_PORTED[name]})")
    p = dict(params)
    betas = p.pop("betas", (0.9, 0.999))
    fused = bool(p.pop("fused_kernel", False))
    if name == LION_OPTIMIZER:
        # betas defaults to Adam's (0.9, 0.999) before this branch, as in
        # the JAX factory, so a Lion config without betas runs b2 = 0.999;
        # only an empty betas takes optax's (0.9, 0.99)
        b1, b2 = (betas[0], betas[1]) if betas else (0.9, 0.99)
        return Lion(lr_schedule, b1=b1, b2=b2,
                    weight_decay=p.pop("weight_decay", 0.0), fused=fused)
    # the reference FusedAdam defaults to adam_w_mode=True; "adamw" is
    # always decoupled, "adam" with adam_w_mode false is L2 decay
    adamw_mode = name == ADAMW_OPTIMIZER or p.pop("adam_w_mode", True)
    return Adam(lr_schedule, b1=betas[0], b2=betas[1],
                eps=p.pop("eps", 1e-8),
                weight_decay=p.pop("weight_decay", 0.0),
                adamw_mode=adamw_mode, fused=fused)
