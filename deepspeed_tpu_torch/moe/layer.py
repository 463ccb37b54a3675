"""MoE layer API (counterpart of ``deepspeed_tpu/moe/layer.py``;
reference: deepspeed/moe/layer.py MoE).

The reference's ``MoE`` wraps a user expert module and creates expert
process groups. Here, as in JAX, the object bundles the gate and expert
parameters with the routing config: ``init`` gives the parameters as a
dict of tensors and ``__call__(params, x)`` runs the routed FFN. A
``dispatcher`` (``moe/dispatch.py`` ``EpShardedDispatcher``) routes over
the global batch and exchanges the rows with the ranks that hold the
other experts; ``params["experts"]`` is then this rank's ``E / ep``
experts and ``x`` its rows.
"""

from __future__ import annotations

import torch

from ..ops import layers as L
from ..utils.device import resolve_device
from .sharded_moe import moe_ffn, top_k_gating  # noqa: F401


class MoE:
    """Functional MoE FFN factory.

    Example:
        moe = MoE(hidden_size=512, ffn_dim=2048, num_experts=8, k=2)
        params = moe.init(torch.Generator().manual_seed(0))
        y, aux = moe(params, x)
    """

    def __init__(self, hidden_size: int, ffn_dim: int, num_experts: int,
                 k: int = 1, capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 activation: str = "gelu", use_residual: bool = False,
                 dispatcher=None):
        self.hidden_size = hidden_size
        self.ffn_dim = ffn_dim
        self.num_experts = num_experts
        self.k = k
        self.capacity_factor = capacity_factor
        self.min_capacity = min_capacity
        self.activation = activation
        self.use_residual = use_residual  # PR-MoE residual expert
        self.dispatcher = dispatcher

    def init(self, generator: torch.Generator | None = None,
             dtype=torch.float32, device=None) -> dict:
        """Normal std 0.02 draws from ``generator`` on ``device`` (None:
        the card, raising where there is none; the residual's down
        projection and mixing coefficients zero), in JAX's tree layout."""
        device = resolve_device(device)
        d, f, e = self.hidden_size, self.ffn_dim, self.num_experts

        def normal(*shape):
            return (torch.randn(shape, generator=generator, device=device)
                    * 0.02).to(dtype)

        params = {"router": normal(d, e),
                  "experts": {"w_up": normal(e, d, f),
                              "w_down": normal(e, f, d)}}
        if self.activation == "swiglu":
            params["experts"]["w_gate"] = normal(e, d, f)
        if self.use_residual:
            params["residual_mlp"] = {
                "w_up": normal(d, f),
                "w_down": torch.zeros((f, d), dtype=dtype, device=device),
                "coef": torch.zeros((d, 2), dtype=dtype, device=device)}
        return params

    def __call__(self, params: dict, x: torch.Tensor):
        out, aux = moe_ffn(
            x, params["router"], params["experts"], k=self.k,
            capacity_factor=self.capacity_factor,
            min_capacity=self.min_capacity, activation=self.activation,
            dispatcher=self.dispatcher)
        if self.use_residual:
            # PR-MoE: a dense residual expert mixed by a learned coefficient
            r = params["residual_mlp"]
            h = L.gelu(x @ r["w_up"]) @ r["w_down"]
            coef = torch.softmax(x @ r["coef"], dim=-1)
            out = out * coef[..., 0:1] + h * coef[..., 1:2]
        return out, aux

    def partition_rules(self):
        """JAX's rules, each spec a tuple of mesh-axis names."""
        return [
            (r"router", ()),
            (r"experts/(w_up|w_gate)$", ("ep", None, "tp")),
            (r"experts/w_down$", ("ep", "tp", None)),
            (r"residual_mlp", ()),
        ]
