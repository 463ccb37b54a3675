"""MoE gating and the routed expert FFN on one card (counterpart of
``deepspeed_tpu/moe/sharded_moe.py``; reference: deepspeed/moe/sharded_moe.py).

Routing is JAX's GShard-style top-k with static shapes: fp32 softmax
probabilities, the k largest per token (ties to the lower expert index,
as ``lax.top_k``), then capacity positions claimed slot-major, every
token's first choice before any second choice, and the choices at or past
``capacity`` dropped (the residual carries them). :func:`top_k_gating`
returns JAX's dense ``combine`` / ``dispatch`` [N, E, C] tables for its own
callers; :func:`moe_ffn` computes the same function in index form: the
kept (expert, slot) rows are gathered into [E, C, D], the experts run as
batched matmuls, and each token sums its kept choices' outputs times their
gate weights. No [N, E, C] table is built on the model path (at 8192
tokens, 60 experts and capacity 683 the fp32 combine table alone is 1.3 GB
a layer, and the dense dispatch product 1.4 TFLOP).

:func:`moe_ffn_grouped` is the serving dispatch without capacity (JAX's
sort-by-expert ``lax.ragged_dot``): the rows sorted by expert and the
experts' products through the grouped GEMM of ``ops/grouped_gemm.py``,
which reads the group offsets on the device: a CUDA graph captures it as
it captures the capacity form.

Expert parallelism (the ``ep`` axis, ``moe/dispatch.py`` and
``runtime/comm/moe_alltoall.py``) is not ported: a ``dispatcher`` raises.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..ops import layers as L
from ..ops.grouped_gemm import group_offsets, grouped_mm
from ..ops.quantization import dequantize_weight

EP_UNPORTED = (
    "expert parallelism (the ep mesh axis, moe/dispatch.py "
    "EpShardedDispatcher, runtime/comm/moe_alltoall.py) is not ported yet "
    "(ROADMAP Slice D item 12, expert parallelism: after item 11's mixed "
    "meshes and two-hop wire)")
TELEMETRY_UNPORTED = (
    "moe router telemetry publishes through the telemetry registry, not "
    "ported yet (ROADMAP Slice G item 15)")


def compute_capacity(num_tokens: int, num_experts: int, k: int,
                     capacity_factor: float, min_capacity: int = 4) -> int:
    """reference: sharded_moe.py:161 _capacity."""
    cap = math.ceil(num_tokens * k / num_experts * capacity_factor)
    return max(cap, min_capacity)


class Routing(NamedTuple):
    """One block's routing decisions: ``idx`` [N, k] experts (descending
    probability, ties to the lower index), ``pos`` [N, k] capacity
    positions, ``keep`` [N, k], ``gate`` [N, k] fp32 gate weights (0 where
    dropped), ``capacity``, ``aux`` (the load-balance loss) and
    ``metrics`` (capacity, drop_fraction, expert_load)."""
    idx: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    gate: torch.Tensor
    capacity: int
    aux: torch.Tensor
    metrics: dict


def top_k(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest values and their
    indices, equal values in index order. ``torch.topk`` does not promise
    an order among equal values; a stable descending sort does."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _top_probs(logits: torch.Tensor, k: int, normalize_topk: bool):
    probs = torch.softmax(logits.float(), dim=-1)
    topk_probs, topk_idx = top_k(probs, k)
    if normalize_topk and k > 1:
        topk_probs = topk_probs / topk_probs.sum(-1, keepdim=True)
    return probs, topk_probs, topk_idx


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx``'s one-hot rows over ``n`` classes (bool): a comparison, so
    no launch reads the indices back to the host and a CUDA graph can
    capture it."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def _aux_loss(probs: torch.Tensor, topk_idx: torch.Tensor):
    """The load-balance loss (reference: l_aux in top1/top2gating) and the
    top-1 load per expert."""
    e = probs.shape[-1]
    me = probs.mean(0)
    ce = _one_hot(topk_idx[:, 0], e).float().mean(0)
    return (me * ce).sum() * e, ce


def route(logits: torch.Tensor, k: int, capacity_factor: float = 1.0,
          min_capacity: int = 4, normalize_topk: bool = True,
          drop_tokens: bool = True) -> Routing:
    """The routing of :func:`top_k_gating` for router ``logits`` [N, E]."""
    n, e = logits.shape
    if drop_tokens:
        capacity = compute_capacity(n, e, k, capacity_factor, min_capacity)
    else:
        # one expert takes at most one slot a token: n slots at worst
        capacity = max(n, min_capacity)
    probs, topk_probs, topk_idx = _top_probs(logits, k, normalize_topk)
    # slot-major positions: the cumsum over the [k*N, E] one-hot in
    # (choice, token) order, read at each choice's expert. The scan runs
    # along the inner axis of the [E, k*N] transpose: CUDA's scan along an
    # outer axis takes a thread a column (1.6 ms a layer at 8192 choices,
    # half a prefill tick's device time, against microseconds)
    idx_sm = topk_idx.t().reshape(-1)
    onehot = _one_hot(idx_sm, e).t().long()                    # [E, k*N]
    before = torch.cumsum(onehot, 1) - onehot
    pos = before.gather(0, idx_sm[None, :]).reshape(k, n).t()
    keep = (pos < capacity if drop_tokens
            else torch.ones_like(pos, dtype=torch.bool))
    gate = topk_probs * keep
    aux, load = _aux_loss(probs, topk_idx)
    metrics = {"capacity": capacity,
               "drop_fraction": 1.0 - keep.float().mean(),
               "expert_load": load}
    return Routing(topk_idx, pos, keep, gate, capacity, aux, metrics)


def top_k_gating(logits: torch.Tensor, k: int, capacity_factor: float = 1.0,
                 min_capacity: int = 4, normalize_topk: bool = True,
                 drop_tokens: bool = True):
    """(combine [N, E, C] fp32, dispatch [N, E, C] bool, aux_loss, metrics)
    for router ``logits`` [N, E], JAX's one-hot tables."""
    r = route(logits, k, capacity_factor, min_capacity, normalize_topk,
              drop_tokens)
    e, c = logits.shape[-1], r.capacity
    masks = _one_hot(r.idx, e).float()                         # [N, k, E]
    loc = torch.where(r.keep, r.pos, torch.full_like(r.pos, c))
    loc_oh = _one_hot(loc, c).float()   # a dropped choice: a zero row
    combine = torch.einsum("nk,nke,nkc->nec", r.gate, masks, loc_oh)
    return combine, combine > 0, r.aux, r.metrics


def quantize_expert_leaf(w: torch.Tensor, scale_dtype):
    """One routed-expert weight's (int8 codes, scales in ``scale_dtype``)
    as :func:`quantize_experts` makes them, a layer of a layer-stacked
    leaf at a time."""
    if w.dim() > 3:         # a layer-stacked leaf: one layer's temporaries
        parts = [quantize_expert_leaf(w[i], scale_dtype)
                 for i in range(len(w))]
        return (torch.stack([q for q, _ in parts]),
                torch.stack([s for _, s in parts]))
    w32 = w.float()
    # a divisor tensor on w's device: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which rounds some scales 1 ulp
    # away from JAX's amax / 127 (and then codes a step away)
    qmax = torch.tensor(127.0, device=w.device)
    s = torch.clamp(w32.abs().amax(dim=-2, keepdim=True) / qmax, min=1e-12)
    return torch.round(w32 / s).to(torch.int8), s.to(scale_dtype)


@torch.no_grad()
def quantize_experts(experts: dict, scale_dtype=None) -> dict:
    """Weight-only int8 routed experts (JAX ``quantize_experts``): each
    weight [..., D, F] becomes ``name_q`` (int8, ``round(w / s)`` half to
    even) and ``name_s`` [..., 1, F], the per-output-channel scale
    ``max|w| / 127`` over the contraction axis in fp32, kept in
    ``scale_dtype`` (None: the weight's dtype)."""
    out = {}
    for name, w in experts.items():
        q, s = quantize_expert_leaf(w, scale_dtype or w.dtype)
        out[name + "_q"], out[name + "_s"] = q, s
    return out


def dequantize_experts(experts: dict, dtype) -> dict:
    """A :func:`quantize_experts` dict back in ``dtype``: ``codes`` times
    ``scales``, each rounded to ``dtype`` as JAX rounds them; any ``*_q``
    key marks the quantized form, and a float dict comes back as it is."""
    if not any(k.endswith("_q") for k in experts):
        return experts
    return {k[:-2]: dequantize_weight(experts[k], experts[k[:-2] + "_s"],
                                      dtype)
            for k in experts if k.endswith("_q")}


def _ffn(x: torch.Tensor, w_up, w_down, w_gate, activation: str):
    if activation == "swiglu":
        h = L.silu(x @ w_gate) * (x @ w_up)
    else:
        h = L.gelu(x @ w_up)
    return h @ w_down


def _expert_ffn(expert_in: torch.Tensor, experts: dict,
                activation: str = "swiglu") -> torch.Tensor:
    """The per-expert FFN on dispatched slots [E, C, D] -> [E, C, D]:
    batched matmuls, bias-free, so an empty slot stays zero."""
    return _ffn(expert_in, experts["w_up"], experts["w_down"],
                experts.get("w_gate"), activation)


def moe_ffn(x: torch.Tensor, gate_w: torch.Tensor, experts: dict, *,
            k: int = 2, capacity_factor: float = 1.0, min_capacity: int = 4,
            activation: str = "swiglu", normalize_topk: bool = True,
            constrain: Callable | None = None, drop_tokens: bool = True,
            dispatcher: Callable | None = None,
            metrics_hook: Callable | None = None):
    """The MoE FFN of a [B, S, D] block input: (out [B, S, D], aux_loss).

    ``experts``: {"w_up": [E, D, F], "w_down": [E, F, D], ("w_gate": [E, D,
    F])}. The function of JAX's dispatch and combine einsums, in index
    form: every kept choice copies its token into its (expert, slot) row,
    the experts run on [E, C, D], and each token adds its choices' rows
    times their gate weights (in x's dtype, as JAX casts ``combine``).
    Static shapes and no host read, so a CUDA graph captures it.
    ``metrics_hook`` receives the routing metrics; ``constrain`` (a JAX
    sharding constraint) does nothing on one card."""
    if dispatcher is not None:
        raise NotImplementedError(EP_UNPORTED)
    b, s, d = x.shape
    n = b * s
    e = gate_w.shape[-1]
    xt = x.reshape(n, d)
    r = route(xt @ gate_w, k, capacity_factor, min_capacity, normalize_topk,
              drop_tokens)
    if metrics_hook is not None:
        metrics_hook(r.metrics)
    c = r.capacity
    # a dropped choice goes to row E*C, past the experts' rows
    row = torch.where(r.keep, r.idx * c + r.pos,
                      torch.full_like(r.idx, e * c)).reshape(-1)
    slots = x.new_zeros(e * c + 1, d).index_put(
        (row,), xt[:, None, :].expand(n, k, d).reshape(n * k, d))
    h = _expert_ffn(slots[:e * c].reshape(e, c, d), experts, activation)
    h = torch.cat([h.reshape(e * c, d), h.new_zeros(1, d)])
    picked = h[row].reshape(n, k, d)
    out = torch.bmm(r.gate.to(x.dtype)[:, None, :], picked)[:, 0]
    return out.reshape(b, s, d), r.aux


def moe_ffn_grouped(x: torch.Tensor, gate_w: torch.Tensor, experts: dict, *,
                    k: int = 2, activation: str = "swiglu",
                    normalize_topk: bool = True):
    """Serving dispatch without capacity (JAX ``moe_ffn_grouped``;
    reference: inference/v2 moe_gather + moe_gemm + moe_scatter): the N*k
    rows stably sorted by expert, the experts' products through one
    grouped GEMM a weight (``ops/grouped_gemm.py`` ``grouped_mm``, JAX's
    ``lax.ragged_dot``) over the groups' cumulative ends, then each
    token's rows times their gate weights summed. No padding and no
    drops. The offsets stay on the device (the count of sorted expert ids
    at or below each expert: a bincount's cumsum), so nothing is read
    back to the host and a CUDA graph captures the call. Returns (out [B,
    S, D], aux_loss), the aux of :func:`top_k_gating`."""
    b, s, d = x.shape
    n = b * s
    e = gate_w.shape[-1]
    xt = x.reshape(n, d)
    probs, topk_probs, topk_idx = _top_probs(xt @ gate_w, k, normalize_topk)
    ids, order = torch.sort(topk_idx.reshape(-1), stable=True)
    xs = xt[order // k]
    offsets = group_offsets(ids, e)
    if activation == "swiglu":
        h = L.silu(grouped_mm(xs, experts["w_gate"], offsets)) \
            * grouped_mm(xs, experts["w_up"], offsets)
    else:
        h = L.gelu(grouped_mm(xs, experts["w_up"], offsets))
    out_rows = grouped_mm(h, experts["w_down"], offsets).to(x.dtype)
    unsorted = torch.empty_like(out_rows).index_copy(0, order, out_rows)
    w = topk_probs.to(x.dtype)
    out = (unsorted.reshape(n, k, d) * w[..., None]).sum(1)
    aux, _ = _aux_loss(probs, topk_idx)
    return out.reshape(b, s, d), aux
