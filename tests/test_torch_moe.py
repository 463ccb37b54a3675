"""The port's moe/ (deepspeed_tpu_torch/moe/) against the JAX package's
deepspeed_tpu/moe/, on the CPU with seeded numpy inputs.

The counterparts of tests/test_moe.py on one device, each also held to
the JAX function on the same inputs:

- ``top_k_gating``: shapes and capacity, the top expert winning, drops at
  capacity, no-drop conservation; its combine and dispatch tables, aux
  and metrics equal JAX's (combine within 1 fp32 ulp, aux and the
  fractions within 1e-6: only rounding differs);
- the ``MoE`` module, with and without the PR-MoE residual expert, on
  JAX ``MoE.init``'s parameters;
- ``moe_ffn`` equal to ``moe_ffn_grouped`` at zero drop, and the grouped
  form equal to JAX's;
- the int8 experts bit for bit against JAX ``quantize_experts`` (fp32 and
  bf16), their error bound through the FFN, and the gateless dequantize
  round trip.

And three checks of the port's own:

- bf16 router logits with forced ties (duplicated router columns) route
  as JAX's ``lax.top_k`` does, ties to the lower expert;
- the index-form ``moe_ffn`` equals JAX's one-hot einsum form: outputs
  and the grads of x, the router and every expert weight within 1e-5 of
  the largest element of each (fp32; only summation order differs), with
  drops, without, top-1 to top-4, SwiGLU and GELU;
- ``dispatcher``, ``moe.enabled``, a narrow wire, the ``ep`` axis and
  router telemetry raise, naming their ROADMAP items.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.moe import MoE as JMoE
from deepspeed_tpu.moe import sharded_moe as J
from deepspeed_tpu_torch.moe import MoE
from deepspeed_tpu_torch.moe import sharded_moe as T
from deepspeed_tpu_torch.parallel.mesh import Topology, TopologyConfig
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

TOL = 1e-5


def _t(tree):
    """A nested dict of arrays as torch tensors."""
    return {k: _t(v) if isinstance(v, dict) else torch.tensor(np.asarray(v))
            for k, v in tree.items()}


def _inputs(seed, b=2, s=16, d=32, e=4, f=64, gated=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    gate_w = (0.1 * rng.standard_normal((d, e))).astype(np.float32)
    shapes = {"w_up": (e, d, f), "w_down": (e, f, d)}
    if gated:
        shapes["w_gate"] = (e, d, f)
    experts = {n: (0.1 * rng.standard_normal(sh)).astype(np.float32)
               for n, sh in shapes.items()}
    return x, gate_w, experts


def _rel(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max()
                 / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("n, e, k, cf", [(64, 8, 2, 1.0), (37, 4, 2, 1.25),
                                         (128, 60, 4, 1.0), (50, 8, 1, 0.5)])
def test_top_k_gating_shapes_and_capacity(n, e, k, cf):
    logits = np.random.default_rng(n).standard_normal((n, e)).astype(
        np.float32)
    combine, dispatch, aux, metrics = T.top_k_gating(
        torch.from_numpy(logits), k=k, capacity_factor=cf)
    c = combine.shape[2]
    assert combine.shape[:2] == (n, e)
    assert metrics["capacity"] == c == T.compute_capacity(n, e, k, cf)
    assert float(combine.sum((1, 2)).max()) <= 1.0 + 1e-5
    assert int(dispatch.sum((1, 2)).max()) <= k
    assert int(dispatch.sum(0).max()) <= 1          # no slot double-booked
    assert float(aux) > 0
    jc, jd, ja, jmet = J.top_k_gating(jnp.asarray(logits), k, cf)
    np.testing.assert_allclose(combine.numpy(), np.asarray(jc), rtol=0,
                               atol=1.2e-7)
    assert np.array_equal(dispatch.numpy(), np.asarray(jd))
    np.testing.assert_allclose(float(aux), float(ja), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["drop_fraction"]),
                               float(jmet["drop_fraction"]), rtol=1e-6)
    np.testing.assert_allclose(metrics["expert_load"].numpy(),
                               np.asarray(jmet["expert_load"]), rtol=1e-6)


def test_gating_routes_to_top_expert():
    logits = torch.full((8, 4), -10.0)
    pick = torch.arange(8) % 4
    logits[torch.arange(8), pick] = 10.0
    combine, _, _, metrics = T.top_k_gating(logits, k=1, capacity_factor=2.0)
    assert torch.equal(combine.sum(-1).argmax(-1), pick)
    assert float(metrics["drop_fraction"]) == 0.0


def test_capacity_drop():
    logits = torch.zeros(32, 4)
    logits[:, 0] = 10.0
    _, dispatch, _, metrics = T.top_k_gating(logits, k=1, capacity_factor=1.0,
                                             min_capacity=4)
    assert float(metrics["drop_fraction"]) > 0.5
    # the first tokens keep the slots, in token order
    assert dispatch[:8, 0].any(-1).all() and not dispatch[8:, 0].any()
    jm = J.top_k_gating(jnp.asarray(logits.numpy()), 1, 1.0, 4)[3]
    np.testing.assert_allclose(float(metrics["drop_fraction"]),
                               float(jm["drop_fraction"]), rtol=1e-6)


def test_no_drop_gating_conserves_tokens():
    logits = torch.zeros(32, 4)
    logits[:, 0] = 10.0
    combine, dispatch, _, metrics = T.top_k_gating(
        logits, k=1, capacity_factor=0.0, drop_tokens=False)
    assert dispatch.shape[2] >= 32
    assert int(dispatch.sum()) == 32
    assert float(metrics["drop_fraction"]) == 0.0
    sums = combine.sum((1, 2)).numpy()
    np.testing.assert_allclose(sums, sums[0] * np.ones(32), rtol=1e-6)
    assert sums[0] > 0.99


@pytest.mark.parametrize("residual", [False, True])
def test_moe_module_matches_jax(residual):
    kw = (dict(hidden_size=16, ffn_dim=32, num_experts=2, k=1,
               use_residual=True, capacity_factor=2.0) if residual else
          dict(hidden_size=32, ffn_dim=64, num_experts=4, k=2,
               capacity_factor=2.0))
    jmoe, moe = JMoE(**kw), MoE(**kw)
    params = jax.tree.map(np.asarray, jmoe.init(jax.random.PRNGKey(0)))
    if residual:
        # the residual's zero-initialized leaves perturbed, so its mixing
        # and down projection take part
        rng = np.random.default_rng(1)
        params["residual_mlp"] = {
            n: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            for n, v in params["residual_mlp"].items()}
    x = np.random.default_rng(2).standard_normal(
        (1 if residual else 2, 8 if residual else 16, kw["hidden_size"])
    ).astype(np.float32)
    ref, jaux = jmoe(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    got, aux = moe(_t(params), torch.from_numpy(x))
    assert got.shape == x.shape and torch.isfinite(got).all()
    assert _rel(got, ref) < TOL
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    # the port's own init: JAX's tree layout and shapes
    mine = moe.init(torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.structure(jax.tree.map(np.shape, params)) == \
        jax.tree.structure(jax.tree.map(lambda t: tuple(t.shape), mine))
    assert jax.tree.map(np.shape, params) == \
        jax.tree.map(lambda t: tuple(t.shape), mine)


def test_moe_ffn_matches_grouped_at_zero_drop():
    x, gate_w, experts = _inputs(7)
    tx, tg, te = torch.from_numpy(x), torch.from_numpy(gate_w), _t(experts)
    ref, _ = T.moe_ffn(tx, tg, te, k=2, capacity_factor=0.0,
                       drop_tokens=False, activation="swiglu")
    got, aux = T.moe_ffn_grouped(tx, tg, te, k=2, activation="swiglu")
    assert _rel(got, ref) < TOL
    jref, jaux = J.moe_ffn_grouped(jnp.asarray(x), jnp.asarray(gate_w),
                                   jax.tree.map(jnp.asarray, experts), k=2)
    assert _rel(got, jref) < TOL
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_experts_match_jax_and_bound_error(dtype):
    x, gate_w, experts = _inputs(11)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jq = J.quantize_experts({n: jnp.asarray(v, jdt)
                             for n, v in experts.items()}, jdt)
    tq = T.quantize_experts({n: torch.from_numpy(v).to(tdt)
                             for n, v in experts.items()}, tdt)
    assert set(tq) == set(jq)
    for n, v in jq.items():
        assert tq[n].dtype == (torch.int8 if n.endswith("_q") else tdt)
        assert np.array_equal(tq[n].float().numpy(),
                              np.asarray(v).astype(np.float32)), n
    jdq = J.dequantize_experts(jq, jdt)
    tdq = T.dequantize_experts(tq, tdt)
    for n, v in jdq.items():
        assert np.array_equal(tdq[n].float().numpy(),
                              np.asarray(v).astype(np.float32)), n
    # the error through the routed FFN stays within the int8 bound
    tx, tg = torch.from_numpy(x), torch.from_numpy(gate_w)
    ref, _ = T.moe_ffn(tx, tg, _t(experts), k=2, capacity_factor=0.0,
                       drop_tokens=False)
    got, _ = T.moe_ffn(tx, tg, T.dequantize_experts(
        T.quantize_experts(_t(experts)), torch.float32), k=2,
        capacity_factor=0.0, drop_tokens=False)
    assert _rel(got, ref) < 0.05


def test_dequantize_experts_gateless_roundtrip():
    _, _, experts = _inputs(0, gated=False)
    experts = _t(experts)
    q = T.quantize_experts(experts)
    assert "w_up_q" in q and "w_up" not in q
    deq = T.dequantize_experts(q, torch.float32)
    assert set(deq) == {"w_up", "w_down"}
    for k in experts:
        torch.testing.assert_close(deq[k], experts[k], rtol=0, atol=2e-3)
    assert T.dequantize_experts(experts, torch.float32) is experts


@pytest.mark.parametrize("k", [1, 2, 4])
def test_bf16_router_ties_route_as_jax(k):
    """Router columns duplicated in bf16: the logits tie exactly (and
    bf16 rounding ties more), so the k chosen experts and their capacity
    positions rest on the order among equal probabilities, the lower
    expert first as lax.top_k."""
    rng = np.random.default_rng(k)
    n, d, e = 96, 32, 16
    x = rng.standard_normal((n, d)).astype(np.float32)
    gate_w = (0.05 * rng.standard_normal((d, e))).astype(np.float32)
    gate_w[:, 1::2] = gate_w[:, 0::2]          # expert 2i+1 ties with 2i
    tl = torch.from_numpy(x).bfloat16() @ torch.from_numpy(gate_w).bfloat16()
    jl = jnp.asarray(x, jnp.bfloat16) @ jnp.asarray(gate_w, jnp.bfloat16)
    assert np.array_equal(tl.float().numpy(), np.asarray(jl, np.float32))
    ties = (tl[:, 0::2] == tl[:, 1::2]).all()
    assert bool(ties)
    jc, jd, _, jmet = J.top_k_gating(jl, k, 1.0)
    tc, td, _, tmet = T.top_k_gating(tl, k, 1.0)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=1.2e-7)
    np.testing.assert_allclose(float(tmet["drop_fraction"]),
                               float(jmet["drop_fraction"]), rtol=1e-6)
    # every tie went to the lower expert of its pair first
    r = T.route(tl, k)
    if k > 1:
        pairs = r.idx[:, 0] // 2 == r.idx[:, 1] // 2
        assert bool((r.idx[:, 0][pairs] < r.idx[:, 1][pairs]).all())


@pytest.mark.parametrize("k, cf, drop, act, norm", [
    (2, 1.0, True, "swiglu", True), (2, 0.0, False, "swiglu", True),
    (1, 1.25, True, "gelu", True), (4, 1.0, True, "swiglu", False),
    (4, 0.5, True, "gelu", False)])
def test_index_form_matches_jax_einsum_form(k, cf, drop, act, norm):
    x, gate_w, experts = _inputs(3 + k, b=2, s=24, e=8,
                                 gated=act == "swiglu")

    def jloss(x, g, ex):
        out, aux = J.moe_ffn(x, g, ex, k=k, capacity_factor=cf,
                             activation=act, normalize_topk=norm,
                             drop_tokens=drop)
        return jnp.sum(out * out) + aux, out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(x), jnp.asarray(gate_w),
        jax.tree.map(jnp.asarray, experts))
    tx = torch.tensor(x, requires_grad=True)
    tg = torch.tensor(gate_w, requires_grad=True)
    te = {n: torch.tensor(v, requires_grad=True) for n, v in experts.items()}
    out, aux = T.moe_ffn(tx, tg, te, k=k, capacity_factor=cf,
                         activation=act, normalize_topk=norm,
                         drop_tokens=drop)
    ((out * out).sum() + aux).backward()
    assert _rel(out.detach(), jout) < TOL
    assert _rel(tx.grad, jgrads[0]) < TOL
    assert _rel(tg.grad, jgrads[1]) < TOL
    for n in experts:
        assert _rel(te[n].grad, jgrads[2][n]) < TOL, n
    if drop and cf < 1.0:
        r = T.route(torch.from_numpy(x).reshape(-1, x.shape[-1])
                    @ torch.from_numpy(gate_w), k, cf)
        assert float(r.metrics["drop_fraction"]) > 0


def test_unported_moe_settings_name_their_roadmap_items():
    """Expert parallelism is ported: a dispatcher takes the routed rows
    (this rank's choices, routed on the global batch: here one rank, so
    all of them) and its output is the block's; the MoE layer hands its
    dispatcher on; ``moe.enabled`` and the narrow wires are accepted and
    the ep axis resolves. Router telemetry still raises, naming Slice G
    item 15."""
    x, gate_w, experts = _inputs(0)
    seen = {}

    class Dispatcher:
        token_world = 1

        def global_logits(self, logits):
            return logits

        def local_rows(self, t):
            return t

        def __call__(self, xt, routing, experts_, expert_fn):
            seen["rows"], seen["k"] = xt.shape[0], routing.idx.shape[1]
            return torch.zeros_like(xt)

    out, _ = T.moe_ffn(torch.from_numpy(x), torch.from_numpy(gate_w),
                       _t(experts), dispatcher=Dispatcher())
    assert seen == {"rows": x.shape[0] * x.shape[1], "k": 2}
    assert not out.any()
    layer = MoE(8, 16, 2, dispatcher=Dispatcher())
    out, _ = layer(MoE(8, 16, 2).init(device="cpu"), torch.ones(1, 2, 8))
    assert out.shape == (1, 2, 8) and not out.any()
    for moe in ({"enabled": True}, {"wire_dtype": "int8"},
                {"wire_dtype": "fp8", "rounding": "nearest"}):
        cfg = DeepSpeedConfig.from_any({"moe": moe})
        assert cfg.moe.wire_dtype == moe.get("wire_dtype", "fp32")
    with pytest.raises(NotImplementedError, match="Slice G item 15"):
        DeepSpeedConfig.from_any({"moe": {"router_telemetry": True}})
    with pytest.raises(ValueError, match="wire_dtype"):
        DeepSpeedConfig.from_any({"moe": {"wire_dtype": "int4"}})
    cfg = DeepSpeedConfig.from_any({"moe": {"enabled": False,
                                            "capacity_factor": 2.0,
                                            "min_capacity": 8,
                                            "rounding": "nearest"}})
    assert (cfg.moe.capacity_factor, cfg.moe.min_capacity) == (2.0, 8)
    topo = Topology(TopologyConfig(ep=2), 2)
    assert topo.expert_parallel_size == 2 and topo.data_parallel_size == 1
