"""The port's expert-parallel dispatch (deepspeed_tpu_torch: the ep mesh
axis of parallel/mesh.py and its groups, runtime/zero.py's ep split,
moe/dispatch.py's EpShardedDispatcher with global gating in
moe/sharded_moe.py moe_ffn, runtime/comm/moe_alltoall.py's exchange)
against the JAX package on the CPU.

Four CPU ranks on gloo are spawned once for the file (a deadline after
which every rank is killed and the test fails); they import torch and the
port only. Each runs ``moe_ffn`` with an ``EpShardedDispatcher`` on its
rows of one global batch and its ``E / ep`` experts, on four meshes:
fsdp 2 x ep 2 (a slow token axis), zps 2 x ep 2 (a fast one), ep 4 (no
token axis) and fsdp 2 x zps 2 with ep 1 (the two-hop wire), and on the
fp32, bf16, int8 (nearest and stochastic) and fp8 wires, with drops
(capacity factor 1.0) and without (``drop_tokens=False``). Its loss is
``sum(out * w) + 0.1 * aux / token_world`` (the aux is global: each token
rank keeps its share), so the ranks' gradients summed over the token
ranks are the global loss's. The JAX side runs here meanwhile: JAX
``moe_ffn`` with ``EpShardedDispatcher`` built on ``Mesh(devices8[:4]
.reshape(...), ("fsdp", "zps", "ep"))``, the same token world and expert
split, under ``jax.jit``, on the same global inputs from a numpy seed
(Mixtral "tiny" widths: d 64, 4 experts, F 128, top-2, swiglu).
Tolerances are stated at each comparison."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from deepspeed_tpu.models import Mixtral as JMixtral
from deepspeed_tpu.moe import dispatch as JD
from deepspeed_tpu.moe import sharded_moe as JM
from deepspeed_tpu.parallel.mesh import MeshTopology, \
    TopologyConfig as JTopologyConfig
from deepspeed_tpu.runtime.zero import ZeroShardingPlan as JPlan
from deepspeed_tpu_torch.models.convert import flatten_tree
from deepspeed_tpu_torch.moe import dispatch as TD
from deepspeed_tpu_torch.moe import sharded_moe as TM
from deepspeed_tpu_torch.parallel.mesh import AXIS_ORDER, Topology, \
    TopologyConfig
from deepspeed_tpu_torch.runtime.zero import ZeroShardingPlan, ep_split_dims
from test_torch_zeropp_topology import Ranks, _jax_groups, worker_source

WORLD = 4
DEADLINE_S = 110
B, S, D, E, F, K = 4, 8, 64, 4, 128, 2
AUX = 0.1
MESHES = {"fsdp2_ep2": {"fsdp": 2, "ep": 2}, "zps2_ep2": {"zps": 2, "ep": 2},
          "ep4": {"ep": 4}, "fsdp2_zps2": {"fsdp": 2, "zps": 2}}
WIRES = {"fp32": ("fp32", "nearest"), "bf16": ("bf16", "nearest"),
         "int8": ("int8", "nearest"), "int8_sr": ("int8", "stochastic"),
         "fp8": ("fp8", "nearest")}
# (mesh, wire, drops): fp32 with and without drops on every mesh, the
# other wires with drops on every mesh
CASES = [(m, "fp32", drops) for m in MESHES for drops in (True, False)] + [
    (m, w, True) for m in MESHES for w in WIRES if w != "fp32"]


def _case_name(case) -> str:
    m, w, drops = case
    return f"{m}-{w}-{'drops' if drops else 'nodrop'}"


def _inputs():
    rng = np.random.default_rng(11)

    def n(*shape, s=1.0):
        return (rng.standard_normal(shape) * np.float32(s)).astype(np.float32)

    return {"x": n(B, S, D), "router": n(D, E, s=0.3),
            "experts": {"w_gate": n(E, D, F, s=0.1), "w_up": n(E, D, F, s=0.1),
                        "w_down": n(E, F, D, s=0.1)},
            "w": n(B, S, D)}


def _route_kw(drops: bool) -> dict:
    return (dict(capacity_factor=1.0, drop_tokens=True) if drops
            else dict(capacity_factor=0.0, drop_tokens=False))


# ----------------------------------------------------------- the ranks
_WORKER_HEADER = """
import numpy as np
import torch
torch.set_num_threads(1)
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.moe import dispatch as TD
from deepspeed_tpu_torch.moe import sharded_moe as TM
from deepspeed_tpu_torch.parallel.mesh import BATCH_AXES, Topology, \\
    TopologyConfig
"""


def _w_case(rank, inputs, mesh, wire, rounding, route_kw, aux_coef):
    topo = Topology(TopologyConfig(**mesh), 4, rank)
    disp = TD.EpShardedDispatcher.for_topology(topo, wire_dtype=wire,
                                               rounding=rounding)
    t, ti = disp.token_world, disp.token_index
    rows = inputs["x"].shape[0] // t
    x = torch.from_numpy(inputs["x"][ti * rows:(ti + 1) * rows]).clone()
    w = torch.from_numpy(inputs["w"][ti * rows:(ti + 1) * rows])
    router = torch.from_numpy(inputs["router"]).clone()
    experts = {k: torch.from_numpy(v).chunk(disp.ep_world, 0)[
        disp.ep_index].clone() for k, v in inputs["experts"].items()}
    for p in [x, router, *experts.values()]:
        p.requires_grad_(True)
    with TD.moe_step(3):
        out, aux = TM.moe_ffn(x, router, experts, k=2, activation="swiglu",
                              dispatcher=disp, **route_kw)
        loss = (out * w).sum() + aux_coef * aux / t
        loss.backward()
    return {"out": out.detach(), "aux": float(aux), "x": x.grad,
            "router": router.grad,
            "experts": {k: v.grad for k, v in experts.items()},
            "token_index": ti, "ep_index": disp.ep_index,
            "token_world": t, "ep_world": disp.ep_world}


def _rank_main(rank, world, store, inputs_path, out_path):
    comm.init_distributed("gloo", init_method=f"file://{store}", rank=rank,
                          world_size=world)
    data = torch.load(inputs_path, weights_only=False)
    out = {}
    for name, (mesh, wire, rounding, route_kw) in data["cases"].items():
        out[name] = _w_case(rank, data["inputs"], mesh, wire, rounding,
                            route_kw, data["aux"])
    torch.save(out, out_path)


@pytest.fixture(scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, one_torch_thread):
    d = tmp_path_factory.mktemp("moe_dispatch")
    cases = {_case_name(c): (MESHES[c[0]], *WIRES[c[1]], _route_kw(c[2]))
             for c in CASES}
    return Ranks(d, WORLD, worker_source(_WORKER_HEADER, _w_case,
                                         _rank_main),
                 {"inputs": _inputs(), "cases": cases, "aux": AUX},
                 deadline_s=DEADLINE_S)


# ------------------------------------------------------------ JAX side
def _jax_mesh(mesh: dict, devices8):
    sizes = [mesh.get(a, 1) for a in ("fsdp", "zps", "ep")]
    return Mesh(np.array(devices8[:4]).reshape(sizes), ("fsdp", "zps", "ep"))


def _jax_dispatcher(mesh: dict, wire: str, rounding: str, devices8):
    topo = types.SimpleNamespace(
        sizes={a: mesh.get(a, 1) for a in AXIS_ORDER},
        mesh=_jax_mesh(mesh, devices8))
    return JD.EpShardedDispatcher.for_topology(topo, wire_dtype=wire,
                                               rounding=rounding)


def _jax_case(inputs, mesh, wire, rounding, drops, devices8):
    disp = _jax_dispatcher(mesh, wire, rounding, devices8)
    kw = _route_kw(drops)

    def loss_fn(x, router, experts):
        with JD.moe_step(3):
            out, aux = JM.moe_ffn(x, router, experts, k=2,
                                  activation="swiglu", dispatcher=disp, **kw)
        return jnp.sum(out * inputs["w"]) + AUX * aux, (out, aux)

    with disp.mesh:
        (_, (out, aux)), grads = jax.jit(jax.value_and_grad(
            loss_fn, argnums=(0, 1, 2), has_aux=True))(
                inputs["x"], inputs["router"], inputs["experts"])
    return {"out": np.asarray(out), "aux": float(aux),
            "x": np.asarray(grads[0]), "router": np.asarray(grads[1]),
            "experts": {k: np.asarray(v) for k, v in grads[2].items()}}


@pytest.fixture(scope="module")
def jax_ref(spawned):
    """Every JAX case, once (the ranks run meanwhile), and the fp32
    single-device result without a dispatcher for each capacity mode."""
    devices8 = jax.devices()[:8]
    inputs = _inputs()
    out = {_case_name(c): _jax_case(inputs, MESHES[c[0]], *WIRES[c[1]],
                                    c[2], devices8) for c in CASES}
    for drops in (True, False):
        o, a = JM.moe_ffn(inputs["x"], inputs["router"], inputs["experts"],
                          k=2, activation="swiglu", **_route_kw(drops))
        out[f"plain-{drops}"] = {"out": np.asarray(o), "aux": float(a)}
    return out


@pytest.fixture(scope="module")
def ranks(spawned, jax_ref):
    return spawned.results()


def _assemble(ranks, name):
    """The global output from the ranks of ep coordinate 0 (rows in token
    order), and the token ranks' summed router and expert gradients (the
    experts of every ep coordinate, concatenated)."""
    res = [r[name] for r in ranks]
    t, ep = res[0]["token_world"], res[0]["ep_world"]
    by = {(r["token_index"], r["ep_index"]): r for r in res}
    out = torch.cat([by[(i, 0)]["out"] for i in range(t)]).numpy()
    gx = torch.cat([by[(i, 0)]["x"] for i in range(t)]).numpy()
    router = sum(by[(i, 0)]["router"] for i in range(t)).numpy()
    experts = {k: torch.cat([sum(by[(i, j)]["experts"][k] for i in range(t))
                             for j in range(ep)]).numpy()
               for k in res[0]["experts"]}
    return res, out.reshape(B, S, D), gx.reshape(B, S, D), router, experts


def _close(got, want, rtol, what):
    """|got - want| <= rtol * max|want| elementwise (a relative bound on
    the tensor's scale: gradients have elements near 0)."""
    scale = float(np.max(np.abs(want))) or 1.0
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * scale, (what, err, scale)


FP32_CASES = [c for c in CASES if c[1] == "fp32"]


@pytest.mark.parametrize("case", FP32_CASES, ids=_case_name)
def test_fp32_wire_matches_jax_outputs_aux_and_grads(case, ranks, jax_ref):
    """The exact wire on every mesh, with and without drops: the output
    within rtol 1e-5, atol 1e-6 of JAX's dispatched moe_ffn and of the
    single-device capacity form, the aux within 1e-6 (JAX's
    test_ep_sharded_dispatch_sum_parity), and the gradients of x, the
    router and every expert leaf within 1e-5 of their largest element of
    JAX's; the ep partners' x gradients and outputs bit-equal (they hold
    the same rows)."""
    name = _case_name(case)
    want = jax_ref[name]
    res, out, gx, router, experts = _assemble(ranks, name)
    np.testing.assert_allclose(out, want["out"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out, jax_ref[f"plain-{case[2]}"]["out"],
                               rtol=1e-5, atol=1e-6)
    for r in res:
        np.testing.assert_allclose(r["aux"], want["aux"], rtol=1e-6)
    _close(gx, want["x"], 1e-5, "x")
    _close(router, want["router"], 1e-5, "router")
    for k, g in experts.items():
        _close(g, want["experts"][k], 1e-5, k)
    for a in res:
        for b in res:
            if a["token_index"] == b["token_index"]:
                assert torch.equal(a["out"], b["out"])
                assert torch.equal(a["x"], b["x"])


NARROW = [c for c in CASES if c[1] in ("bf16", "int8", "fp8")]


@pytest.mark.parametrize("case", NARROW, ids=_case_name)
def test_narrow_wires_match_jax_same_wire(case, ranks, jax_ref):
    """The bf16, nearest int8 and fp8 wires against JAX's same wire: the
    output within 1e-5 relative of its largest element (the codes are
    JAX's: per-chunk 512-element blocks, the jitted reciprocal scale), the
    aux within 1e-6, and the straight-through gradients of x, the router
    and the experts within 1e-5 of their largest element (JAX's
    gradients on the same wire)."""
    name = _case_name(case)
    want = jax_ref[name]
    res, out, gx, router, experts = _assemble(ranks, name)
    _close(out, want["out"], 1e-5, "out")
    for r in res:
        np.testing.assert_allclose(r["aux"], want["aux"], rtol=1e-6)
    _close(gx, want["x"], 1e-5, "x")
    _close(router, want["router"], 1e-5, "router")
    for k, g in experts.items():
        _close(g, want["experts"][k], 1e-5, k)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_stochastic_int8_wire_tracks_fp32(mesh, ranks, jax_ref):
    """Stochastic int8 rounding (Philox noise here, threefry in JAX: the
    bits differ): the output within 0.05 of max|ref| of the fp32 result
    and sum(out^2) within 1e-2 of the fp32 one (JAX's bounds), and the
    gradients finite."""
    _, out, gx, router, experts = _assemble(ranks, f"{mesh}-int8_sr-drops")
    ref = jax_ref[f"{mesh}-fp32-drops"]["out"]
    assert np.max(np.abs(out - ref)) <= 0.05 * np.max(np.abs(ref))
    assert abs(np.sum(out * out) - np.sum(ref * ref)) <= 1e-2 * np.sum(
        ref * ref)
    assert all(np.isfinite(g).all() for g in [gx, router,
                                              *experts.values()])


def test_global_gating_keeps_other_tokens_than_per_rank_gating():
    """With drops, routing each token rank's rows on its own would keep
    other tokens than routing the global batch (capacity from the global
    count, positions in global token order): on these inputs and fsdp 2,
    the kept choices differ, so the fp32 parity above holds global
    gating."""
    inputs = _inputs()
    xt = torch.from_numpy(inputs["x"]).reshape(-1, D)
    logits = xt @ torch.from_numpy(inputs["router"])
    kw = _route_kw(True)
    glob = TM.route(logits, 2, kw["capacity_factor"])
    half = logits.shape[0] // 2
    per = [TM.route(logits[i * half:(i + 1) * half], 2, kw["capacity_factor"])
           for i in range(2)]
    kept_global = glob.keep
    kept_local = torch.cat([r.keep for r in per])
    assert not torch.equal(kept_global, kept_local)


# ---------------------------------------------------- mesh, plan, reasons
EP_MESHES = [({"fsdp": 2, "ep": 2}, 4), ({"zps": 2, "ep": 2}, 4),
             ({"ep": 4}, 4), ({"dp": 2, "fsdp": 2, "ep": 2}, 8),
             ({"fsdp": 2, "zps": 2, "ep": 2}, 8)]


@pytest.mark.parametrize("mesh, n", EP_MESHES)
def test_ep_mesh_coordinates_and_expert_groups_match_jax(mesh, n, devices8):
    """Rank r sits where JAX's MeshTopology puts device r on a mesh with
    ep (between zps and sp), and the expert-parallel (ep) and the
    expert-data-parallel (batch) groups hold the device ids that JAX's
    array groups over those axes; ep partners share a batch index."""
    devs = devices8[:n]
    jt = MeshTopology(JTopologyConfig(**mesh), devices=devs)
    topo = Topology(TopologyConfig(**mesh), n)
    assert topo.sizes == jt.sizes
    assert topo.expert_parallel_size == jt.expert_parallel_size
    ids = np.vectorize(lambda d: d.id)(jt.mesh.devices)
    for r in range(n):
        pos = np.argwhere(ids == devs[r].id)[0]
        assert topo.coordinates(r) == dict(zip(AXIS_ORDER, map(int, pos)))
    for axes in (("ep",), ("dp", "fsdp", "zps")):
        assert topo.group_ranks(axes) == _jax_groups(jt.mesh.devices, axes)
    for group in topo.group_ranks(("ep",)):
        assert len({topo.axis_index(("dp", "fsdp", "zps"), r)
                    for r in group}) == 1


def _split_dims(spec):
    """(the dim carrying ep, the dim carrying a ZeRO axis) of a spec."""
    ep = zero = None
    for d, e in enumerate(spec):
        axes = e if isinstance(e, tuple) else (e,)
        if "ep" in axes:
            ep = d
        if any(a in ("fsdp", "zps") for a in axes if a):
            zero = d
    return ep, zero


@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("mesh, n", EP_MESHES)
def test_plan_ep_and_zero_dims_match_jax(mesh, n, stage, devices8):
    """Per leaf and tree, the (ep dim, ZeRO dim) of the port's plan equal
    JAX's ZeroShardingPlan specs over Mixtral tiny's partition rules: the
    experts split over ep on dim 1 and ZeRO on the largest remaining
    divisible dim, every other leaf as without ep."""
    jm = JMixtral(size="tiny")
    abstract = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jt = MeshTopology(JTopologyConfig(**mesh), devices=devices8[:n])
    jplan = JPlan(stage, jt.mesh, jm.partition_rules(), abstract)
    shapes = {k: tuple(v.shape) for k, v in flatten_tree(abstract).items()}
    topo = Topology(TopologyConfig(**mesh), n)
    from deepspeed_tpu_torch.models import Mixtral
    rules = Mixtral(size="tiny", device="meta").partition_rules()
    ep = topo.sizes["ep"]
    plan = ZeroShardingPlan(stage, topo.fsdp_size, shapes,
                            inner=topo.sizes["zps"], ep=ep,
                            ep_dims=ep_split_dims(rules, shapes, ep))
    for specs, dims in ((jplan.param_specs, plan.param_dims),
                        (jplan.grad_specs, plan.grad_dims),
                        (jplan.master_specs, plan.master_dims)):
        for name, spec in flatten_tree(specs).items():
            assert _split_dims(spec) == (plan.ep_dims.get(name),
                                         dims[name]), name
    for name, dim in plan.ep_dims.items():
        assert plan.shapes[name][dim] * ep == shapes[name][dim]


@pytest.mark.parametrize("sizes, experts", [
    ({"ep": 2}, 4), ({"ep": 3}, 4), ({"ep": 2}, 0), ({"tp": 2}, 4),
    ({"sp": 2}, 4), ({"pp": 2}, 4), ({}, 4)])
def test_dispatcher_unsupported_reason_matches_jax(sizes, experts):
    """The same reason (or None) as JAX's for each mesh and expert count."""
    topo = types.SimpleNamespace(sizes={a: sizes.get(a, 1)
                                        for a in AXIS_ORDER})
    assert TD.dispatcher_unsupported_reason(topo, experts) == \
        JD.dispatcher_unsupported_reason(topo, experts)
