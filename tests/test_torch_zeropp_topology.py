"""The port's ZeRO++ topology (deepspeed_tpu_torch: parallel/mesh.py
coordinates and groups, utils/groups.py, runtime/zero.py under hpZ and
MiCS, ops/quantization.py's fp8 wire, runtime/zeropp.py's two-hop gather
and runtime/comm/coalesced_collectives.py's two-hop and list forms)
against the JAX package on the CPU.

The mesh and the plan are held to JAX's ``MeshTopology`` device arrays
and ``ZeroShardingPlan(hpz=..., mics=...)`` on 4- and 8-device meshes of
conftest's 8 CPU devices. The collectives run in four CPU ranks on gloo
(mesh fsdp 2 x zps 2), spawned once for the file under a deadline after
which every rank is killed and the test fails; the ranks import torch
and the port only and write their results to a file the tests read. The
JAX side runs here, in ``shard_map`` over ``Mesh(devices8[:4].reshape(2,
2), ("fsdp", "zps"))`` (or its 4 devices on one axis) on the same
per-rank inputs. Tolerances are stated at each comparison."""

import inspect
import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

import deepspeed_tpu as jds
from deepspeed_tpu.models import GPT2 as JGPT2, Llama as JLlama
from deepspeed_tpu.ops.pallas import quantization as JQ
from deepspeed_tpu.parallel.mesh import MeshTopology, \
    TopologyConfig as JTopologyConfig, reset_topology
from deepspeed_tpu.runtime import zeropp as JZ
from deepspeed_tpu.runtime.comm import coalesced_collectives as JC
from deepspeed_tpu.runtime.zero import ZeroShardingPlan as JPlan
from deepspeed_tpu.utils.jax_compat import shard_map
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import GPT2
from deepspeed_tpu_torch.models.convert import flatten_tree
from deepspeed_tpu_torch.ops import quantization as TQ
from deepspeed_tpu_torch.parallel.mesh import AXIS_ORDER, Topology, \
    TopologyConfig
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.zero import ZeroShardingPlan
from deepspeed_tpu_torch.runtime.zeropp import \
    hierarchical_allgather_unsupported_reason

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
DEADLINE_S = 120
MESH = {"fsdp": 2, "zps": 2}


# ------------------------------------------------------- spawning ranks
class Ranks:
    """``world`` gloo ranks started at once, each running ``source`` plus
    ``_rank_main(rank, world, store, inputs, out)``; :meth:`results` waits
    for them (killing every rank at the deadline) and loads what each
    wrote. Other work can run here meanwhile."""

    def __init__(self, d: pathlib.Path, world: int, source: str,
                 inputs: dict, deadline_s: float = DEADLINE_S):
        self.d, self.world, self.deadline_s = d, world, deadline_s
        torch.save(inputs, d / "inputs.pt")
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(REPO)] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        self.procs, self.logs = [], []
        for r in range(world):
            call = (f"\n_rank_main({r}, {world}, {str(d / 'store')!r}, "
                    f"{str(d / 'inputs.pt')!r}, {str(d / f'rank{r}.pt')!r})"
                    f"\n")
            self.logs.append(d / f"rank{r}.log")
            with open(self.logs[-1], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", source + call], cwd=str(REPO),
                    env=env, stdout=log, stderr=subprocess.STDOUT))
        self.start = time.monotonic()
        self._results = None

    def results(self) -> list:
        if self._results is not None:
            return self._results
        deadline = self.start + self.deadline_s
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            hung = [p for p in self.procs if p.poll() is None]
            for p in hung:
                p.kill()
                p.wait()
        tails = "\n".join(f"--- rank {r}:\n{log.read_text()[-3000:]}"
                          for r, log in enumerate(self.logs))
        if hung:
            pytest.fail(f"ranks did not finish within {self.deadline_s} s"
                        f"\n{tails}")
        if any(p.returncode for p in self.procs):
            pytest.fail(f"a rank failed\n{tails}")
        self._results = [torch.load(self.d / f"rank{r}.pt",
                                    weights_only=False)
                         for r in range(self.world)]
        return self._results


def worker_source(header: str, *fns) -> str:
    return header + "\n\n".join(inspect.getsource(f) for f in fns)


# ------------------------------------------------------------------ mesh
MESHES = [({"dp": 2, "fsdp": 2, "zps": 2}, 8), ({"fsdp": -1, "zps": 2}, 8),
          ({"dp": 4, "fsdp": 2}, 8), ({"dp": 2, "fsdp": 4}, 8),
          ({"fsdp": 2, "zps": 2}, 4), ({"dp": 2, "fsdp": 2}, 4)]
GROUP_AXES = [("dp", "fsdp", "zps"), ("fsdp", "zps"), ("zps",), ("fsdp",),
              ("dp",), ("dp", "fsdp")]


def _jax_groups(devices: np.ndarray, axes) -> list[list[int]]:
    """JAX's device array's groups over ``axes``: device ids, the other
    axes outer."""
    inner = [i for i, a in enumerate(AXIS_ORDER) if a in axes]
    outer = [i for i in range(len(AXIS_ORDER)) if i not in inner]
    ids = np.vectorize(lambda dev: dev.id)(devices)
    n = int(np.prod([ids.shape[i] for i in inner]))
    return ids.transpose(outer + inner).reshape(-1, n).tolist()


@pytest.mark.parametrize("mesh, n", MESHES)
def test_mesh_coordinates_and_groups_match_jax_device_array(mesh, n,
                                                            devices8):
    """Rank r sits where JAX's MeshTopology puts device r, its batch chunk
    and shard index are its place over the batch and fsdp x zps axes, and
    every axis group holds the device ids that JAX's array groups over
    those axes."""
    devs = devices8[:n]
    jt = MeshTopology(JTopologyConfig(**mesh), devices=devs)
    topo = Topology(TopologyConfig(**mesh), n)
    assert topo.sizes == jt.sizes
    for r in range(n):
        pos = np.argwhere(np.vectorize(lambda d: d.id)(jt.mesh.devices)
                          == devs[r].id)[0]
        assert topo.coordinates(r) == dict(zip(AXIS_ORDER, map(int, pos)))
        batch = [a for a in ("dp", "fsdp", "zps")]
        want = 0
        for a, c in zip(AXIS_ORDER, pos):
            if a in batch:
                want = want * jt.sizes[a] + int(c)
        assert topo.axis_index(batch, r) == want == r
    for axes in GROUP_AXES:
        got = topo.group_ranks(axes)
        assert got == _jax_groups(jt.mesh.devices, axes), axes
        for g in got:
            for i, r in enumerate(g):
                assert topo.axis_index(axes, r) == i


# ------------------------------------------------------------------ plan
def _split(spec) -> tuple:
    """(dim, live axes) of the one sharded dim of ``spec``, or (None,
    ())."""
    hits = [(d, e if isinstance(e, tuple) else (e,))
            for d, e in enumerate(spec) if e is not None]
    assert len(hits) <= 1
    return hits[0] if hits else (None, ())


PLAN_CASES = [(mesh, n, hpz, mics) for mesh, n in
              (({"fsdp": 2, "zps": 2}, 4), ({"dp": 2, "fsdp": 2, "zps": 2}, 8),
               ({"fsdp": 4, "zps": 2}, 8))
              for hpz, mics in ((False, False), (True, False),
                                (False, True))]


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("mesh, n, hpz, mics", PLAN_CASES)
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_plan_matches_jax_hpz_mics_plan(stage, mesh, n, hpz, mics, family,
                                        devices8):
    """Per leaf and tree, the split dim and its axes equal JAX's plan on
    the same mesh: hpZ's params over zps and the rest over fsdp x zps,
    MiCS's everything over zps; the rank counts are the axes' sizes."""
    jm = {"gpt2": JGPT2, "llama": JLlama}[family](size="tiny")
    abstract = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jt = MeshTopology(JTopologyConfig(**mesh), devices=devices8[:n])
    jplan = JPlan(stage, jt.mesh, jm.partition_rules(), abstract, hpz=hpz,
                  mics=mics)
    shapes = {k: tuple(v.shape) for k, v in flatten_tree(abstract).items()}
    topo = Topology(TopologyConfig(**mesh), n)
    plan = ZeroShardingPlan(stage, topo.fsdp_size, shapes,
                            inner=topo.sizes["zps"], hpz=hpz, mics=mics)
    trees = ((jplan.param_specs, plan.param_dims, plan.param_axes,
              plan.param_world),
             (jplan.grad_specs, plan.grad_dims, plan.state_axes
              if stage >= 2 else plan.param_axes, plan.state_world),
             (jplan.master_specs, plan.master_dims, plan.state_axes,
              plan.state_world))
    for specs, dims, axes, world in trees:
        for name, spec in flatten_tree(specs).items():
            dim, jaxes = _split(spec)
            assert dims[name] == dim, name
            if dim is not None:
                live = tuple(a for a in axes if topo.sizes[a] > 1)
                assert jaxes == live, name
                assert topo.axis_size(live) == world
    if hpz and stage == 3:
        assert plan.param_world == 2 and plan.state_world == topo.fsdp_size
        assert any(d is not None for d in plan.param_dims.values())


# --------------------------------------------------------- refusals
@pytest.mark.parametrize("zero, mesh, n", [
    ({"zero_hpz_partition_size": 2, "mics_shard_size": 2}, {}, 8),
    ({"zero_hpz_partition_size": 4}, {"fsdp": 2, "dp": 4}, 8),
    ({"zero_hierarchical_allgather": True}, {"fsdp": -1}, 8),
    ({"zero_hierarchical_allgather": True}, {"dp": 4, "zps": 2}, 8),
    ({"zero_hierarchical_allgather": True, "zero_hpz_partition_size": 2},
     {"fsdp": -1}, 8),
    ({"zero_hierarchical_allgather": True, "mics_shard_size": 2},
     {"fsdp": -1}, 8)])
def test_refusals_raise_jax_exception_types(zero, mesh, n, devices8):
    """Both hpZ and MiCS, an fsdp the sub-group does not divide, the
    two-hop wire without zps, without an outer fsdp, or under hpZ/MiCS:
    the JAX engine raises ValueError at initialize with a message the
    port's names as well (the port at W = 1 over the same mesh sizes:
    the checks read the config and the sizes before any rank)."""
    cfg = {"train_batch_size": 8, "zero_optimization": dict(zero, stage=3),
           "mesh": mesh}
    with pytest.raises(ValueError) as jerr:
        jds.initialize(model=JGPT2(size="tiny"), config=cfg)
    reset_topology()
    tcfg = DeepSpeedConfig.from_any(cfg)
    with pytest.raises(ValueError) as terr:
        sizes = tcfg.topology_config().resolve(n)
        z = tcfg.zero_optimization
        why = hierarchical_allgather_unsupported_reason(
            sizes, z.zero_hpz_partition_size > 1, z.mics_shard_size > 1)
        assert why is not None
        raise ValueError(why)
    assert str(terr.value).split(" ")[:3] == str(jerr.value).split(" ")[:3]


def test_plan_and_engine_refusals():
    """hpZ/MiCS on a plan without a zps axis, and the engine at W = 1 over
    meshes the world cannot hold, raise ValueError as JAX's do."""
    with pytest.raises(ValueError, match="zps axis"):
        ZeroShardingPlan(3, 4, {"w": (64, 64)}, inner=1, hpz=True)
    for zero in ({"zero_hpz_partition_size": 2},
                 {"zero_hierarchical_allgather": True}):
        with pytest.raises(ValueError):
            ds.initialize(model=GPT2(size="tiny", device="cpu"),
                          config={"train_batch_size": 2,
                                  "zero_optimization": dict(zero, stage=3)})
    assert DeepSpeedConfig.from_any({"zero_optimization": {
        "mics_shard_size": 2, "mics_hierarchical_params_gather": True},
        "mesh": {"fsdp": 4}}).topology_config() == TopologyConfig(
            fsdp=2, zps=2)


# --------------------------------------------------------------- fp8
@pytest.mark.parametrize("shape", [(512,), (3, 700), (2, 64, 100)])
def test_fp8_wire_codes_match_jax(shape):
    """The fp8 wire's e4m3 codes (as bytes) and scales equal JAX
    quantize_fp8's under jit (where the wire runs: XLA takes ``amax /
    448`` as ``amax * fl(1/448)``, 1 ulp off the eager quotient in 2 of
    these 5 blocks) bit for bit, per tensor and per row; the round trip
    equals JAX's dequantize_fp8."""
    x = (np.random.default_rng(5).standard_normal(shape)
         * np.float32(0.03)).astype(np.float32)
    x.reshape(-1)[:7] = [0, 448, -1e-3, 1e-30, 3.5, -600, 1e-8]
    q, s, meta = TQ.quantize_fp8(torch.from_numpy(x))
    jq, js = jax.jit(lambda v: JQ.quantize_fp8(v)[:2])(jnp.asarray(x))
    np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                  np.asarray(jq).view(np.uint8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TQ.dequantize_fp8(q, s, meta).numpy(),
        np.asarray(JQ.dequantize_fp8(jq, js, (x.shape, jnp.float32,
                                              x.size))))
    rows = x.reshape(2, -1) if x.size % 2 == 0 else x.reshape(1, -1)
    rq, rs = TQ.quantize_fp8_rows(torch.from_numpy(rows))
    jrq, jrs = jax.jit(jax.vmap(lambda r: JQ.quantize_fp8(r)[:2]))(
        jnp.asarray(rows))
    np.testing.assert_array_equal(rq.view(torch.uint8).numpy().reshape(-1),
                                  np.asarray(jrq).view(np.uint8).reshape(-1))
    np.testing.assert_array_equal(rs.numpy().reshape(-1),
                                  np.asarray(jrs).reshape(-1))


# --------------------------------------------------- the four ranks
_WORKER_HEADER = """
import numpy as np
import torch
torch.set_num_threads(1)
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.ops import quantization as TQ
from deepspeed_tpu_torch.parallel.mesh import Topology, TopologyConfig
from deepspeed_tpu_torch.runtime import zeropp as TZ
from deepspeed_tpu_torch.runtime.comm import coalesced_collectives as TC
from deepspeed_tpu_torch.utils import groups
"""

# name: (kind, full shape, dim, wire)
CASES = {
    "gather_dim0": ("gather", (4 * 48, 128), 0, "int8"),
    "gather_dim1_tail": ("gather", (3, 4 * 700), 1, "int8"),
    "gather_fp8_dim1": ("gather", (5, 4 * 600), 1, "fp8"),
    "rs_dim0": ("rs", (4 * 1536,), 0, "int8"),
    "rs_dim1_tail": ("rs", (5, 4 * 333), 1, "int8"),
    "rs_dim2": ("rs", (2, 3, 4 * 260), 2, "int8"),
    "rs_fp8_dim1": ("rs", (3, 4 * 700), 1, "fp8"),
}
LIST_SHAPES = [(1000,), (3, 700), (4096,)]


def _inputs():
    rng = np.random.default_rng(23)
    out = {}
    for name, (kind, shape, dim, wire) in CASES.items():
        if kind == "gather":
            out[name] = rng.standard_normal(shape).astype(np.float32)
        else:            # a full-size local gradient per rank
            out[name] = (rng.standard_normal((WORLD,) + shape)
                         * np.float32(0.01)).astype(np.float32)
    out["list"] = [(rng.standard_normal((WORLD,) + s) * np.float32(0.01))
                   .astype(np.float32) for s in LIST_SHAPES]
    return out


def _w_collectives(rank, inputs, cases):
    topo = Topology(TopologyConfig(fsdp=2, zps=2), 4, rank)
    shard = groups.axis_group(("fsdp", "zps"), topo)
    outer = groups.axis_group(("fsdp",), topo)
    inner = groups.axis_group(("zps",), topo)
    out = {"group_sizes": [comm.get_world_size(g)
                           for g in (shard, outer, inner)],
           "group_ranks": [comm.get_rank(g) for g in (shard, outer, inner)],
           "getters": [comm.get_world_size(g()) for g in (
               groups.get_data_parallel_group,
               groups.get_sharded_data_parallel_group,
               groups.get_zero_param_intra_parallel_group,
               groups.get_zero_outer_group,
               groups.get_data_parallel_replica_group)]}
    idx = topo.axis_index(("fsdp", "zps"))
    for name, (kind, shape, dim, wire) in cases.items():
        x = torch.from_numpy(inputs[name])
        if kind == "gather":
            piece = x.chunk(4, dim)[idx].contiguous()
            out[name] = {
                "one_hop": comm.all_gather(piece, group=shard, axis=dim),
                "two_hop": TZ.hierarchical_all_gather(piece, dim, outer,
                                                      inner),
                "quantized": TZ.hierarchical_all_gather(
                    piece, dim, outer, inner, quantized=True,
                    wire_dtype=wire),
                "one_hop_quantized": TQ.quantized_all_gather(
                    piece, dim, group=shard, wire_dtype=wire)}
            continue
        g = x[rank]
        hops = []
        real = TC._quant_rows

        def record(rows, *a, **k):
            q, s = real(rows, *a, **k)
            hops.append({"rows": rows.clone(), "q": q.clone(),
                         "s": s.clone()})
            return q, s

        TC._quant_rows = record
        try:
            two = TC.hierarchical_quantized_reduce_scatter(
                g, dim, outer, inner, wire_dtype=wire)
        finally:
            TC._quant_rows = real
        out[name] = {"two_hop": two, "hops": hops,
                     "one_hop": TC.quantized_reduce_scatter(
                         g, dim, group=shard, wire_dtype=wire),
                     "exact": comm.reduce_scatter(g, group=shard, axis=dim)}
    lists = [torch.from_numpy(t[rank]) for t in inputs["list"]]
    out["list"] = {"coalesced": TC.reduce_scatter_coalesced(lists, shard),
                   "quant": TC.all_to_all_quant_reduce(lists, shard)}
    return out


def _rank_main(rank, world, store, inputs_path, out_path):
    comm.init_distributed("gloo", init_method=f"file://{store}", rank=rank,
                          world_size=world)
    data = torch.load(inputs_path, weights_only=False)
    torch.save(_w_collectives(rank, data["inputs"], data["cases"]),
               out_path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, one_torch_thread):
    d = tmp_path_factory.mktemp("zeropp_topology")
    src = worker_source(_WORKER_HEADER, _w_collectives, _rank_main)
    return Ranks(d, WORLD, src, {"inputs": _inputs(), "cases": CASES}
                 ).results()


@pytest.fixture(scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh22(devices8):
    return Mesh(np.array(devices8[:4]).reshape(2, 2), ("fsdp", "zps"))


SPEC22 = ("fsdp", "zps")


def test_ranks_make_every_group(ranks):
    """Over fsdp 2 x zps 2: the shard group holds 4 ranks, the outer and
    inner 2; each rank's group rank is its index over the axes; the
    getters (default mesh: fsdp over the world) give 4, 4, 1, 4, 1."""
    for r, res in enumerate(ranks):
        assert res["group_sizes"] == [4, 2, 2]
        assert res["group_ranks"] == [r, r // 2, r % 2]
        assert res["getters"] == [4, 4, 1, 4, 1]


@pytest.mark.parametrize("case", [c for c in CASES
                                  if CASES[c][0] == "gather"])
def test_two_hop_gather_matches_one_hop_and_jax(case, ranks, devices8):
    """The two-hop gather at full precision equals the one-hop gather over
    fsdp x zps bit for bit, and both the input (JAX test_zeropp.py:207);
    quantized, the outer hop's codes gather within 1e-6 of JAX's
    hierarchical_all_gather(quantized=True) in shard_map."""
    kind, shape, dim, wire = CASES[case]
    x = _inputs()[case]
    spec = PartitionSpec(*([None] * dim + [SPEC22]))
    fn = shard_map(lambda xl: JZ.hierarchical_all_gather(
        xl, ("fsdp",), ("zps",), dim, quantized=True, wire_dtype=wire),
        mesh=_mesh22(devices8), in_specs=spec, out_specs=PartitionSpec(),
        check_vma=False)
    want = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    for res in ranks:
        got = res[case]
        assert torch.equal(got["two_hop"], got["one_hop"])
        np.testing.assert_array_equal(got["two_hop"].numpy(), x)
        np.testing.assert_allclose(got["quantized"].numpy(), want, rtol=0,
                                   atol=1e-6)
        err = np.abs(got["one_hop_quantized"].numpy() - x).max()
        assert err <= np.abs(x).max() * (0.07 if wire == "fp8" else 0.01)


def _jax_rows(g: np.ndarray, dim: int, n: int) -> np.ndarray:
    x = np.moveaxis(g, dim, 0)
    return x.reshape(n, -1)


def _deq(q, s, rows, c):
    v = np.asarray(q).astype(np.float32) * np.asarray(s)
    return v.reshape(rows, -1)[:, :c]


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][0] == "rs"])
def test_two_hop_qgz_matches_jax(case, ranks, devices8):
    """Two-hop qgZ (nearest): each rank's hop-1 codes and scales equal JAX
    ``_quant_rows`` on its [outer x inner, c] rows bit for bit, its hop-2
    codes equal ``_quant_rows`` on the partials JAX's arithmetic forms
    from every rank's hop-1 codes (the received pieces summed over the
    inner ranks) bit for bit; the shard is within 1e-6 of JAX's
    hierarchical_quantized_reduce_scatter in shard_map over fsdp 2 x
    zps 2 (both sum two dequantized fp32 values), and the exact
    reduce-scatter is numpy's sum."""
    kind, shape, dim, wire = CASES[case]
    g = _inputs()[case]
    quant = jax.jit(lambda v: JC._quant_rows(v, wire, "nearest", None))
    hop1 = [quant(jnp.asarray(_jax_rows(g[r], dim, 4))) for r in range(4)]
    c = _jax_rows(g[0], dim, 4).shape[1]
    deq1 = [_deq(q, s, 4, c).reshape(2, 2, c) for q, s in hop1]
    for r, res in enumerate(ranks):
        o, i = divmod(r, 2)
        h1, h2 = res[case]["hops"]
        np.testing.assert_array_equal(h1["rows"].numpy(),
                                      _jax_rows(g[r], dim, 4))
        for got, want in ((h1["q"], hop1[r][0]), (h1["s"], hop1[r][1])):
            np.testing.assert_array_equal(
                got.view(torch.uint8).numpy().reshape(-1) if wire == "fp8"
                else got.numpy().reshape(-1),
                np.asarray(want).view(np.uint8).reshape(-1) if wire == "fp8"
                else np.asarray(want).reshape(-1))
        partial = deq1[2 * o][:, i] + deq1[2 * o + 1][:, i]
        np.testing.assert_array_equal(h2["rows"].numpy(), partial)
        jq2, js2 = quant(jnp.asarray(partial))
        np.testing.assert_array_equal(h2["s"].numpy().reshape(-1),
                                      np.asarray(js2).reshape(-1))
        np.testing.assert_array_equal(
            h2["q"].view(torch.uint8).numpy().reshape(-1),
            np.asarray(jq2).view(np.uint8).reshape(-1))
    spec = PartitionSpec(SPEC22)

    def body(gl):
        return JC.hierarchical_quantized_reduce_scatter(
            gl[0], ("fsdp",), ("zps",), dim, wire_dtype=wire)[None]

    fn = shard_map(body, mesh=_mesh22(devices8), in_specs=spec,
                   out_specs=spec, check_vma=False)
    want = np.concatenate(list(np.asarray(jax.jit(fn)(jnp.asarray(g)))),
                          axis=dim)
    got = np.concatenate([res[case]["two_hop"].numpy() for res in ranks],
                         axis=dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    exact = np.concatenate([res[case]["exact"].numpy() for res in ranks],
                           axis=dim)
    np.testing.assert_allclose(exact, g.sum(0), rtol=1e-6, atol=1e-7)
    one = np.concatenate([res[case]["one_hop"].numpy() for res in ranks],
                         axis=dim)
    bound = np.abs(g).max() * (0.2 if wire == "fp8" else 0.03)
    assert np.abs(one - g.sum(0)).max() <= bound
    assert np.abs(got - g.sum(0)).max() <= bound


def test_list_forms_match_jax(ranks, devices8):
    """reduce_scatter_coalesced and all_to_all_quant_reduce (nearest) over
    the 4-rank shard group: each rank's flat partitions within 1e-6 of JAX
    ``coalesced_collectives``' list forms in shard_map over fsdp x zps."""
    lists = _inputs()["list"]
    spec = PartitionSpec(SPEC22)
    for key, fn in (("coalesced", JC.reduce_scatter_coalesced),
                    ("quant", JC.all_to_all_quant_reduce)):
        def body(*ts, fn=fn):
            return tuple(p[None] for p in fn([t[0] for t in ts],
                                              group=SPEC22))

        sm = shard_map(body, mesh=_mesh22(devices8),
                       in_specs=(spec,) * len(lists),
                       out_specs=(spec,) * len(lists), check_vma=False)
        want = [np.asarray(w) for w in
                jax.jit(sm)(*[jnp.asarray(t) for t in lists])]
        for r, res in enumerate(ranks):
            got = res["list"][key]
            assert len(got) == len(want)
            for t, w in zip(got, want):
                np.testing.assert_allclose(t.numpy(), w[r], rtol=0,
                                           atol=1e-6)
