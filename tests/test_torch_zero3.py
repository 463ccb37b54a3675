"""The port's multi-rank ZeRO (deepspeed_tpu_torch: parallel/mesh.py,
runtime/zero.py ZeroShardingPlan, comm/comm.py, ops/quantization.py
quantized_all_gather, runtime/comm/coalesced_collectives.py
quantized_reduce_scatter, runtime/zeropp.py and the engine at world size
2) against the JAX package on the CPU.

The plan is held to the JAX ``ZeroShardingPlan`` on 2- and 4-device
sub-meshes of conftest's 8 CPU devices. The collectives and the engine run
in two CPU ranks on gloo, spawned once for the whole file (a file store
under tmp_path, a 120 s deadline after which both are killed and the test
fails); they import torch and the port only, and write their results to
files that the tests read. The JAX side runs here: the collectives in
``shard_map`` over ``Mesh(devices8[:2], ("fsdp",))`` on the same per-rank
inputs, the JAX engine on mesh {"dp": 4, "fsdp": 2}, whose params split in
2 as the port's do, from the same weights (carried across as numpy).
Tolerances are stated at each comparison."""

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
    TopologyConfig as JTopologyConfig
from deepspeed_tpu.runtime import zeropp as JZ
from deepspeed_tpu.runtime.comm import coalesced_collectives as JC
from deepspeed_tpu.runtime.zero import ZeroShardingPlan as JPlan
from deepspeed_tpu.utils.jax_compat import shard_map
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import GPT2
from deepspeed_tpu_torch.models.convert import flatten_tree
from deepspeed_tpu_torch.parallel.mesh import Topology, TopologyConfig
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.zero import ZeroShardingPlan

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 2
DEADLINE_S = 120
STEPS = 3


def _batch(seed: int, rows: int = 16, seq: int = 16):
    tok = np.random.default_rng(seed).integers(0, 512, (rows, seq + 1))
    return tok[:, :-1], tok[:, 1:]


def _masked_batch(seed: int):
    """``_batch`` with uneven -100 targets over the ranks: in each
    micro-batch (8 rows, GA 2) rank 0's rows (its first 4) keep only 2
    targets a row, rank 1's keep all 16."""
    tok, tgt = _batch(seed)
    tgt = tgt.copy()
    for micro in (0, 8):
        tgt[micro:micro + 4, 2:] = -100
    return tok, tgt


def base_config(**zero):
    """tests/test_zeropp.py's base_config (batch 16, GA 2, AdamW 1e-3,
    clip 1.0), fp32."""
    return {"train_batch_size": 16, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
            "gradient_clipping": 1.0, "steps_per_print": 100,
            "zero_optimization": zero}


# ------------------------------------------------------------------ plan
def _split_dim(spec):
    dims = [d for d, e in enumerate(spec)
            if e == "fsdp" or (isinstance(e, tuple) and "fsdp" in e)]
    assert len(dims) <= 1
    return dims[0] if dims else None


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_plan_matches_jax_zero_sharding_plan(stage, world, family, devices8):
    """Per leaf and stage, the split dim of params, grads and master is the
    JAX plan's fsdp dim on a W-device sub-mesh (tiny models: leaves below
    2048 elements stay whole, ties take the first dim)."""
    jm = {"gpt2": JGPT2, "llama": JLlama}[family](size="tiny")
    abstract = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    topo = MeshTopology(JTopologyConfig(fsdp=world),
                        devices=devices8[:world])
    jplan = JPlan(stage, topo.mesh, jm.partition_rules(), abstract)
    shapes = {n: tuple(v.shape) for n, v in flatten_tree(abstract).items()}
    plan = ZeroShardingPlan(stage, world, shapes)
    for specs, dims in ((jplan.param_specs, plan.param_dims),
                        (jplan.grad_specs, plan.grad_dims),
                        (jplan.master_specs, plan.master_dims)):
        want = {n: _split_dim(s) for n, s in flatten_tree(specs).items()}
        assert dims == want
    assert any(d is not None for d in plan.master_dims.values())
    assert plan.master_dims["final_norm/scale"] is None


def test_mesh_resolves_pure_meshes_and_refuses_the_rest():
    assert Topology(TopologyConfig(), 4).sizes["fsdp"] == 4
    assert Topology(TopologyConfig(dp=4), 4).data_parallel_size == 4
    assert Topology(TopologyConfig(dp=4), 4).fsdp_size == 1
    assert Topology(TopologyConfig(dp=2), 2).batch_axes() == ("dp",)
    for cfg, item in ((TopologyConfig(sp=2), "sequence"),
                      (TopologyConfig(tp=2), "tensor parallelism"),
                      (TopologyConfig(ep=2), "expert parallelism")):
        with pytest.raises(NotImplementedError, match=item):
            Topology(cfg, 4)
    with pytest.raises(ValueError, match="not divisible"):
        Topology(TopologyConfig(dp=3), 4)


@pytest.mark.parametrize("over, item", [
    ({"mesh": {"sp": 2}}, "sequence"), ({"mesh": {"ep": 2}}, "moe"),
    ({"mesh": {"pp": 2}}, "pipe"), ({"mesh": {"dcn": {"dp": 2}}},
                                    "multi-slice"),
    ({"mesh": {"tp": 2}}, "tensor parallelism"),
    ({"zero_optimization": {"offload_optimizer": {"device": "nvme"}}},
     "memory tiers"),
    ({"zero_optimization": {"offload_param": {"device": "cpu"}}},
     "memory tiers"),
    ({"zero_optimization": {"stage": 3, "offload_param": {"device": "nvme"}}},
     "layer-streamed"),
    ({"zero_optimization": {"stage": 3,
                            "offload_param": {"device": "cpu"}}},
     "layer-streamed"),
    ({"zero_optimization": {"offload_optimizer": {"device": "cpu"}}},
     "memory tiers")])
def test_unported_zero_and_meshes_raise_naming_roadmap(over, item):
    cfg = dict(base_config(), **over)
    if "zero_optimization" in over:
        cfg["zero_optimization"] = over["zero_optimization"]
    with pytest.raises(NotImplementedError, match="ROADMAP") as err:
        ds.initialize(model=GPT2(size="tiny", device="cpu"), config=cfg)
    assert item in str(err.value)


def test_ported_zero_blocks_are_accepted():
    for zero in ({"stage": 3, "zero_quantized_weights": True,
                  "zero_quantized_gradients": True},
                 {"stage": 2, "zero_quantized_gradients": True,
                  "zero_quantized_rounding": "nearest"}):
        cfg = DeepSpeedConfig.from_any(dict(base_config(**zero),
                                            mesh={"fsdp": -1}))
        assert cfg.zero_optimization.stage == zero["stage"]
    with pytest.raises(ValueError, match="rounding"):
        ds.initialize(model=GPT2(size="tiny", device="cpu"), config=dict(
            base_config(stage=3, zero_quantized_rounding="up")))


# ------------------------------------------------------------ world size 1
def _train(engine, steps=STEPS):
    return [float(engine.train_batch(_batch(s))) for s in range(steps)]


def test_world_size_one_zero3_with_zeropp_is_stage0_bit_for_bit():
    """At W = 1 nothing splits, so stage 3 with qwZ and qgZ computes what
    stage 0 does: losses and master bit for bit."""
    runs = []
    for zero in ({"stage": 0}, {"stage": 3, "zero_quantized_weights": True,
                                "zero_quantized_gradients": True}):
        eng, *_ = ds.initialize(model=GPT2(size="tiny", device="cpu"),
                                config=base_config(**zero))
        runs.append((_train(eng), eng.master_state_dict()))
    assert runs[0][0] == runs[1][0]
    for name, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][name]), name


# ------------------------------------------------ the two ranks (workers)
_WORKER_HEADER = """
import numpy as np
import torch
torch.set_num_threads(1)
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.models import GPT2
from deepspeed_tpu_torch.ops import quantization as TQ
from deepspeed_tpu_torch.runtime.comm import coalesced_collectives as TC
from deepspeed_tpu_torch.utils import groups
"""

COLLECTIVE_CASES = {
    # name: (kind, full shape, dim); gathers take full / W along dim
    "gather_dim0": ("gather", (2 * 48, 128), 0),
    "gather_dim1_tail": ("gather", (3, 2 * 700), 1),
    "gather_dim2": ("gather", (2, 64, 2 * 100), 2),
    "rs_dim0": ("rs", (2 * 1536,), 0),
    "rs_dim1_tail": ("rs", (5, 2 * 333), 1),
    "rs_flat_padded": ("rs_padded", (1000,), 0),
}
ENGINE_CASES = {
    "stage1": {"stage": 1}, "stage2": {"stage": 2}, "stage3": {"stage": 3},
    "qwz": {"stage": 3, "zero_quantized_weights": True},
    "qwz_qgz_nearest": {"stage": 3, "zero_quantized_weights": True,
                        "zero_quantized_gradients": True,
                        "zero_quantized_rounding": "nearest"},
    "qwz_qgz_stochastic": {"stage": 3, "zero_quantized_weights": True,
                           "zero_quantized_gradients": True},
}
TRIPLE_CASES = {"stage1": {"stage": 1},
                "qwz_qgz_stochastic": ENGINE_CASES["qwz_qgz_stochastic"]}
# the exact wire on uneven -100 targets: train_batch, and the triple at
# stage 3 (the JAX triple takes the global micro-batch's mean at stage >= 2;
# at stage < 2 it defers per-device grads, a mean of 8 device means)
UNEVEN_CASES = {"stage2": ({"stage": 2}, False), "stage3": ({"stage": 3},
                                                           False),
                "triple_stage3": ({"stage": 3}, True)}


def _collective_inputs():
    rng = np.random.default_rng(11)
    out = {}
    for name, (kind, shape, dim) in COLLECTIVE_CASES.items():
        if kind == "gather":
            out[name] = rng.standard_normal(shape).astype(np.float32)
        else:            # a full-size local gradient per rank
            out[name] = rng.standard_normal((WORLD,) + shape).astype(
                np.float32) * np.float32(0.01)
    return out


def _w_collectives(rank, world, inputs, cases):
    out = {}
    for name, (kind, shape, dim) in cases.items():
        x = torch.from_numpy(inputs[name])
        if kind == "gather":
            shard = x.chunk(world, dim)[rank].contiguous()
            q, s, _ = TQ.quantize_int8(shard)
            out[name] = {"q": q, "s": s,
                         "out": TQ.quantized_all_gather(shard, dim),
                         "exact": comm.all_gather(shard, axis=dim)}
        else:
            g = x[rank]
            if kind == "rs_padded":
                g = TC._flat_padded(g, world, TQ.QBLOCK)
            q, s = TQ.quantize_rows(comm.split_rows(g, world, dim))
            out[name] = {"q": q, "s": s,
                         "out": TC.quantized_reduce_scatter(g, dim),
                         "exact": comm.reduce_scatter(g, axis=dim)}
    return out


def _w_engine(zero, tree, batches, triple):
    cfg = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           "gradient_clipping": 1.0, "steps_per_print": 100,
           "zero_optimization": zero}
    eng, *_ = ds.initialize(model=GPT2(size="tiny", device="cpu"),
                            config=cfg, model_parameters=tree)
    first = {n: t.clone() for n, t in eng.gathered_params().items()}
    evals = [float(eng.eval_batch(batches[0]))]
    losses, norms = [], []
    for tokens, targets in batches:
        if triple:
            mb = tokens.shape[0] // 2
            for i in range(2):
                micro = (tokens[i * mb:(i + 1) * mb],
                         targets[i * mb:(i + 1) * mb])
                eng.backward(eng(micro))
            eng.step()
            losses.append(float(eng._last_metrics["loss"]))
        else:
            losses.append(float(eng.train_batch((tokens, targets))))
        norms.append(eng.get_global_grad_norm())
    evals.append(float(eng.eval_batch(batches[0])))
    return {"losses": losses, "norms": norms, "first_gather": first,
            "evals": evals,
            "master": eng.consolidated_master_state_dict(),
            "shard_numel": sum(t.numel()
                               for t in eng.master_state_dict().values())}


def _rank_main(rank, world, store, inputs_path, out_path):
    comm.init_distributed("gloo", init_method=f"file://{store}", rank=rank,
                          world_size=world)
    data = torch.load(inputs_path, weights_only=False)
    out = {"collectives": _w_collectives(rank, world, data["collectives"],
                                         data["collective_cases"]),
           "group": (groups.get_data_parallel_world_size(),
                     groups.get_data_parallel_rank())}
    for name, zero in data["engine_cases"].items():
        out[name] = _w_engine(zero, data["tree"], data["batches"], False)
    for name, zero in data["triple_cases"].items():
        out["triple_" + name] = _w_engine(zero, data["tree"],
                                          data["batches"], True)
    for name, (zero, triple) in data["uneven_cases"].items():
        out["uneven_" + name] = _w_engine(zero, data["tree"],
                                          data["masked_batches"], triple)
    torch.save(out, out_path)


@pytest.fixture(scope="module")
def jax_init():
    jm = JGPT2(size="tiny")
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_init):
    """Runs every scenario in two gloo ranks once; returns each rank's
    results."""
    d = tmp_path_factory.mktemp("zero3_ranks")
    torch.save({"collectives": _collective_inputs(),
                "collective_cases": COLLECTIVE_CASES,
                "engine_cases": ENGINE_CASES, "triple_cases": TRIPLE_CASES,
                "uneven_cases": UNEVEN_CASES, "tree": jax_init[1],
                "batches": [_batch(s) for s in range(STEPS)],
                "masked_batches": [_masked_batch(s) for s in range(STEPS)]},
               d / "inputs.pt")
    source = _WORKER_HEADER + "\n\n".join(
        inspect.getsource(f) for f in (_w_collectives, _w_engine,
                                       _rank_main))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    procs, logs = [], []
    for r in range(WORLD):
        call = (f"\n_rank_main({r}, {WORLD}, {str(d / 'store')!r}, "
                f"{str(d / 'inputs.pt')!r}, {str(d / f'rank{r}.pt')!r})\n")
        logs.append(d / f"rank{r}.log")
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", source + call], cwd=str(REPO),
                env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + DEADLINE_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
            p.wait()
    tails = "\n".join(f"--- rank {r}:\n{log.read_text()[-3000:]}"
                      for r, log in enumerate(logs))
    if hung:
        pytest.fail(f"ranks did not finish within {DEADLINE_S} s\n{tails}")
    if any(p.returncode for p in procs):
        pytest.fail(f"a rank failed\n{tails}")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


# --------------------------------------------------------- collectives
def _fsdp_spec(ndim: int, dim: int) -> PartitionSpec:
    return PartitionSpec(*([None] * dim + ["fsdp"]))


def _jax_collective(devices, kind, x, dim):
    mesh = Mesh(np.array(devices[:WORLD]), ("fsdp",))
    if kind == "gather":
        fn = shard_map(lambda xl: JQ.quantized_all_gather(xl, ("fsdp",), dim),
                       mesh=mesh, in_specs=_fsdp_spec(x.ndim, dim),
                       out_specs=PartitionSpec(), check_vma=False)
        return np.asarray(jax.jit(fn)(jnp.asarray(x)))
    if kind == "rs_padded":
        x = np.stack([np.asarray(JC._flat_padded(jnp.asarray(g), WORLD,
                                                 JQ.QBLOCK)) for g in x])

    def body(gl):
        return JC.quantized_reduce_scatter(gl[0], ("fsdp",), dim)[None]

    fn = shard_map(body, mesh=mesh, in_specs=PartitionSpec("fsdp"),
                   out_specs=PartitionSpec("fsdp"), check_vma=False)
    shards = np.asarray(jax.jit(fn)(jnp.asarray(x)))     # [W, *shard]
    return np.concatenate(list(shards), axis=dim)


def test_ranks_see_the_data_parallel_group(ranks):
    assert [r["group"] for r in ranks] == [(WORLD, 0), (WORLD, 1)]


@pytest.mark.parametrize("case", list(COLLECTIVE_CASES))
def test_collectives_match_jax_shard_map(case, ranks, devices8):
    """qwZ all-gather and qgZ reduce-scatter (nearest) at W = 2: each
    rank's int8 codes and scales equal those JAX's shard_map body computes
    on the same rank's input bit for bit; the gathered tensor and the
    concatenated reduced shards equal JAX's within 1e-6 (both sum two
    dequantized fp32 values). The exact collectives give the numpy
    concatenation and sum."""
    kind, shape, dim = COLLECTIVE_CASES[case]
    x = _collective_inputs()[case]
    want = _jax_collective(devices8, kind, x, dim)
    for r, res in enumerate(ranks):
        got = res["collectives"][case]
        if kind == "gather":
            shard = np.split(x, WORLD, axis=dim)[r]
            jq, js = jax.jit(lambda v: JQ.quantize_int8(v)[:2])(shard)
        else:
            g = x[r] if kind == "rs" else np.asarray(
                JC._flat_padded(jnp.asarray(x[r]), WORLD, JQ.QBLOCK))
            rows = np.stack(np.split(g, WORLD, axis=dim)).reshape(WORLD, -1)
            jq, js = jax.jit(lambda v: JC._quant_rows(
                v, "int8", "nearest", None))(rows)
        np.testing.assert_array_equal(got["q"].numpy().reshape(-1, 512),
                                      np.asarray(jq).reshape(-1, 512))
        np.testing.assert_array_equal(got["s"].numpy().reshape(-1),
                                      np.asarray(js).reshape(-1))
        if kind == "gather":
            np.testing.assert_allclose(got["out"].numpy(), want, rtol=0,
                                       atol=1e-6)
            np.testing.assert_array_equal(got["exact"].numpy(), x)
        else:
            both = [res2["collectives"][case] for res2 in ranks]
            cat = np.concatenate([b["out"].numpy() for b in both], axis=dim)
            np.testing.assert_allclose(cat, want, rtol=0, atol=1e-6)
            full = x.sum(0) if kind == "rs" else np.asarray(
                JC._flat_padded(jnp.asarray(x.sum(0)), WORLD, JQ.QBLOCK))
            exact = np.concatenate([b["exact"].numpy() for b in both],
                                   axis=dim)
            np.testing.assert_array_equal(exact, full)


# -------------------------------------------------------------- engine
def _jax_engine(jax_init, zero, steps=STEPS, make_batch=_batch,
                triple=False, evals=None):
    """The JAX engine on mesh {"dp": 4, "fsdp": 2}: per step train_batch
    or (``triple``) two forward/backward micro-batches and step(), whose
    loss is the mean of the two forward losses. ``evals`` (a list) gets
    eval_batch of the first batch before and after the steps."""
    jm, tree = jax_init
    eng, *_ = jds.initialize(
        model=jm, model_parameters=jax.tree.map(jnp.asarray, tree),
        config=dict(base_config(**zero), mesh={"dp": 4, "fsdp": 2}))
    if evals is not None:
        evals.append(float(eng.eval_batch(make_batch(0))))
    losses, norms = [], []
    for s in range(steps):
        tokens, targets = make_batch(s)
        if triple:
            micro = []
            for i in (0, 8):
                micro.append(float(eng((tokens[i:i + 8], targets[i:i + 8]))))
                eng.backward()
            eng.step()
            losses.append(float(np.mean(micro)))
        else:
            losses.append(float(eng.train_batch((tokens, targets))))
        norms.append(eng.get_global_grad_norm())
    if evals is not None:
        evals.append(float(eng.eval_batch(make_batch(0))))
    from deepspeed_tpu.parallel import mesh
    mesh.reset_topology()
    return losses, norms, flatten_tree(jax.tree.map(np.asarray,
                                                    eng.state["params"]))


def _param_err(got: dict, want: dict, start: dict) -> tuple[float, float]:
    moved = np.sqrt(sum(np.sum((want[n] - start[n]) ** 2) for n in want))
    err = np.sqrt(sum(np.sum((got[n].numpy() - want[n]) ** 2)
                      for n in want))
    return err, moved


@pytest.mark.parametrize("case", ["stage1", "stage2", "stage3", "qwz"])
def test_engine_matches_jax_engine(case, ranks, jax_init, devices8):
    """GPT-2 tiny, fp32, batch 16, GA 2, AdamW 1e-3, clip 1.0, 3 steps on
    fresh batches, the port on two gloo ranks and the JAX engine on 8
    devices (dp 4 x fsdp 2): every loss within 1e-5 relative and the grad
    norm within 1e-4 (tests/test_torch_train_engine.py's engine
    tolerances); after 3 steps the fp32 params within 2e-4 (4e-4 with qwZ)
    of the norm of their total change, not that file's 5e-5: on these
    inputs the JAX engine's own params end 3.6e-5 of that norm apart
    between its meshes {"fsdp": -1} and {"dp": 4, "fsdp": 2}, and the
    port's single-rank engine (within 5e-5 of the first) ends 7.1e-5 from
    the second, as Adam's first steps turn summation-order differences of
    near-zero grads into steps of up to lr. Measured at W = 2: 2.4e-5
    (stage 3), 7.8e-5 (stages 1-2), 1.5e-4 with qwZ, whose int8 codes flip
    where the two masters differ in the last bits. The JAX engine on a
    2-device mesh {"fsdp": 2}, which splits each batch over the port's 2
    shards (its initialize takes no sub-mesh: jax.devices narrowed to two
    of conftest's 8), ends no closer: 6.9e-5 (stage 1), 7.3e-5 (stage 2),
    2.1e-5 (stage 3), 1.5e-4 (qwZ). Both ranks hold the same consolidated
    params; each holds only its shards."""
    jl, jn, jparams = _jax_engine(jax_init, ENGINE_CASES[case])
    start = flatten_tree(jax_init[1])
    for res in ranks:
        got = res[case]
        np.testing.assert_allclose(got["losses"], jl, rtol=1e-5)
        np.testing.assert_allclose(got["norms"], jn, rtol=1e-4)
        err, moved = _param_err(got["master"], jparams, start)
        bound = 4e-4 if case == "qwz" else 2e-4
        assert err <= bound * moved, (err, moved)
    for name, p in ranks[0][case]["master"].items():
        assert torch.equal(p, ranks[1][case]["master"][name]), name
    total = sum(v.size for v in start.values())
    assert ranks[0][case]["shard_numel"] < 0.6 * total


def test_qwz_first_gather_is_jax_qwz_bit_for_bit(ranks, jax_init, devices8):
    """The first step's gathered weights: each leaf split in 2 with a shard
    of >= 4096 elements equals JAX's quantized_all_gather of the same
    shards of the same carried weights bit for bit; the other leaves are
    the weights themselves."""
    start = flatten_tree(jax_init[1])
    plan = ZeroShardingPlan(3, WORLD, {n: v.shape for n, v in start.items()})
    quantized = 0
    for name, full in start.items():
        dim = plan.param_dims[name]
        got = [r["qwz"]["first_gather"][name].numpy() for r in ranks]
        if dim is not None and full.size // WORLD >= JZ.MIN_QUANT_SIZE:
            want = _jax_collective(devices8, "gather", full, dim)
            quantized += 1
        else:
            want = full
        for g in got:
            np.testing.assert_array_equal(g, want, err_msg=name)
    assert quantized >= 4


@pytest.mark.parametrize("case", ["qwz_qgz_nearest", "qwz_qgz_stochastic"])
def test_qgz_trains_close_to_exact_wire(case, ranks):
    """qwZ + qgZ at W = 2: losses within 5e-2 relative of the exact wire's
    and falling (tests/test_zeropp.py:109-118: JAX quantizes over 8 batch
    shards, the port over 2 ranks, so only the collective test holds the
    wire bit for bit)."""
    for res in ranks:
        losses = res[case]["losses"]
        np.testing.assert_allclose(losses, res["stage3"]["losses"],
                                   rtol=5e-2)
        assert losses[-1] < losses[0]
        assert np.isfinite(losses).all()


def test_qgz_nearest_norms_and_params_near_the_exact_grad_wire(
        ranks, jax_init):
    """qwZ + qgZ (nearest) against qwZ with the exact gradient wire at
    W = 2: both gather the same weights at step 1 and differ by qgZ's int8
    rounding alone. Every step's grad norm within 3e-3 relative, and the
    params after 3 steps within 0.2 of the norm of their change. Measured
    on these inputs: 9.2e-4 and 0.074. Faults planted in the engine's qgZ
    wiring read far outside: the divide by the batch ranks skipped, norms
    0.62 off; the two ranks' chunks swapped, norms 6.9e-2 and params 1.17;
    each rank summing its own rows with no exchange, 4.0e-2 and 0.91."""
    start = flatten_tree(jax_init[1])
    for res in ranks:
        got, want = res["qwz_qgz_nearest"], res["qwz"]
        np.testing.assert_allclose(got["norms"], want["norms"], rtol=3e-3)
        err, moved = _param_err(got["master"], {
            n: p.numpy() for n, p in want["master"].items()}, start)
        assert err <= 0.2 * moved, (err, moved)


@pytest.mark.parametrize("case", list(TRIPLE_CASES))
def test_triple_matches_train_batch_across_ranks(case, ranks):
    """forward/backward/step on the global micro-batches equals train_batch
    at W = 2: the same losses and params (the same two halves; at stage 1
    the reduction waits for the boundary, at stage 3 the stochastic wire
    draws from the same step-seeded generators)."""
    for res in ranks:
        a, b = res[case], res["triple_" + case]
        np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-6)
        for name, p in a["master"].items():
            np.testing.assert_allclose(b["master"][name].numpy(), p.numpy(),
                                       atol=2e-5, rtol=2e-5, err_msg=name)


@pytest.mark.parametrize("case", list(UNEVEN_CASES))
def test_uneven_targets_match_jax_engine(case, ranks, jax_init, devices8):
    """The exact wire with -100 targets spread unevenly over the ranks
    (rank 0 keeps 2 targets a row, rank 1 all 16): each rank divides its
    summed NLL by the count of valid targets over both ranks and the
    grads are summed, as JAX differentiates the mean over every valid
    target of the global micro-batch. train_batch (stages 2, 3) and the
    triple (stage 3) against the JAX engine on {"dp": 4, "fsdp": 2}, and
    eval_batch before and after the steps, at test_engine_matches_jax_
    engine's tolerances. A mean of the two ranks' means reads the losses
    6e-3 and the grad norms 2.7 vs 1.7 apart on such batches."""
    zero, triple = UNEVEN_CASES[case]
    evals = []
    jl, jn, jparams = _jax_engine(jax_init, zero, make_batch=_masked_batch,
                                  triple=triple, evals=evals)
    start = flatten_tree(jax_init[1])
    for res in ranks:
        got = res["uneven_" + case]
        np.testing.assert_allclose(got["losses"], jl, rtol=1e-5)
        np.testing.assert_allclose(got["norms"], jn, rtol=1e-4)
        np.testing.assert_allclose(got["evals"], evals, rtol=1e-5)
        err, moved = _param_err(got["master"], jparams, start)
        assert err <= 2e-4 * moved, (err, moved)
