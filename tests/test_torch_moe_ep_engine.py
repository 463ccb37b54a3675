"""The port's engine training MoE models across ranks (global gating, the
ep mesh axis, the dispatch exchange, ZeRO over an ep split, its
checkpoints) against the JAX engine on the CPU.

Four CPU ranks on gloo are spawned once for the file (a file store under
tmp_path, a deadline after which every rank is killed and the test
fails); they import torch and the port only. While they run, the JAX
engine trains here on conftest's 8 CPU devices from the same Mixtral
"tiny" weights (carried across as numpy), on meshes whose fsdp and ep
split counts are the port's: the port's fsdp 2 x ep 2 and zps 2 x ep 2
against JAX {"dp": 2, "fsdp": 2, "ep": 2} (its ep-sharded dispatcher;
the zps token axis shards as fsdp does), the port's ep 4
against JAX {"dp": 2, "ep": 4}, the port's fsdp 4 with ep 1 against JAX
{"dp": 2, "fsdp": 4} (XLA's implicit dispatch: the same function as the
port's fp32 exchange). The exact wire computes one step whatever the
stage (the mean over the global batch), so each JAX engine holds the
port's stages 1-3 on its mesh. Batch 8 x 16 tokens, AdamW 1e-3, clip
1.0, fp32, 3 steps. Tolerances are stated at each comparison."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu as jds
from deepspeed_tpu.models import Mixtral as JMixtral
from deepspeed_tpu.parallel.mesh import reset_topology
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import Mixtral, Qwen2MoE
from deepspeed_tpu_torch.models.convert import flatten_tree
from deepspeed_tpu_torch.runtime import engine as engine_mod
from test_torch_zeropp_topology import Ranks, worker_source

WORLD = 4
STEPS = 3
DEADLINE_S = 110

JAX_RUNS = {
    "ep2": {"dp": 2, "fsdp": 2, "ep": 2},
    "ep4": {"dp": 2, "ep": 4},
    "fsdp4": {"dp": 2, "fsdp": 4},
}
ZEROPP = {"stage": 3, "zero_quantized_weights": True,
          "zero_quantized_gradients": True}
# the port at W = 4: name -> (model, mesh, zero block, moe block, the JAX
# run it is held to)
CASES = {
    "ep2_stage1": ("mixtral", {"fsdp": 2, "ep": 2}, {"stage": 1}, None,
                   "ep2"),
    "ep2_stage2": ("mixtral", {"fsdp": 2, "ep": 2}, {"stage": 2}, None,
                   "ep2"),
    "ep2_stage3": ("mixtral", {"fsdp": 2, "ep": 2}, {"stage": 3}, None,
                   "ep2"),
    "zps2_ep2": ("mixtral", {"zps": 2, "ep": 2}, {"stage": 3}, None, "ep2"),
    "ep4": ("mixtral", {"ep": 4}, {"stage": 2}, None, "ep4"),
    "fsdp4": ("mixtral", {"fsdp": -1}, {"stage": 3}, None, "fsdp4"),
    "ep2_int8": ("mixtral", {"fsdp": 2, "ep": 2}, {"stage": 3},
                 {"wire_dtype": "int8", "rounding": "nearest"}, None),
    "two_hop_int8": ("mixtral", {"fsdp": 2, "zps": 2}, {"stage": 3},
                     {"enabled": True, "wire_dtype": "int8",
                      "rounding": "nearest"}, None),
    "ep2_zeropp": ("mixtral", {"fsdp": 2, "ep": 2}, ZEROPP, None, None),
    "qwen_ep2": ("qwen2_moe", {"fsdp": 2, "ep": 2}, {"stage": 3}, None,
                 None),
}


def _batch(seed: int, rows: int = 8, seq: int = 16):
    tok = np.random.default_rng(seed).integers(0, 512, (rows, seq + 1))
    return tok[:, :-1], tok[:, 1:]


def base_config(**zero):
    return {"train_batch_size": 8,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
            "gradient_clipping": 1.0, "steps_per_print": 100,
            "zero_optimization": zero}


# ------------------------------------------------------- the ranks
_WORKER_HEADER = """
import numpy as np
import torch
torch.set_num_threads(1)
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.models import Mixtral, Qwen2MoE
from deepspeed_tpu_torch.runtime import engine as engine_mod
"""


def _w_model(family):
    if family == "qwen2_moe":
        return Qwen2MoE(size="tiny", device="cpu", num_layers=2,
                        moe_num_shared_experts=1)
    return Mixtral(size="tiny", device="cpu")


def _w_engine(family, mesh, zero, moe, tree, batches):
    cfg = {"train_batch_size": 8,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           "gradient_clipping": 1.0, "steps_per_print": 100,
           "zero_optimization": zero, "mesh": mesh}
    if moe is not None:
        cfg["moe"] = moe
    warned = []
    real = engine_mod.logger.warning
    engine_mod.logger.warning = warned.append
    try:
        eng, *_ = ds.initialize(model=_w_model(family), config=cfg,
                                model_parameters=tree)
    finally:
        engine_mod.logger.warning = real
    losses = [float(eng.train_batch(b)) for b in batches]
    disp = eng._moe_dispatcher
    return {"losses": losses,
            "master": eng.consolidated_master_state_dict(),
            "own": {n: t.clone() for n, t in eng.master_state_dict().items()
                    if n not in eng.plan.ep_dims},
            "ep_index": eng.ep_split.index, "dp_rank": eng.dp_rank,
            "ep_dims": dict(eng.plan.ep_dims),
            "shard_numel": sum(t.numel()
                               for t in eng.master_state_dict().values()),
            "wire": disp.wire_dtype if disp is not None else None,
            "two_hop": disp is not None and disp.hierarchy is not None,
            "explicit_wire": eng.zero.explicit_wire, "warned": warned}


def _w_checkpoint(tree, batches, d):
    """Save at fsdp 2 x ep 2 after two steps and run the third; reload at
    W 4 on fsdp 4 (ep 1) and run the third step there."""
    cfg = {"train_batch_size": 8,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           "gradient_clipping": 1.0, "steps_per_print": 100,
           "zero_optimization": {"stage": 3}}
    a, *_ = ds.initialize(model=Mixtral(size="tiny", device="cpu"),
                          config=dict(cfg, mesh={"fsdp": 2, "ep": 2}),
                          model_parameters=tree)
    for b in batches[:2]:
        a.train_batch(b)
    a.save_checkpoint(d)
    saved = {n: t.clone() for n, t in
             a.consolidated_master_state_dict().items()}
    third = float(a.train_batch(batches[2]))
    b, *_ = ds.initialize(model=Mixtral(size="tiny", device="cpu"),
                          config=dict(cfg, mesh={"fsdp": -1},
                                      zero_optimization={"stage": 2}),
                          model_parameters=tree)
    b.load_checkpoint(d)
    loaded = {n: t.clone() for n, t in
              b.consolidated_master_state_dict().items()}
    return {"saved": saved, "third": third, "loaded": loaded,
            "resumed": float(b.train_batch(batches[2])),
            "steps": b.global_steps}


def _rank_main(rank, world, store, inputs_path, out_path):
    comm.init_distributed("gloo", init_method=f"file://{store}", rank=rank,
                          world_size=world)
    data = torch.load(inputs_path, weights_only=False)
    out = {}
    for name, (family, mesh, zero, moe, _) in data["cases"].items():
        out[name] = _w_engine(family, mesh, zero, moe,
                              data["trees"][family], data["batches"])
    out["checkpoint"] = _w_checkpoint(data["trees"]["mixtral"],
                                      data["batches"], data["ckpt"])
    torch.save(out, out_path)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_init():
    jm = JMixtral(size="tiny")
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _qwen_tree():
    model = _w_model("qwen2_moe")
    model.init_params(torch.Generator().manual_seed(7))
    return {n: p.detach().numpy().copy() for n, p in model.params.items()}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, jax_init):
    """The four ranks, started before the JAX engines so both run at
    once."""
    d = tmp_path_factory.mktemp("moe_ep_engine")
    src = worker_source(_WORKER_HEADER, _w_model, _w_engine, _w_checkpoint,
                        _rank_main)
    ranks = Ranks(d, WORLD, src, {
        "cases": CASES, "ckpt": str(d / "ckpt"),
        "trees": {"mixtral": jax_init[1], "qwen2_moe": _qwen_tree()},
        "batches": [_batch(s) for s in range(STEPS)]},
        deadline_s=DEADLINE_S)
    ranks.ckpt = d / "ckpt"
    return ranks


def _jax_engine(jax_init, mesh):
    jm, tree = jax_init
    eng, *_ = jds.initialize(
        model=jm, model_parameters=jax.tree.map(jnp.asarray, tree),
        config=dict(base_config(stage=3), mesh=mesh))
    losses = [float(eng.train_batch(_batch(s))) for s in range(STEPS)]
    reset_topology()
    return {"losses": losses,
            "params": flatten_tree(jax.tree.map(np.asarray,
                                                eng.state["params"]))}


@pytest.fixture(scope="module")
def jax_runs(spawned, jax_init):
    return {name: _jax_engine(jax_init, mesh)
            for name, mesh in JAX_RUNS.items()}


@pytest.fixture(scope="module")
def ranks(spawned, jax_runs):
    return spawned.results()


def _param_err(got: dict, want: dict, start: dict) -> tuple[float, float]:
    moved = np.sqrt(sum(np.sum((want[n] - start[n]) ** 2) for n in want))
    err = np.sqrt(sum(np.sum((np.asarray(got[n]) - want[n]) ** 2)
                      for n in want))
    return err, moved


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][-1]])
def test_engine_matches_jax_engine(case, ranks, jax_runs, jax_init):
    """fp32 exact wire at W = 4 against the JAX engine on 8 devices with
    the same fsdp and ep split counts: every loss within 2e-4 relative
    and the params after 3 steps within 2e-4 of the norm of their change
    (ROADMAP's multi-rank rule); every rank holds the same consolidated
    master."""
    want = jax_runs[CASES[case][-1]]
    start = flatten_tree(jax_init[1])
    for res in ranks:
        got = res[case]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4)
        err, moved = _param_err(
            {n: t.numpy() for n, t in got["master"].items()},
            want["params"], start)
        assert moved > 0 and err <= 2e-4 * moved, (err, moved)
    for name, p in ranks[0][case]["master"].items():
        for res in ranks[1:]:
            assert torch.equal(p, res[case]["master"][name]), name


def test_ep_partners_hold_bit_equal_non_expert_params(ranks):
    """Ranks that differ only in ep hold the same rows and the same shards
    of every non-expert leaf: after 3 steps those shards are bit-equal
    (the replicated tree has not split), and the experts are split over ep
    on dim 1."""
    for case, (_, mesh, _, _, _) in CASES.items():
        if mesh.get("ep", 1) == 1:
            continue
        by_dp = {}
        for res in ranks:
            by_dp.setdefault(res[case]["dp_rank"], []).append(res[case])
        for group in by_dp.values():
            assert sorted(r["ep_index"] for r in group) == list(
                range(mesh["ep"]))
            for r in group[1:]:
                for name, t in group[0]["own"].items():
                    assert torch.equal(t, r["own"][name]), (case, name)
        assert set(ranks[0][case]["ep_dims"]) == {
            "layers/experts/w_up", "layers/experts/w_gate",
            "layers/experts/w_down"}
        assert set(ranks[0][case]["ep_dims"].values()) == {1}


def test_int8_dispatch_wire_tracks_the_fp32_wire(ranks):
    """The int8 dispatch wire (nearest) at fsdp 2 x ep 2, stage 3, and its
    two-hop form on fsdp 2 x zps 2 (ep 1, ``moe.enabled``): losses within
    1e-2 of the fp32 wire's (JAX's bound) on the same global batch."""
    for res in ranks:
        want = res["ep2_stage3"]
        assert want["wire"] == "fp32" and not want["two_hop"]
        for case, two_hop in (("ep2_int8", False), ("two_hop_int8", True)):
            got = res[case]
            assert got["wire"] == "int8" and got["two_hop"] == two_hop
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=1e-2)


def test_zeropp_flags_on_an_ep_mesh_warn_and_run_the_exact_wire(ranks):
    """qwZ and qgZ on an ep mesh warn with JAX's reason and run the exact
    collectives, as JAX's engine does: the losses and the master equal the
    exact stage-3 run's bit for bit."""
    for res in ranks:
        got, want = res["ep2_zeropp"], res["ep2_stage3"]
        assert not got["explicit_wire"]
        assert any("ep=2" in w and "exact" in w for w in got["warned"])
        assert got["losses"] == want["losses"]
        for name, t in want["master"].items():
            assert torch.equal(got["master"][name], t), name


def test_qwen2_moe_across_ranks_matches_one_rank(ranks):
    """Qwen2-MoE tiny (its dense shared expert replicated over ep) at fsdp
    2 x ep 2, stage 3, against the port at W = 1 on the same weights and
    batches: losses within 2e-4 and params within 2e-4 of the norm of
    their change."""
    tree = _qwen_tree()
    eng, *_ = ds.initialize(model=Qwen2MoE(size="tiny", device="cpu",
                                           num_layers=2,
                                           moe_num_shared_experts=1),
                            config=base_config(stage=0),
                            model_parameters=tree)
    losses = [float(eng.train_batch(_batch(s))) for s in range(STEPS)]
    want = {n: t.numpy() for n, t in
            eng.consolidated_master_state_dict().items()}
    for res in ranks:
        got = res["qwen_ep2"]
        np.testing.assert_allclose(got["losses"], losses, rtol=2e-4)
        err, moved = _param_err({n: t.numpy() for n, t in
                                 got["master"].items()}, want, tree)
        assert moved > 0 and err <= 2e-4 * moved, (err, moved)


def test_checkpoint_saved_at_fsdp2_ep2_loads_at_w1_and_w4(ranks, spawned):
    """Saved at fsdp 2 x ep 2 (the experts' ep pieces, each gathered over
    its ZeRO ranks), loaded at W 4 on fsdp 4 (ep 1, stage 2) and here at W
    1: the fp32 state bit-equal to the saved one, and the resumed step's
    loss within 1e-5 of the uninterrupted run's third step."""
    for res in ranks:
        ck = res["checkpoint"]
        for name, t in ck["saved"].items():
            assert torch.equal(ck["loaded"][name], t), name
        assert ck["steps"] == 3
        np.testing.assert_allclose(ck["resumed"], ck["third"], rtol=1e-5)
    ck = ranks[0]["checkpoint"]
    eng, *_ = ds.initialize(model=Mixtral(size="tiny", device="cpu"),
                            config=base_config(stage=0))
    eng.load_checkpoint(str(spawned.ckpt))
    for name, t in eng.consolidated_master_state_dict().items():
        assert torch.equal(t, ck["saved"][name]), name
    resumed = float(eng.train_batch(_batch(2)))
    np.testing.assert_allclose(resumed, ck["third"], rtol=1e-5)


def test_ep_not_dividing_experts_warns_and_replicates(monkeypatch):
    """An ep that does not divide the experts: JAX's warning, the experts
    replicated over ep (no ep split), the exact fp32 exchange. Checked on
    the plan the engine would make (no ranks needed)."""
    from deepspeed_tpu_torch.moe.dispatch import dispatcher_unsupported_reason
    from deepspeed_tpu_torch.parallel.mesh import Topology, TopologyConfig
    from deepspeed_tpu_torch.runtime.zero import ep_split_dims
    topo = Topology(TopologyConfig(ep=3), 3)
    why = dispatcher_unsupported_reason(topo, 4)
    assert why == "num_experts=4 is not divisible by mesh.ep=3"
    m = Mixtral(size="tiny", device="meta")
    shapes = {n: tuple(p.shape) for n, p in m.params.items()}
    assert ep_split_dims(m.partition_rules(), shapes, 3) == {}
    warned = []
    monkeypatch.setattr(engine_mod.logger, "warning", warned.append)
    eng, *_ = ds.initialize(model=Mixtral(size="tiny", device="cpu"),
                            config=dict(base_config(stage=0),
                                        moe={"enabled": True}))
    assert eng._moe_dispatcher is not None and not warned
    assert eng._moe_dispatcher.token_world == 1
