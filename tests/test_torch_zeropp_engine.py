"""The port's engine on the ZeRO++ topology at world size 4 (mixed dp x
fsdp meshes, hpZ, MiCS, the hierarchical two-hop wire, the fp8 wire)
against the JAX engine on the CPU.

Four CPU ranks on gloo are spawned once for the file (a file store under
tmp_path, a deadline after which every rank is killed and the test
fails); they import torch and the port only. While they run, the JAX
engine trains here on conftest's 8 CPU devices, from the same GPT-2 tiny
weights (carried across as numpy), on meshes whose split counts are the
port's: the port's {"dp": 2, "fsdp": 2} against JAX {"dp": 4, "fsdp": 2};
hpZ and MiCS (size 2) on the port's 4 ranks against JAX {"dp": 2, "fsdp":
4} with hpZ's size (fsdp 2 x zps 2 either way); the two-hop wire on the
port's {"fsdp": 2, "zps": 2} against that mesh too, quantized against
JAX's two-hop wire on it; the fp8 wire on the port's {"fsdp": -1} against
JAX {"dp": 2, "fsdp": 4}. The exact wires compute one step whatever the
stage or the mesh (the mean over the global batch, only the summation
order moves), so one JAX engine a mesh holds every exact configuration
the port runs on it: five JAX engines, each compiled once (~13 s a
compile on one core), 3 steps each (batch 16, GA 2, AdamW 1e-3, clip 1.0,
fp32). Tolerances are stated at each comparison."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu as jds
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.parallel.mesh import reset_topology
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.linear import (LoRAConfig, LoRAModel,
                                        QuantizationConfig)
from deepspeed_tpu_torch.models import FunctionalModel, GPT2, Llama
from deepspeed_tpu_torch.models.convert import flatten_tree
from deepspeed_tpu_torch.runtime import engine as engine_mod
from test_torch_zeropp_topology import Ranks, worker_source

WORLD = 4
STEPS = 3
DEADLINE_S = 150

HIER_QUANT = {"stage": 3, "zero_hierarchical_allgather": True,
              "zero_quantized_weights": True,
              "zero_quantized_gradients": True,
              "zero_quantized_rounding": "nearest"}
FP8 = {"stage": 3, "zero_quantized_weights": True,
       "zero_quantized_gradients": True, "zero_quantized_dtype": "fp8",
       "zero_quantized_rounding": "nearest"}
LORA_MESH = {"dp": 2, "fsdp": 2}
# the JAX engines: name -> (mesh, zero block, masked batches)
JAX_RUNS = {
    "mixed": ({"dp": 4, "fsdp": 2}, {"stage": 3}, False),
    "mixed_uneven": ({"dp": 4, "fsdp": 2}, {"stage": 3}, True),
    "hpz": ({"dp": 2, "fsdp": 4}, {"stage": 3,
                                   "zero_hpz_partition_size": 2}, False),
    "hier_qwz_qgz": ({"dp": 2, "fsdp": 2, "zps": 2}, HIER_QUANT, False),
    "fp8": ({"dp": 2, "fsdp": 4}, FP8, False),
}
# the port at W = 4: name -> (mesh, zero block, masked batches, triple,
# the JAX run it is held to)
CASES = {
    "mixed_stage1": ({"dp": 2, "fsdp": 2}, {"stage": 1}, False, False,
                     "mixed"),
    "mixed_stage2": ({"dp": 2, "fsdp": 2}, {"stage": 2}, False, False,
                     "mixed"),
    "mixed_stage3": ({"dp": 2, "fsdp": 2}, {"stage": 3}, False, False,
                     "mixed"),
    "mixed_uneven": ({"dp": 2, "fsdp": 2}, {"stage": 3}, True, False,
                     "mixed_uneven"),
    "hpz": ({}, {"stage": 3, "zero_hpz_partition_size": 2}, False, False,
            "hpz"),
    "mics": ({}, {"stage": 3, "mics_shard_size": 2}, False, False, "hpz"),
    "hier_exact": ({"fsdp": 2, "zps": 2},
                   {"stage": 3, "zero_hierarchical_allgather": True},
                   False, False, "hpz"),
    "hier_qwz_qgz": ({"fsdp": 2, "zps": 2}, HIER_QUANT, False, False,
                     "hier_qwz_qgz"),
    "fp8": ({"fsdp": -1}, FP8, False, False, "fp8"),
    "hpz_triple": ({}, {"stage": 3, "zero_hpz_partition_size": 2}, False,
                   True, None),
}


def _batch(seed: int, rows: int = 16, seq: int = 16):
    tok = np.random.default_rng(seed).integers(0, 512, (rows, seq + 1))
    return tok[:, :-1], tok[:, 1:]


def _masked_batch(seed: int):
    """``_batch`` with uneven -100 targets over the ranks: in each
    micro-batch (8 rows, GA 2) the first rank's 2 rows keep 2 targets a
    row, the third rank's only 1, the others all 16."""
    tok, tgt = _batch(seed)
    tgt = tgt.copy()
    for micro in (0, 8):
        tgt[micro:micro + 2, 2:] = -100
        tgt[micro + 4:micro + 6, 1:] = -100
    return tok, tgt


def base_config(**zero):
    return {"train_batch_size": 16, "gradient_accumulation_steps": 2,
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
from deepspeed_tpu_torch.models import GPT2, FunctionalModel
from deepspeed_tpu_torch.linear import (LoRAConfig, LoRAModel,
                                        QuantizationConfig)
from deepspeed_tpu_torch.models import Llama
"""


def _w_engine(mesh, zero, tree, batches, triple, evals):
    cfg = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           "gradient_clipping": 1.0, "steps_per_print": 100,
           "zero_optimization": zero, "mesh": mesh}
    eng, *_ = ds.initialize(model=GPT2(size="tiny", device="cpu"),
                            config=cfg, model_parameters=tree)
    evals = [float(eng.eval_batch(batches[0]))] if evals else None
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
    if evals:
        evals.append(float(eng.eval_batch(batches[0])))
    plan = eng.plan
    return {"losses": losses, "norms": norms, "evals": evals,
            "stage3_counts": eng.stage3_counts(),
            "master": eng.consolidated_master_state_dict(),
            "params": {n: t.clone() for n, t in
                       eng.gathered_params().items()},
            "shard_numel": sum(t.numel()
                               for t in eng.master_state_dict().values()),
            "param_shard_numel": sum(
                t.numel() for n, t in eng.module_state_dict().items()
                if plan.param_dims[n] is not None),
            "splits": [(s.axes, s.world, s.index) for s in
                       (eng.state_split, eng.param_split)],
            "rest": eng._rest_group is not None,
            "hierarchy": eng._hierarchy is not None,
            "dp_rank": eng.dp_rank}


def _lora_and_loss_fn_models():
    """A LoRAModel over an int8 Llama tiny base (its adapters' b drawn, so
    the adapter path counts from the first step) and a FunctionalModel
    whose loss_fn is the largest row's mean NLL, not a mean over rows;
    the same weights on every rank and in the test process."""
    lora = LoRAModel(Llama(size="tiny", device="cpu"), LoRAConfig(lora_r=8),
                     QuantizationConfig(), seed=3)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, p in lora.params.items():
            if name.endswith("/b"):
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))

    def init(gen):
        return {"embed": torch.randn(512, 16, generator=gen) * 0.5,
                "out": torch.randn(16, 512, generator=gen) * 0.5}

    def apply(params, tokens):
        return torch.tanh(params["embed"][tokens]) @ params["out"]

    def loss(params, batch):
        logits = apply(params, torch.as_tensor(batch[0])).float()
        nll = torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, torch.as_tensor(batch[1])[..., None])[..., 0]
        return nll.mean(-1).max()

    return {"lora": lora,
            "loss_fn": FunctionalModel(init, apply, loss, device="cpu")}


def _w_lora_loss_fn(mesh, batches):
    """Both models of ``_lora_and_loss_fn_models`` trained 3 steps at
    stage 3 on ``mesh`` (W = 1 without one): their losses, the
    consolidated trainable params and this rank's frozen bytes."""
    out = {}
    for name, model in _lora_and_loss_fn_models().items():
        cfg = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
               "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
               "gradient_clipping": 1.0, "steps_per_print": 100,
               "zero_optimization": {"stage": 3}}
        if mesh is not None:
            cfg["mesh"] = mesh
        eng, *_ = ds.initialize(model=model, config=cfg)
        losses = [float(eng.train_batch(b)) for b in batches]
        out[name] = {"losses": losses,
                     "master": eng.consolidated_master_state_dict(),
                     "frozen_bytes": (model.frozen_bytes()
                                      if name == "lora" else None)}
    return out


def _rank_main(rank, world, store, inputs_path, out_path):
    comm.init_distributed("gloo", init_method=f"file://{store}", rank=rank,
                          world_size=world)
    data = torch.load(inputs_path, weights_only=False)
    out = {"lora_loss_fn": _w_lora_loss_fn(data["lora_mesh"],
                                             data["batches"])}
    for name, (mesh, zero, masked, triple, _) in data["cases"].items():
        out[name] = _w_engine(mesh, zero, data["tree"],
                              data["masked" if masked else "batches"],
                              triple, evals=masked)
    torch.save(out, out_path)


@pytest.fixture(scope="module")
def jax_init():
    jm = JGPT2(size="tiny")
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, jax_init):
    """The four ranks, started before the JAX engines so both run at
    once."""
    d = tmp_path_factory.mktemp("zeropp_engine")
    src = worker_source(_WORKER_HEADER, _w_engine, _lora_and_loss_fn_models,
                        _w_lora_loss_fn, _rank_main)
    return Ranks(d, WORLD, src, {
        "cases": CASES, "tree": jax_init[1], "lora_mesh": LORA_MESH,
        "batches": [_batch(s) for s in range(STEPS)],
        "masked": [_masked_batch(s) for s in range(STEPS)]},
        deadline_s=DEADLINE_S)


def _jax_engine(jax_init, mesh, zero, make_batch, with_evals=False):
    """The JAX engine's losses, grad norms and final params; with
    ``with_evals``, eval_batch of the first batch before and after (its eval
    function is a compile of its own)."""
    jm, tree = jax_init
    eng, *_ = jds.initialize(
        model=jm, model_parameters=jax.tree.map(jnp.asarray, tree),
        config=dict(base_config(**zero), mesh=mesh))
    evals = [float(eng.eval_batch(make_batch(0)))] if with_evals else None
    losses, norms = [], []
    for s in range(STEPS):
        losses.append(float(eng.train_batch(make_batch(s))))
        norms.append(eng.get_global_grad_norm())
    if with_evals:
        evals.append(float(eng.eval_batch(make_batch(0))))
    reset_topology()
    return {"losses": losses, "norms": norms, "evals": evals,
            "params": flatten_tree(jax.tree.map(np.asarray,
                                                eng.state["params"]))}


@pytest.fixture(scope="module")
def jax_runs(spawned, jax_init):
    """Every JAX run, once (the ranks run meanwhile)."""
    return {name: _jax_engine(jax_init, mesh, zero,
                              _masked_batch if masked else _batch,
                              with_evals=masked)
            for name, (mesh, zero, masked) in JAX_RUNS.items()}


@pytest.fixture(scope="module")
def ranks(spawned, jax_runs):
    return spawned.results()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _param_err(got: dict, want: dict, start: dict) -> tuple[float, float]:
    moved = np.sqrt(sum(np.sum((want[n] - start[n]) ** 2) for n in want))
    err = np.sqrt(sum(np.sum((got[n].numpy() - want[n]) ** 2)
                      for n in want))
    return err, moved


# tolerances of tests/test_torch_zero3.py's engine test on the exact wire
# and qwZ (losses, norms: relative; params: of the norm of their change)
EXACT = dict(loss=1e-5, norm=1e-4, params=2e-4)
ENGINE_CASES = ["mixed_stage1", "mixed_stage2", "mixed_stage3",
                "mixed_uneven", "hpz", "mics", "hier_exact"]


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_engine_matches_jax_engine(case, ranks, jax_runs, jax_init):
    """Exact wires at W = 4 against the JAX engine on 8 devices with the
    same split counts: every loss within 1e-5 relative, the grad norm
    within 1e-4, the params after 3 steps within 2e-4 of the norm of
    their change (the tolerances of tests/test_torch_zero3.py); measured
    at most 1.5e-7, 4.2e-6 and 7.9e-5. On a mixed mesh the uneven -100
    targets (two ranks' rows keep 1-2 targets a row) weight each rank by
    the global count of valid targets, as JAX's mean over the global
    micro-batch; there eval_batch before and after is within 1e-5 too.
    Every rank holds the same consolidated master and only its
    shards."""
    want = jax_runs[CASES[case][-1]]
    start = flatten_tree(jax_init[1])
    for res in ranks:
        got = res[case]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=EXACT["loss"])
        np.testing.assert_allclose(got["norms"], want["norms"],
                                   rtol=EXACT["norm"])
        if want["evals"] is not None:
            np.testing.assert_allclose(got["evals"], want["evals"],
                                       rtol=EXACT["loss"])
        err, moved = _param_err(got["master"], want["params"], start)
        assert err <= EXACT["params"] * moved, (err, moved)
    for name, p in ranks[0][case]["master"].items():
        for res in ranks[1:]:
            assert torch.equal(p, res[case]["master"][name]), name
    total = sum(v.size for v in start.values())
    assert ranks[0][case]["shard_numel"] < 0.6 * total


def test_topology_of_each_case(ranks):
    """The splits each engine took: the mixed mesh shards over fsdp and
    all-reduces over dp; hpZ's params over zps (2) and its state over
    fsdp x zps (4); MiCS's both over zps with fsdp all-reduced; the
    two-hop wire on fsdp x zps with its hops; the batch chunk is the
    rank."""
    for r, res in enumerate(ranks):
        f, z = divmod(r, 2)
        assert res["mixed_stage3"]["splits"] == [(("fsdp",), 2, r % 2)] * 2
        assert res["mixed_stage3"]["rest"]
        assert res["hpz"]["splits"] == [(("fsdp", "zps"), 4, r),
                                        (("zps",), 2, z)]
        assert not res["hpz"]["rest"]
        assert res["mics"]["splits"] == [(("zps",), 2, z)] * 2
        assert res["mics"]["rest"]
        assert res["hier_qwz_qgz"]["hierarchy"]
        assert not res["hier_exact"]["rest"]
        for case in CASES:
            assert res[case]["dp_rank"] == r
        total = sum(t.numel() for t in res["hpz"]["master"].values())
        assert res["hpz"]["shard_numel"] < 0.35 * total
        assert res["hpz"]["param_shard_numel"] > 1.5 * res["fp8"][
            "param_shard_numel"]


def test_hierarchical_exact_wire_equals_the_one_hop_wire_on_jax(
        ranks, jax_runs):
    """The two-hop gather at full precision is the one-hop gather bit for
    bit, so the exact hierarchical run is the exact fsdp x zps run: its
    losses equal the JAX engine's within 1e-5 (above) and the mixed
    mesh's stage 3, which splits only 2 ways, within 1e-5 too."""
    for res in ranks:
        np.testing.assert_allclose(res["hier_exact"]["losses"],
                                   res["mixed_stage3"]["losses"], rtol=1e-5)


@pytest.mark.parametrize("case", ["hier_qwz_qgz", "fp8"])
def test_quantized_wires_track_jax(case, ranks, jax_runs, jax_init):
    """The two-hop int8 wire (qwZ + qgZ, nearest) and the fp8 wire against
    the JAX engine on the same wire: losses within 5e-4 relative, grad
    norms within 3e-3 and params within 0.2 of the norm of
    their change (tests/test_torch_zero3.py's qgZ tolerances for norms
    and params), losses falling. Not bit-level: JAX quantizes each of its
    8 devices' one-row gradients, the port each rank's two rows, so the
    gradient wire's codes differ (the gather's are JAX's, as the topology
    file shows). Measured on these inputs, two-hop / fp8: losses 4.8e-5 /
    3.2e-5, norms 1.0e-3 / 6.7e-4, params 0.111 / 0.088."""
    want = jax_runs[CASES[case][-1]]
    start = flatten_tree(jax_init[1])
    for res in ranks:
        got = res[case]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=5e-4)
        np.testing.assert_allclose(got["norms"], want["norms"], rtol=3e-3)
        err, moved = _param_err(got["master"], want["params"], start)
        assert err <= 0.2 * moved, (err, moved)
        assert got["losses"][-1] < got["losses"][0]


def test_triple_matches_train_batch_under_hpz(ranks):
    """forward/backward/step on the global micro-batches equals train_batch
    under hpZ at W = 4: the same losses within 1e-6 and params within
    2e-5."""
    for res in ranks:
        a, b = res["hpz"], res["hpz_triple"]
        np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-6)
        for name, p in a["master"].items():
            np.testing.assert_allclose(b["master"][name].numpy(), p.numpy(),
                                       atol=2e-5, rtol=2e-5, err_msg=name)


def test_lora_and_loss_fn_train_across_ranks(ranks):
    """A LoRAModel (int8 Llama tiny base, its base split over fsdp 2) and
    a model with its own loss_fn (not a mean over rows) train at W = 4 on
    the mixed mesh {"dp": 2, "fsdp": 2} at stage 3 on the exact wire:
    their losses within 1e-5 relative and their trainable params after 3
    steps within 2e-4 of the norm of their change of the port's own W = 1
    run on the same weights and batches (the file's exact-wire
    tolerances); each rank holds half the base, or less."""
    one = _w_lora_loss_fn(None, [_batch(s) for s in range(STEPS)])
    whole = one["lora"]["frozen_bytes"]
    for res in ranks:
        for name in ("lora", "loss_fn"):
            got, want = res["lora_loss_fn"][name], one[name]
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=EXACT["loss"])
            start = {n: p.detach().numpy() for n, p in
                     _lora_and_loss_fn_models()[name].params.items()}
            err, moved = _param_err(got["master"], {
                n: p.numpy() for n, p in want["master"].items()}, start)
            assert moved > 0 and err <= EXACT["params"] * moved, \
                (name, err, moved)
        assert res["lora_loss_fn"]["lora"]["frozen_bytes"] <= 0.55 * whole


def test_per_layer_gathers_on_every_exact_stage3_mesh(ranks):
    """Stage 3 on the exact wire gathers a layer at a time on the mixed,
    hpZ and MiCS meshes (train_batch and the triple): per micro-batch one
    gather of each layer in the forward and one in the backward, one
    reduction of each layer inside the backward, an eval_batch one gather
    a layer; at most two layers' gathered tensors alive at once. The
    ZeRO++ wires (two-hop, fp8) and stages 1-2 keep the whole gather."""
    layers = 2
    for res in ranks:
        for case in ("mixed_stage3", "mixed_uneven", "hpz", "mics",
                     "hpz_triple"):
            c = res[case]["stage3_counts"]
            micro = STEPS * 2
            evals = 2 if res[case]["evals"] else 0
            assert c["layers"] == layers, case
            assert c["layer_forward"] == (micro + evals) * layers, (case, c)
            assert c["layer_backward"] == micro * layers, (case, c)
            assert c["layer_reductions"] == micro * layers, (case, c)
            assert c["reductions_outside_backward"] == 0, (case, c)
            assert c["max_live_layers"] <= 2, (case, c)
            assert len(c["streamed"]) >= 6, (case, c)
        for case in ("mixed_stage1", "mixed_stage2", "hier_exact",
                     "hier_qwz_qgz", "fp8"):
            assert res[case]["stage3_counts"] is None, case


def test_fp8_wire_with_stochastic_rounding_warns(monkeypatch):
    """fp8 with the default stochastic rounding warns, as JAX does: the
    fp8 wire rounds by the cast."""
    warned = []
    monkeypatch.setattr(engine_mod.logger, "warning", warned.append)
    ds.initialize(model=GPT2(size="tiny", device="cpu"), config={
        "train_batch_size": 2, "zero_optimization": {
            "stage": 3, "zero_quantized_weights": True,
            "zero_quantized_dtype": "fp8"}})
    assert len(warned) == 1 and "fp8" in warned[0]
