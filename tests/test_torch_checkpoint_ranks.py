"""The port's checkpoints across ranks (runtime/checkpointing.py,
runtime/checkpoint_engine.py, checkpoint/universal.py,
utils/tensor_fragment.py): ZeRO stages 1, 2 and 3, and stage 3 with the
qwZ wire, saved at W = 2 and loaded at W = 1, and the reverse, by the
plain load (the index re-cuts the pieces) and through the universal
format; a resume at W = 2; the tag validation. At W = 4, an hpZ run
(parameters over zps, master over fsdp x zps) and a mixed dp x fsdp run
save, resume, and load at W = 1.

Two CPU ranks on gloo are spawned once for the whole file (a file store
under tmp_path, a 120 s deadline after which both are killed and the
test fails), as tests/test_torch_zero3.py does, and four for the W = 4
runs; they import torch and the port only. The W = 1 side runs here.
Every comparison is bit for bit: a load copies what was saved."""

import inspect
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.checkpoint import ds_to_universal
from deepspeed_tpu_torch.models import GPT2
from deepspeed_tpu_torch.utils import tensor_fragment as tf

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 2
DEADLINE_S = 120
CONFIG = {"train_batch_size": 8, "bf16": {"enabled": True},
          "optimizer": {"type": "FusedAdam",
                        "params": {"lr": 1e-3, "fused_kernel": True}},
          "gradient_clipping": 1.0, "steps_per_print": 100}
CASES = {"zero1": {"stage": 1}, "zero2": {"stage": 2},
         "zero3": {"stage": 3},
         "zero3_qwz": {"stage": 3, "zero_quantized_weights": True}}
FORMS = ("plain", "universal")
# W = 4: (zero block, mesh); a W = 1 engine loads them at stage 3
CASES4 = {"hpz": ({"stage": 3, "zero_hpz_partition_size": 2}, {}),
          "mixed": ({"stage": 3}, {"dp": 2, "fsdp": 2})}


def _batch(seed: int, rows: int = 8, seq: int = 16):
    tok = np.random.default_rng(seed).integers(0, 512, (rows, seq + 1))
    return tok[:, :-1], tok[:, 1:]


def _engine(zero, seed=1234, universal=False, mesh=None):
    cfg = dict(CONFIG, zero_optimization=zero, seed=seed,
               checkpoint={"load_universal": universal}, mesh=mesh or {})
    eng, *_ = ds.initialize(model=GPT2(size="tiny", device="cpu"),
                            config=cfg)
    return eng


def _copy(tensors: dict) -> dict:
    """Copies (a leaf no rank splits is a view of the live state)."""
    return {n: t.clone() for n, t in tensors.items()}


def _params(eng) -> dict:
    """The full compute-dtype parameters, gathered exactly (the qwZ wire
    of ``gathered_params`` quantizes)."""
    from deepspeed_tpu_torch.comm import comm
    dims = eng.plan.param_dims
    return {n: (comm.all_gather(p, axis=dims[n]) if dims[n] is not None
                else p.clone()) for n, p in eng.module_state_dict().items()}


def _moments(eng) -> dict:
    """The consolidated moments (tensor_fragment's getters: collectives
    at W = 2)."""
    return {(n, k): tf.safe_get_full_optimizer_state(eng, n, k)
            for n in eng.plan.shapes for k in ("exp_avg", "exp_avg_sq")}


def _load(zero, path, form):
    eng = _engine(zero, seed=77, universal=form == "universal")
    if form == "universal":
        eng.load_checkpoint(path, tag=".")
    else:
        eng.load_checkpoint(path)
    return eng


_WORKER_HEADER = """
import logging
import numpy as np
import torch
torch.set_num_threads(1)
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.models import GPT2
from deepspeed_tpu_torch.runtime import checkpointing
from deepspeed_tpu_torch.utils import tensor_fragment as tf
"""


def _w_case(zero, d):
    """At W = 2: train two steps, save, take the next step; a fresh engine
    loads and takes the same step; then the W = 1 checkpoint this test
    wrote, loaded plain and through universal."""
    a = _engine(zero)
    for i in range(2):
        a.train_batch(_batch(i))
    a.save_checkpoint(f"{d}/w2")
    out = {"master": _copy(a.consolidated_master_state_dict()),
           "moments": _moments(a)}
    ref = float(a.train_batch(_batch(2)))
    b = _engine(zero, seed=99)
    b.load_checkpoint(f"{d}/w2")
    out["resumed_master"] = _copy(b.consolidated_master_state_dict())
    out["resume_losses"] = (ref, float(b.train_batch(_batch(2))))
    out["resume_after"] = [e.consolidated_master_state_dict() for e in (a, b)]
    for form in FORMS:
        eng = _load(zero, f"{d}/w1" + ("_uni" if form == "universal"
                                        else ""), form)
        out[f"w1_{form}"] = {"master": eng.consolidated_master_state_dict(),
                             "moments": _moments(eng),
                             "params": _params(eng),
                             "step": int(eng._step),
                             "global_steps": eng.global_steps}
    return out


def _w_tags(d):
    """Ranks saving under different tags: "Fail" raises on every rank,
    "Warn" logs and saves."""
    out = {}
    eng = _engine({"stage": 2})
    tag = f"t{comm.get_rank()}"
    eng.config.checkpoint.tag_validation = "Fail"
    try:
        eng.save_checkpoint(f"{d}/tags", tag=tag)
        out["fail_raised"] = False
    except ValueError as e:
        out["fail_raised"] = "differs" in str(e)
    eng.config.checkpoint.tag_validation = "Warn"
    warned = []
    real = checkpointing.logger.warning
    checkpointing.logger.warning = warned.append
    try:
        eng.save_checkpoint(f"{d}/tags", tag=tag)
    finally:
        checkpointing.logger.warning = real
    out["warned"] = warned
    eng.config.checkpoint.tag_validation = "Ignore"
    eng.save_checkpoint(f"{d}/tags", tag="same")
    return out


def _w4_case(zero, mesh, d):
    """At W = 4: train two steps, save, take the next step; a fresh engine
    loads and takes the same step."""
    a = _engine(zero, mesh=mesh)
    for i in range(2):
        a.train_batch(_batch(i))
    a.save_checkpoint(f"{d}/w4")
    out = {"master": _copy(a.consolidated_master_state_dict()),
           "moments": _moments(a),
           "params": _copy(a.gathered_params())}
    ref = float(a.train_batch(_batch(2)))
    b = _engine(zero, seed=99, mesh=mesh)
    b.load_checkpoint(f"{d}/w4")
    out["resumed_master"] = _copy(b.consolidated_master_state_dict())
    out["resumed_params"] = _copy(b.gathered_params())
    out["resume_losses"] = (ref, float(b.train_batch(_batch(2))))
    out["resume_after"] = [e.consolidated_master_state_dict() for e in (a, b)]
    return out


def _rank_main(rank, world, store, d, cases):
    comm.init_distributed("gloo", init_method=f"file://{store}", rank=rank,
                          world_size=world)
    if world == 4:
        out = {name: _w4_case(zero, mesh, f"{d}/{name}")
               for name, (zero, mesh) in cases.items()}
    else:
        out = {name: _w_case(zero, f"{d}/{name}")
               for name, zero in cases.items()}
        out["tags"] = _w_tags(d)
    torch.save(out, f"{d}/rank{rank}.pt")


def _spawn(d, world, cases):
    """Every scenario in ``world`` gloo ranks at once; each rank's
    results."""
    source = _WORKER_HEADER + "\n\n".join(
        inspect.getsource(f) for f in (_batch, _engine, _copy, _params,
                                       _moments, _load, _w_case, _w4_case,
                                       _w_tags, _rank_main))
    source = f"CONFIG = {CONFIG!r}\nFORMS = {FORMS!r}\n" + source
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    procs, logs = [], []
    for r in range(world):
        call = (f"\n_rank_main({r}, {world}, {str(d / 'store')!r}, "
                f"{str(d)!r}, {cases!r})\n")
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
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The W = 1 runs and their checkpoints (written here first), then
    every W = 2 scenario in two gloo ranks at once."""
    d = tmp_path_factory.mktemp("ckpt_ranks")
    w1 = {}
    for name, zero in CASES.items():
        eng = _engine(zero)
        for i in range(2):
            eng.train_batch(_batch(i))
        eng.save_checkpoint(str(d / name / "w1"))
        ds_to_universal(str(d / name / "w1"), str(d / name / "w1_uni"))
        w1[name] = {"master": _copy(eng.consolidated_master_state_dict()),
                    "moments": _moments(eng),
                    "params": _params(eng)}
    ranks = _spawn(d, WORLD, CASES)
    for name in CASES:
        ds_to_universal(str(d / name / "w2"), str(d / name / "w2_uni"))
    return {"dir": d, "w1": w1, "ranks": ranks}


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
        else np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", list(CASES))
def test_saved_at_two_ranks_loads_at_one(runs, case, form):
    """The W = 2 checkpoint at W = 1: master and moments equal the
    consolidated ones the ranks had at the save, and the parameters are
    the master in bf16."""
    saved = runs["ranks"][0][case]
    path = runs["dir"] / case / ("w2_uni" if form == "universal" else "w2")
    eng = _load(CASES[case], str(path), form)
    assert _equal(eng.consolidated_master_state_dict(), saved["master"])
    assert _equal(_moments(eng), saved["moments"])
    assert int(eng._step) == 2 and eng.global_steps == 2
    assert _equal(_params(eng),
                  {n: m.bfloat16() for n, m in saved["master"].items()})


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", list(CASES))
def test_saved_at_one_rank_loads_at_two(runs, case, form):
    """The W = 1 checkpoint at W = 2, on both ranks: master, moments and
    parameters equal the W = 1 engine's; the step and counters resume."""
    want = runs["w1"][case]
    for rank in runs["ranks"]:
        got = rank[case][f"w1_{form}"]
        assert _equal(got["master"], want["master"])
        assert _equal(got["moments"], want["moments"])
        assert _equal(got["params"], want["params"])
        assert got["step"] == got["global_steps"] == 2


@pytest.mark.parametrize("case", list(CASES))
def test_resume_at_two_ranks_is_bit_equal(runs, case):
    """At W = 2 a fresh engine that loads the checkpoint holds the saved
    master and takes the next step as the run that did not stop."""
    for rank in runs["ranks"]:
        rec = rank[case]
        assert _equal(rec["resumed_master"], rec["master"])
        ref, resumed = rec["resume_losses"]
        assert ref == resumed
        assert _equal(*rec["resume_after"])
    files = sorted(os.listdir(runs["dir"] / case / "w2" / "global_step2" /
                              "state"))
    assert files == ["index.json", "rank0.safetensors", "rank1.safetensors"]


def test_tag_validation_across_ranks(runs):
    """Differing tags: "Fail" raises on every rank, "Warn" logs on every
    rank and saves; one tag under "Ignore" is ``latest``."""
    for rank in runs["ranks"]:
        tags = rank["tags"]
        assert tags["fail_raised"] is True
        assert len(tags["warned"]) == 1 and "differs" in tags["warned"][0]
    assert (runs["dir"] / "tags" / "latest").read_text() == "same"


@pytest.fixture(scope="module")
def runs4(tmp_path_factory):
    """The W = 4 runs (hpZ, mixed dp x fsdp) in four gloo ranks."""
    d = tmp_path_factory.mktemp("ckpt_ranks4")
    ranks = _spawn(d, 4, CASES4)
    for name in CASES4:
        ds_to_universal(str(d / name / "w4"), str(d / name / "w4_uni"))
    return {"dir": d, "ranks": ranks}


@pytest.mark.parametrize("case", list(CASES4))
def test_resume_at_four_ranks_is_bit_equal(runs4, case):
    """hpZ and a mixed dp x fsdp mesh at W = 4: a fresh engine that loads
    the checkpoint holds the saved master and parameters and takes the
    next step as the run that did not stop. Each piece is written once:
    hpZ's four master shards by their ranks (its parameter shards over
    zps by ranks 0 and 1), the mixed mesh's by its dp = 0 ranks."""
    for rank in runs4["ranks"]:
        rec = rank[case]
        assert _equal(rec["resumed_master"], rec["master"])
        assert _equal(rec["resumed_params"], rec["params"])
        ref, resumed = rec["resume_losses"]
        assert ref == resumed
        assert _equal(*rec["resume_after"])
    files = sorted(os.listdir(runs4["dir"] / case / "w4" / "global_step2" /
                              "state"))
    writers = 4 if case == "hpz" else 2
    assert files == ["index.json"] + [f"rank{r}.safetensors"
                                      for r in range(writers)]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", list(CASES4))
def test_saved_at_four_ranks_loads_at_one(runs4, case, form):
    """The W = 4 checkpoint at W = 1 (stage 3), plain and through
    universal: master and moments equal the consolidated ones the ranks
    had at the save, and the parameters are the master in bf16."""
    saved = runs4["ranks"][0][case]
    path = runs4["dir"] / case / ("w4_uni" if form == "universal"
                                  else "w4")
    eng = _load({"stage": 3}, str(path), form)
    assert _equal(eng.consolidated_master_state_dict(), saved["master"])
    assert _equal(_moments(eng), saved["moments"])
    assert int(eng._step) == 2 and eng.global_steps == 2
    assert _equal(_params(eng),
                  {n: m.bfloat16() for n, m in saved["master"].items()})
    assert _equal(_params(eng), saved["params"])
