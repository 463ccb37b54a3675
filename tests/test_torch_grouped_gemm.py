"""The grouped GEMM of the grouped MoE form (deepspeed_tpu_torch/ops/
grouped_gemm.py, csrc/grouped_gemm.cu) and ``moe_ffn_grouped`` over it,
against the JAX package on the CPU (seeded numpy inputs).

- ``grouped_mm``'s plain version against ``lax.ragged_dot`` (the XLA op
  the JAX package's grouped form runs; there is no Pallas kernel), fp32
  and bf16, with empty groups first, inside and last;
- ``group_offsets`` from sorted ids equal to a bincount's cumsum;
- the kernel's tile schedule (``find_tile`` in the CUDA source) emulated
  in numpy: every row of every group in exactly one 64-row tile of its
  own group, within the grid's slots, empty groups taking none;
- ``moe_ffn_grouped`` against JAX's, fp32 and bf16, top-1 to top-4,
  SwiGLU and GELU;
- the v2 engine's fused loops in speculative chain and ring mode taking
  the grouped form, eagerly on the CPU, against the JAX engine's;
- the wrapper's refusals.

Tolerances: fp32 rtol 1e-4 / atol 1e-5 (tests/test_moe.py's for the
grouped form); bf16 2e-2 of the largest value (the inputs are rounded to
bf16 alike and both sides sum in fp32; the products round once to bf16).
The kernel itself runs on the card: ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import build_engine as jbuild_engine
from deepspeed_tpu.moe import sharded_moe as J
from deepspeed_tpu_torch.inference.v2 import build_engine
from deepspeed_tpu_torch.moe import sharded_moe as T
from deepspeed_tpu_torch.ops import grouped_gemm as gg
from test_torch_moe_models import moe_case

BF16_TOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TILE = 64                      # the kernel's kTileM
SIZES = {"empty_first": [0, 7, 3, 9], "empty_inside": [5, 0, 0, 12, 1],
         "empty_last": [4, 2, 6, 0], "one_group": [0, 0, 13, 0],
         "wide": [70, 0, 130, 1]}


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - ref).max()
                 / max(np.abs(ref).max(), 1e-30))


def _case(sizes, k=24, n=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((sum(sizes), k)).astype(np.float32)
    w = (rng.standard_normal((len(sizes), k, n)) / k ** 0.5).astype(
        np.float32)
    return x, w, np.asarray(sizes, np.int32)


@pytest.mark.parametrize("name", list(SIZES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_mm_plain_matches_ragged_dot(dtype, name):
    x, w, sizes = _case(SIZES[name])
    jdt = jnp.dtype(dtype)
    ref = jax.lax.ragged_dot(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                             jnp.asarray(sizes))
    tdt = getattr(torch, dtype)
    offsets = torch.from_numpy(np.cumsum(sizes).astype(np.int32))
    got = gg.grouped_mm(torch.from_numpy(x).to(tdt),
                        torch.from_numpy(w).to(tdt), offsets)
    assert got.dtype == tdt and tuple(got.shape) == ref.shape
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
    else:
        assert _rel(got.float().numpy(), ref) < BF16_TOL


def test_group_offsets_are_a_bincounts_cumsum():
    rng = np.random.default_rng(4)
    for e, n in ((8, 16), (60, 32), (5, 1), (4, 300)):
        ids = np.sort(rng.integers(0, e, n))
        got = gg.group_offsets(torch.from_numpy(ids), e)
        want = np.cumsum(np.bincount(ids, minlength=e))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def _tile_schedule(offsets, rows):
    """The kernel's ``find_tile`` for every slot of the grid's y (the C
    source's scan, slot by slot): (group, first row, rows) or None."""
    groups = len(offsets)
    slots = -(-rows // TILE) + min(groups, rows)
    out = []
    for slot in range(slots):
        start, tile = 0, None
        for e in range(groups):
            end = min(int(offsets[e]), rows)
            size = end - start
            tiles = -(-size // TILE) if size > 0 else 0
            if slot < tiles:
                row0 = start + slot * TILE
                tile = (e, row0, min(TILE, end - row0))
                break
            slot -= tiles
            if end > start:
                start = end
        out.append(tile)
    return out


@pytest.mark.parametrize("name", list(SIZES))
def test_kernel_tile_schedule_covers_every_row_once(name):
    sizes = SIZES[name]
    offsets = np.cumsum(sizes)
    rows = int(offsets[-1])
    owner = np.repeat(np.arange(len(sizes)), sizes)
    covered = np.zeros(rows, np.int64)
    for tile in _tile_schedule(offsets, rows):
        if tile is None:
            continue
        e, row0, n = tile
        assert n > 0 and sizes[e] > 0
        assert (owner[row0:row0 + n] == e).all()
        covered[row0:row0 + n] += 1
    assert (covered == 1).all()


def _moe_inputs(seed, k, gated, d=32, e=6, f=48, n=20):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, n // 2, d)).astype(np.float32)
    gate_w = (0.3 * rng.standard_normal((d, e))).astype(np.float32)
    shapes = {"w_up": (e, d, f), "w_down": (e, f, d)}
    if gated:
        shapes["w_gate"] = (e, d, f)
    experts = {m: (0.1 * rng.standard_normal(sh)).astype(np.float32)
               for m, sh in shapes.items()}
    return x, gate_w, experts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k, act", [(1, "swiglu"), (2, "swiglu"),
                                    (4, "gelu")])
def test_moe_ffn_grouped_matches_jax(k, act, dtype):
    x, gate_w, experts = _moe_inputs(k, k, act == "swiglu")
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref, jaux = J.moe_ffn_grouped(
        jnp.asarray(x, jdt), jnp.asarray(gate_w, jdt),
        {m: jnp.asarray(v, jdt) for m, v in experts.items()}, k=k,
        activation=act)
    got, aux = T.moe_ffn_grouped(
        torch.from_numpy(x).to(tdt), torch.from_numpy(gate_w).to(tdt),
        {m: torch.from_numpy(v).to(tdt) for m, v in experts.items()}, k=k,
        activation=act)
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    else:
        assert _rel(got.float().numpy(), ref) < BF16_TOL


ENGINE_KW = dict(dtype="float32", kv_block_size=8, num_kv_blocks=64,
                 max_chunk_size=16, moe_grouped_dispatch=True)


@pytest.mark.parametrize("mode", [
    {"speculative": {"enabled": True}}, {"fused_admission": True}])
def test_fused_grouped_modes_match_jax(mode):
    """The grouped form in speculative chain mode (verify ticks of 1 +
    draft_len slots) and ring mode (admission inside the loop), greedy,
    run eagerly on the CPU, against the JAX engine in the same mode; the
    prompts followed by their own greedy tokens, so drafts land."""
    _, params, _ = moe_case("mixtral", "tiny")
    rng = np.random.default_rng(9)
    base = [rng.integers(0, 512, n).tolist() for n in (9, 14, 6)]
    plain = build_engine("mixtral", "tiny", dict(ENGINE_KW), params=params,
                         device="cpu")
    assert plain.model.moe_serving_dispatch
    prompts = [p + list(o) for p, o in zip(
        base, plain.generate(base, max_new_tokens=12))]
    cfg = dict(ENGINE_KW, **mode)
    je = jbuild_engine("mixtral", "tiny", dict(cfg), params=params)
    te = build_engine("mixtral", "tiny", dict(cfg), params=params,
                      device="cpu")
    want = [list(map(int, o)) for o in je.generate_fused(
        prompts, max_new_tokens=10, k_steps=4, temperature=0.0)]
    assert te.generate_fused(prompts, max_new_tokens=10, k_steps=4,
                             temperature=0.0) == want
    if "speculative" in mode:
        assert te.serving_metrics()["spec_accepted_tokens"] > 0


def test_grouped_mm_refuses_what_it_does_not_take():
    x = torch.zeros(4, 8)
    w = torch.zeros(2, 8, 5)
    offs = torch.tensor([1, 4], dtype=torch.int32)
    cases = [(x, w[:, :4], offs, "x \\[R, K\\]"),
             (x, w, offs.long(), "int32"),
             (x, w, offs[:1], "int32"),
             (x, w.double(), offs, "w is")]
    for a, b, o, match in cases:
        with pytest.raises(ValueError, match=match):
            gg.grouped_mm(a, b, o)
    with pytest.raises(ValueError, match="unsupported device"):
        gg.grouped_mm_kernel(x, w, offs)
    with pytest.raises(ValueError, match="unsupported dtype"):
        gg.kernel_variant(torch.float64)
    assert gg.kernel_variant(torch.bfloat16) == "tensor_cores"
    assert gg.kernel_variant(torch.float32) == "cuda_cores"
