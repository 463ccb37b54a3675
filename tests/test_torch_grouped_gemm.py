"""The grouped GEMM of the grouped MoE form (deepspeed_tpu_torch/ops/
grouped_gemm.py, csrc/grouped_gemm.cu) and ``moe_ffn_grouped`` over it,
against the JAX package on the CPU (seeded numpy inputs).

- ``grouped_mm``'s plain version against ``lax.ragged_dot`` (the XLA op
  the JAX package's grouped form runs; there is no Pallas kernel), fp32
  and bf16, with empty groups first, inside and last;
- ``group_offsets`` from sorted ids equal to a bincount's cumsum;
- the int8 weight operand's plain version (``dequantize_weight`` an
  expert, then the product) against JAX's ``dequantize_experts`` +
  ``lax.ragged_dot``, fp32 and bf16, with empty groups;
- the wgmma kernel's tile list (``build_schedule`` and ``tile_at`` in the
  CUDA source) emulated in numpy for the prefill form and the decode
  form's three tile heights, walked by a persistent grid: every (row,
  column) of the output in exactly one tile of its own group, empty
  groups taking none;
- ``moe_ffn_grouped`` against JAX's, fp32 and bf16, top-1 to top-4,
  SwiGLU and GELU, with float and with int8 experts;
- the Mixtral model's grouped form passing its int8 experts to the
  grouped GEMM as codes (no ``dequantize_weight`` of an expert), its
  capacity form dequantizing them;
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

import deepspeed_tpu_torch as ds
import deepspeed_tpu_torch.models as tm
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


SIZES = {"empty_first": [0, 7, 3, 9], "empty_inside": [5, 0, 0, 12, 1],
         "empty_last": [4, 2, 6, 0], "one_group": [0, 0, 13, 0],
         "wide": [70, 0, 130, 1], "rows_below_groups": [0, 1, 0, 0, 1, 0],
         "ragged": [9, 33, 0, 17]}


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


# the wgmma kernel's tiles (csrc/grouped_gemm.cu launch_form): (rows,
# columns) of a prefill tile, and of a decode tile by its height
FORMS = {"prefill": (128, 256), "decode8": (8, 128), "decode16": (16, 128),
         "decode32": (32, 128)}


def _schedule(offsets, rows, tile_rows, col_tiles):
    """``build_schedule`` in numpy: each group's end clamped to [0, R],
    its start the largest end before it, its tiles ceil(size / tile_rows)
    x col_tiles; (tiles_before [E + 1], row_start, row_end)."""
    ends = np.clip(np.asarray(offsets, np.int64), 0, rows)
    starts = np.concatenate([[0], np.maximum.accumulate(ends)[:-1]])
    sizes = np.maximum(ends - starts, 0)
    tiles = -(-sizes // tile_rows) * col_tiles
    return np.concatenate([[0], np.cumsum(tiles)]), starts, starts + sizes


def _tile_at(sched, t, tile_rows, tile_cols):
    """``tile_at``: the last group whose first tile is at or before t (a
    binary search), then its column tile and row tile, row tiles fastest."""
    before, start, end = sched
    lo, hi = 0, len(start) - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if before[mid] <= t:
            lo = mid
        else:
            hi = mid - 1
    row_tiles = -(-(end[lo] - start[lo]) // tile_rows)
    ct, rt = divmod(t - before[lo], row_tiles)
    row0 = start[lo] + rt * tile_rows
    return lo, row0, min(tile_rows, end[lo] - row0), ct * tile_cols


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("name", list(SIZES))
def test_kernel_tile_schedule_covers_every_row_once(name, form):
    """Every (row, column) of the output in exactly one tile of its own
    group, the list walked by persistent grids of 132 blocks and of 3
    (block b takes tiles b, b + grid, ...); empty groups take no tile."""
    sizes = SIZES[name]
    tile_rows, tile_cols = FORMS[form]
    n = 300                                   # not a multiple of a tile
    offsets = np.cumsum(sizes)
    rows = int(offsets[-1])
    owner = np.repeat(np.arange(len(sizes)), sizes)
    col_tiles = -(-n // tile_cols)
    sched = _schedule(offsets, rows, tile_rows, col_tiles)
    total = int(sched[0][-1])
    assert total == sum(-(-s // tile_rows) for s in sizes) * col_tiles
    for grid in (132, 3):
        covered = np.zeros((rows, n), np.int64)
        for block in range(min(grid, total)):
            for t in range(block, total, grid):
                e, row0, count, col0 = _tile_at(sched, t, tile_rows,
                                                tile_cols)
                assert count > 0 and sizes[e] > 0
                assert (owner[row0:row0 + count] == e).all()
                covered[row0:row0 + count, col0:col0 + tile_cols] += 1
        assert (covered == 1).all()


def test_kernel_plan_picks_the_form_from_the_shapes():
    """The decode form while the groups hold at most
    DECODE_MAX_MEAN_ROWS rows on average, its tile the first height that
    holds twice the mean; the prefill form past it; the CUDA cores for
    fp32 and for shapes TMA cannot take."""
    bf16 = torch.bfloat16
    assert gg.kernel_plan(bf16, 16, 8, 4096, 14336) == (
        "wgmma_decode", "wgmma_decode", 8)
    assert gg.kernel_plan(bf16, 32, 60, 2048, 1408, int8=True) == (
        "wgmma_decode_int8", "wgmma_decode", 8)
    mean = gg.DECODE_MAX_MEAN_ROWS
    assert gg.kernel_plan(bf16, 8 * mean, 8, 64, 64)[2] == 32
    assert gg.kernel_plan(bf16, 8 * mean + 1, 8, 64, 64) == (
        "wgmma_prefill", "wgmma_prefill", 128)
    assert gg.kernel_plan(torch.float16, 4096, 8, 4096, 14336)[2] == 128
    assert gg.kernel_plan(bf16, 8192, 60, 2048, 1408, int8=True) == (
        "wgmma_prefill_int8", "wgmma_prefill", 128)
    assert gg.kernel_plan(torch.float32, 16, 8, 64, 64, int8=True)[0] == (
        "cuda_cores_int8")
    for k, n, int8, aligned, groups in ((100, 64, False, True, 4),
                                        (64, 90, False, True, 4),
                                        (64, 24, True, True, 4),
                                        (64, 64, False, False, 4),
                                        (64, 64, False, True, 300)):
        assert gg.kernel_plan(bf16, 64, groups, k, n, int8, aligned)[1] == (
            "cuda_cores")


def _quantized(w, dtype):
    """JAX's quantize_experts of one expert stack, in ``dtype``: the codes
    and scales as numpy, and the JAX tree."""
    jt = J.quantize_experts({"w": jnp.asarray(w, jnp.dtype(dtype))})
    return (np.array(jt["w_q"]),
            np.array(jt["w_s"].astype(jnp.float32)), jt)


@pytest.mark.parametrize("name", ["empty_first", "empty_inside", "wide"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_mm_int8_plain_matches_jax(dtype, name):
    """int8 codes and scales through grouped_mm (the plain version on the
    CPU) against JAX's dequantize_experts + lax.ragged_dot."""
    x, w, sizes = _case(SIZES[name], n=48)
    q, s, jt = _quantized(w, dtype)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = jax.lax.ragged_dot(jnp.asarray(x, jdt),
                             J.dequantize_experts(jt, jdt)["w"],
                             jnp.asarray(sizes))
    offsets = torch.from_numpy(np.cumsum(sizes).astype(np.int32))
    got = gg.grouped_mm(torch.from_numpy(x).to(tdt), torch.from_numpy(q),
                        offsets, torch.from_numpy(s).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == ref.shape
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
    else:
        assert _rel(got.float().numpy(), ref) < BF16_TOL


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k, act", [(2, "swiglu"), (4, "gelu")])
def test_moe_ffn_grouped_int8_matches_jax(k, act, dtype):
    """int8 experts (JAX's quantize_experts) passed to moe_ffn_grouped as
    codes and scales, against JAX's grouped form over its dequantized
    experts."""
    x, gate_w, experts = _moe_inputs(10 + k, k, act == "swiglu")
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jq = J.quantize_experts({m: jnp.asarray(v, jdt)
                             for m, v in experts.items()})
    ref, _ = J.moe_ffn_grouped(
        jnp.asarray(x, jdt), jnp.asarray(gate_w, jdt),
        J.dequantize_experts(jq, jdt), k=k, activation=act)
    tq = {m: torch.from_numpy(np.array(v.astype(jnp.float32))).to(tdt)
          if m.endswith("_s") else torch.from_numpy(np.array(v))
          for m, v in jq.items()}
    got, _ = T.moe_ffn_grouped(
        torch.from_numpy(x).to(tdt), torch.from_numpy(gate_w).to(tdt), tq,
        k=k, activation=act)
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
    else:
        assert _rel(got.float().numpy(), ref) < BF16_TOL


def test_grouped_form_passes_int8_experts_as_codes(monkeypatch):
    """init_inference(Mixtral, quantize_moe_experts): the grouped form's
    forward dequantizes no expert in the model (its grouped GEMMs get the
    codes and scales), the capacity form's dequantizes each layer's three
    expert weights (the values: test_torch_moe_serving.py's v1 int8_grouped
    case against JAX)."""
    _, params, _ = moe_case("mixtral", "tiny")
    calls = []
    real = T.dequantize_weight

    def counted(q, s, dtype):
        calls.append(tuple(q.shape))
        return real(q, s, dtype)
    monkeypatch.setattr(T, "dequantize_weight", counted)
    tokens = np.random.default_rng(2).integers(0, 512, (2, 10))
    counts = {}
    for form in ("grouped", "capacity"):
        eng = ds.init_inference(
            tm.Mixtral(size="tiny", max_seq_len=64, device="cpu"),
            config={"dtype": "float32", "max_out_tokens": 32,
                    "quantize_moe_experts": True,
                    "moe_grouped_dispatch": form == "grouped"},
            params=params)
        calls.clear()
        assert torch.isfinite(eng.forward(tokens)).all()
        counts[form] = len(calls)
    layers = tm.Mixtral(size="tiny", device="meta").config.num_layers
    assert counts == {"grouped": 0, "capacity": 3 * layers}


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
    q = torch.zeros(2, 8, 5, dtype=torch.int8)
    s = torch.ones(2, 1, 5)
    cases = [(x, w[:, :4], offs, None, "x \\[R, K\\]"),
             (x, w, offs.long(), None, "int32"),
             (x, w, offs[:1], None, "int32"),
             (x, w.double(), offs, None, "w is"),
             (x, q, offs, None, "needs its scales"),
             (x, q, offs, s[:, :, :4], "scales \\[2, 1, 5\\]"),
             (x, q, offs, s[:1], "scales \\[2, 1, 5\\]"),
             (x, q, offs, s.double(), "scales \\[2, 1, 5\\]"),
             (x, w, offs, s, "int8 w only"),
             (x.to(torch.int8), q, offs, s, "x is torch.int8")]
    for a, b, o, sc, match in cases:
        with pytest.raises(ValueError, match=match):
            gg.grouped_mm(a, b, o, sc)
    with pytest.raises(ValueError, match="unsupported device"):
        gg.grouped_mm_kernel(x, w, offs)
    with pytest.raises(ValueError, match="unsupported dtype"):
        gg.kernel_plan(torch.float64, 4, 2, 8, 8)
    assert gg.kernel_variant(x.bfloat16(), w.bfloat16()) == "cuda_cores"
    assert gg.kernel_variant(x, w) == "cuda_cores"
    assert gg.kernel_variant(torch.zeros(4, 64, dtype=torch.bfloat16),
                             torch.zeros(2, 64, 32, dtype=torch.int8),
                             s) == "wgmma_decode_int8"
