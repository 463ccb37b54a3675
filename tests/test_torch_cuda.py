"""The port's CUDA kernel on the card (marker ``gpu``: these tests skip
where no card is present). On a machine with an NVIDIA H100:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

``--noconftest`` because the suite's conftest imports jax; this file
imports only torch, numpy and the port, so it runs where jax is absent.
The kernel is held against its plain PyTorch version on the same inputs:
fp32 with TF32 off at 1e-4 (summation order only), bf16 at 3e-2 (the JAX
package's bf16 kernel tolerance, tests/test_pallas_kernels.py:67).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2 import build_engine, paged
from deepspeed_tpu_torch.ops.layers import alibi_slopes

pytestmark = pytest.mark.gpu

B, HQ, HKV, NB, BS, MAXB = 3, 8, 2, 24, 8, 6
POS0 = [13, 0, 24]
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
VARIANTS = {"causal": {}, "window": {"window": 11}, "alibi": {"alibi": True}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype, sq, d, seed=0):
    """One paged-attention call: a permuted block table with a padded
    slot past the pool, and a batch row with nothing to attend
    (true_len 0) in the decode case."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    tables = rng.permutation(NB)[:B * MAXB].reshape(B, MAXB).astype(np.int32)
    tables[1, -1] = NB
    true_len = [sq, 0, sq] if sq == 1 else [sq, sq - 3, sq]
    ints = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa
    return dict(q=f(B, sq, HQ, d), k_new=f(B, sq, HKV, d),
                v_new=f(B, sq, HKV, d), k_pool=f(NB, BS, HKV, d),
                v_pool=f(NB, BS, HKV, d), block_tables=ints(tables),
                pos0=ints(POS0), true_len=ints(true_len))


def _kwargs(variant, dev):
    kw = {"window": VARIANTS[variant].get("window")}
    if VARIANTS[variant].get("alibi"):
        kw["alibi_slopes"] = alibi_slopes(HQ, device=dev)
    return kw


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("sq", [1, 8, 40])
@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, dtype, d, sq, variant):
    x = _inputs(cuda, dtype, sq, d)
    kw = _kwargs(variant, cuda)
    before = paged.paged_attention_kernel.launches
    got = paged.paged_attention_kernel(*x.values(), **kw)
    torch.cuda.synchronize()
    assert paged.paged_attention_kernel.launches == before + 1
    ref = paged.paged_attention_plain(*x.values(), **kw)
    assert got.dtype == dtype and got.shape == ref.shape
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = _inputs(cuda, torch.float32, 8, 32)
    bad = [("head_dim", dict(x, q=x["q"].repeat(1, 1, 1, 2)[..., :48]
                                   .contiguous())),
           ("int32", dict(x, block_tables=x["block_tables"].long())),
           ("contiguous", dict(x, q=x["q"].transpose(0, 1).contiguous()
                               .transpose(0, 1))),
           ("dtype", dict(x, k_pool=x["k_pool"].to(torch.bfloat16)))]
    for match, args in bad:
        with pytest.raises(ValueError, match=match):
            paged.paged_attention_kernel(*args.values())


def test_engine_on_the_card_matches_the_cpu_and_launches_every_layer(cuda):
    cfg = dict(dtype="float32", kv_block_size=8, num_kv_blocks=64,
               max_chunk_size=16)
    cpu = build_engine("llama", "tiny", cfg, device="cpu")
    gpu = build_engine("llama", "tiny", cfg, device=cuda)
    with torch.no_grad():
        for name, p in cpu.model.params.items():
            gpu.model.params[name].copy_(p)
    prompts = [np.random.default_rng(s).integers(0, 512, n).tolist()
               for s, n in ((1, 11), (2, 40))]
    before = paged.paged_attention_kernel.launches
    got = gpu.put([0, 1], prompts)
    launched = paged.paged_attention_kernel.launches - before
    ref = cpu.put([0, 1], prompts)
    torch.testing.assert_close(got.cpu(), ref, atol=2e-4, rtol=2e-4)
    dispatches = gpu.serving_stats["host_dispatches"]
    assert dispatches == 3          # 40 tokens at a 16-token budget
    assert launched == gpu.model.config.num_layers * dispatches
