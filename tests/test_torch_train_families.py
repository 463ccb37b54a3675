"""Training the eleven dense model families of the port (mistral, bloom,
falcon, opt, phi, phi3, gptj, gptneox, internlm, qwen, qwen2) against the
JAX package's, fp32 on the CPU, and their fused serving path.

Each family at its ``tiny`` preset and at head dim 80 here, at 96 and 256
in tests/test_torch_train_families_wide.py, and through the fused serving
path in tests/test_torch_fused_families.py (tiny) and
tests/test_torch_fused_families_wide.py (D 256): each JAX compile takes
seconds, and four files of ~140 s on one core let ``--dist loadfile``
spread them. On the perturbed weights of
tests/test_torch_model_families.py ``_case``, over 2 x 64 tokens (past
Mistral's tiny window of 32):

- ``DecoderLM.loss`` and its grads with ``attn_impl="flash"`` (on the CPU
  the kernels' plain versions inside their autograd Function; Bloom takes
  the reference attention, since flash refuses ALiBi as in JAX) against
  ``jax.value_and_grad`` of the JAX model: the loss within 1e-6
  relative, each grad within 1e-5 of the largest element of its tensor
  (only summation order differs), a tensor's scale at least 1e-3 of the
  model's largest grad (tests/test_torch_train_engine.py's floor). Where
  positions add no per-key rotation (OPT's learned positions, Bloom's
  ALiBi), the key bias's exact grad is zero (softmax ignores a shift
  shared by a row's scores), so both sides hold rounding noise there:
  each side must stay within 1e-5 of the model's largest grad;
- under every remat policy, the port's loss and grads equal remat=False's
  (1e-6: the recompute repeats the same CPU ops);
- one remat policy with ``loss_chunk=16`` against the JAX model under the
  same policy and chunked loss, at the same bounds; the policy rotates
  over the families and widths, so each policy meets JAX;
- ``build_engine(..., device="cpu").generate_fused(k_steps=4)`` gives the
  same engine's per-tick ``generate`` tokens and the JAX engine's
  ``generate_fused`` tokens, greedy.

The JAX loss and grads compile at XLA's backend optimization level 0,
which halves the compile and leaves the fp32 arithmetic to the same HLO.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import models as jm
from deepspeed_tpu.inference.v2 import build_engine as jbuild_engine
from deepspeed_tpu_torch import models as tm
from deepspeed_tpu_torch.inference.v2 import build_engine
from deepspeed_tpu_torch.models.convert import flatten_tree
from deepspeed_tpu_torch.models.transformer import REMAT_POLICIES
from test_torch_model_families import DENSE, ENGINE_KW, _case, _overrides

LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
REMAT_TOL = 1e-6
LOSS_CHUNK = 16
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
_NO_REMAT: dict = {}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These models are tiny: one intra-op thread a worker keeps the
    port's side from spinning against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _attn(family: str) -> str:
    return "reference" if family == "bloom" else "flash"


def _batch(seq=64, seed=0):
    tok = np.random.default_rng(seed).integers(0, 512, (2, seq + 1))
    return tok[:, :-1], tok[:, 1:]


def _port(family, width, **over):
    """Loss and grads of the port's model on ``_case``'s weights."""
    _, params, _ = _case(family, width)
    model = tm.get_model_class(family)(
        size="tiny", device="cpu", attn_impl=_attn(family),
        **_overrides(family, width), **over)
    tm.load_jax_params(model, params)
    tokens, targets = map(torch.from_numpy, _batch())
    loss = model.loss((tokens, targets))
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in model.params.items()}


def _jax(family, width, **over):
    """Loss and flat grads of ``jax.value_and_grad`` of the JAX model."""
    _, params, _ = _case(family, width)
    model = jm.get_model_class(family)(
        size="tiny", attn_impl=_attn(family), **_overrides(family, width),
        **over)
    tokens, targets = _batch()
    loss, grads = jax.jit(jax.value_and_grad(model.loss),
                          compiler_options=FAST_COMPILE)(
        jax.tree.map(jnp.asarray, params),
        (jnp.asarray(tokens), jnp.asarray(targets)))
    return float(loss), flatten_tree(jax.tree.map(np.asarray, grads))


def _zero_grads(family, width) -> set:
    """Names whose exact grad is zero: the key bias where the positions
    add no per-key rotation."""
    c = _case(family, width)[2].config
    return ({"layers/wk_b"} if c.position_embedding in ("learned", "alibi")
            else set())


def _close_to_jax(got, ref, zero=frozenset()):
    loss, grads = got
    jloss, jgrads = ref
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    assert set(grads) == set(jgrads)
    top = max(float(np.abs(g).max()) for g in jgrads.values())
    for name, g in jgrads.items():
        if name in zero:
            noise = max(float(np.abs(g).max()),
                        float(grads[name].abs().max()))
            assert noise <= GRAD_TOL * top, (name, noise / top)
            continue
        scale = max(float(np.abs(g).max()), 1e-3 * top)
        err = float(np.abs(grads[name].numpy() - g).max())
        assert err <= GRAD_TOL * scale, (name, err / scale)


def check_loss_and_grads(family, width):
    _close_to_jax(_port(family, width), _jax(family, width),
                  _zero_grads(family, width))


def check_policy(family, width, policy):
    key = (family, width)
    if key not in _NO_REMAT:
        _NO_REMAT[key] = _port(family, width, remat=False)
    ref_loss, ref_grads = _NO_REMAT[key]
    loss, grads = _port(family, width, remat=True, remat_policy=policy)
    assert abs(loss - ref_loss) <= REMAT_TOL * abs(ref_loss)
    for name, g in ref_grads.items():
        torch.testing.assert_close(grads[name], g, rtol=0, atol=REMAT_TOL,
                                   msg=name)


def rotated_policy(family, width) -> str:
    """The remat policy held against JAX for this family and width."""
    widths = ("tiny", "d80", "d96", "d256")
    i = DENSE.index(family) + 3 * widths.index(width)
    return REMAT_POLICIES[i % len(REMAT_POLICIES)]


def check_policy_and_chunk_vs_jax(family, width):
    over = dict(remat=True, remat_policy=rotated_policy(family, width),
                loss_chunk=LOSS_CHUNK)
    _close_to_jax(_port(family, width, **over), _jax(family, width, **over),
                  _zero_grads(family, width))


def check_generate_fused(family, width):
    """Two prompts of 5 and 13 tokens (one prefill chunk each), 9 greedy
    tokens (the prefill's, then two dispatches of K 4): the fused path's
    tokens equal the same engine's per-tick generate() and the JAX
    engine's generate_fused."""
    _, params, _ = _case(family, width)
    over = _overrides(family, width)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n).tolist() for n in (5, 13)]
    te = build_engine(family, "tiny", dict(ENGINE_KW), params=params,
                      device="cpu", **over)
    ref = te.generate(prompts, max_new_tokens=9)
    got = te.generate_fused(prompts, max_new_tokens=9, k_steps=4,
                            temperature=0.0)
    assert got == ref
    assert te.free_blocks == te.num_kv_blocks
    je = jbuild_engine(family, "tiny", dict(ENGINE_KW), params=params,
                       **over)
    want = je.generate_fused(prompts, max_new_tokens=9, k_steps=4,
                             temperature=0.0)
    assert got == [list(map(int, o)) for o in want]


@pytest.mark.parametrize("width", ["tiny", "d80"])
@pytest.mark.parametrize("family", DENSE)
def test_loss_and_grads_match_jax(family, width):
    check_loss_and_grads(family, width)


@pytest.mark.parametrize("policy", REMAT_POLICIES)
@pytest.mark.parametrize("width", ["tiny", "d80"])
@pytest.mark.parametrize("family", DENSE)
def test_remat_policy_matches_no_remat(family, width, policy):
    check_policy(family, width, policy)


@pytest.mark.parametrize("width", ["tiny", "d80"])
@pytest.mark.parametrize("family", DENSE)
def test_remat_and_loss_chunk_match_jax(family, width):
    check_policy_and_chunk_vs_jax(family, width)


def test_every_policy_meets_jax():
    """The rotation holds every policy against JAX somewhere."""
    assert {rotated_policy(f, w) for f in DENSE
            for w in ("tiny", "d80", "d96", "d256")} == set(REMAT_POLICIES)

