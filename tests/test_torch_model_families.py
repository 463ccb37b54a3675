"""The port's model families (deepspeed_tpu_torch/models/: mistral, bloom,
falcon, opt, phi, phi3, gptj, gptneox, internlm, qwen, qwen2, with gpt2
and llama from earlier) against the JAX package's, fp32 on the CPU.

For each of the 15 names the JAX engine factory serves: the registry and
every preset's fields. For each dense family at its ``tiny`` preset and
widened to head dims 80, 96 and 256 (the dims of Phi-2, Phi-3-mini and
GPT-NeoX-20B, GPT-J-6B), with every parameter leaf perturbed (zero biases
and unit norm scales would hide the bias, norm and ``lm_head`` paths): the
parameter names, shapes and count against JAX ``init``'s, ``apply``'s
logits within 1e-5 of the largest |logit| (only summation order differs),
and ``build_engine(..., device="cpu")``'s greedy tokens against the JAX
``build_engine``'s on the same weights (tiny and D 80 here, D 96 and 256
in tests/test_torch_model_families_wide.py: each JAX engine compiles
for seconds, and two files let two workers share them). The MoE
families (mixtral, qwen2_moe) build and match JAX here at their tiny
presets: their logits, and their engines' greedy tokens; they are checked
in full in tests/test_torch_moe*.py.
"""

import dataclasses
import zlib

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu import models as jm
from deepspeed_tpu.inference.v2 import build_engine as jbuild_engine
from deepspeed_tpu.inference.v2 import engine_factory as jfactory
from deepspeed_tpu_torch import models as tm
from deepspeed_tpu_torch.inference.v2 import build_engine
from deepspeed_tpu_torch.inference.v2 import engine_factory as tfactory
from deepspeed_tpu_torch.models.convert import flatten_tree


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs tiny models: one intra-op thread a worker
    keeps it from spinning against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# name -> (config function, its presets)
PRESETS = {
    "gpt2": ("gpt2_config", ("tiny", "125m", "350m", "1.3b")),
    "llama": ("llama_config", ("tiny", "7b", "13b", "70b", "3-8b",
                               "3-70b")),
    "mistral": ("mistral_config", ("tiny", "7b")),
    "mixtral": ("mixtral_config", ("tiny", "ref", "8x7b")),
    "falcon": ("falcon_config", ("tiny", "7b", "40b")),
    "opt": ("opt_config", ("tiny", "125m", "1.3b", "13b", "66b")),
    "phi": ("phi_config", ("tiny", "2")),
    "phi3": ("phi3_config", ("tiny", "mini")),
    "qwen": ("qwen_config", ("tiny", "7b", "72b")),
    "qwen2": ("qwen2_config", ("tiny", "7b")),
    "qwen2_moe": ("qwen2_moe_config", ("tiny", "a2.7b")),
    "bloom": ("bloom_config", ("tiny", "560m", "7b1", "176b")),
    "gptj": ("gptj_config", ("tiny", "6b")),
    "gptneox": ("gptneox_config", ("tiny", "pythia-1.4b", "20b")),
    "internlm": ("internlm_config", ("tiny", "7b", "20b")),
}
DENSE = ("mistral", "bloom", "falcon", "opt", "phi", "phi3", "gptj",
         "gptneox", "internlm", "qwen", "qwen2")
MOE = ("mixtral", "qwen2_moe")
# head dims past the tiny presets' 16: 2 q heads (1 kv head where the
# preset has fewer kv heads than q heads), a narrow FFN
WIDTHS = {"tiny": None, "d80": 80, "d96": 96, "d256": 256}
LOGITS_TOL = 1e-5
ENGINE_KW = dict(dtype="float32", kv_block_size=8, num_kv_blocks=32,
                 max_chunk_size=16)
_CACHE: dict = {}


def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out["param_dtype"] = np.dtype(out["param_dtype"]).name \
        if not isinstance(out["param_dtype"], torch.dtype) \
        else str(out["param_dtype"]).replace("torch.", "")
    return out


def _overrides(family: str, width: str) -> dict:
    d = WIDTHS[width]
    if d is None:
        return {}
    tiny = getattr(jm, PRESETS[family][0])("tiny")
    gqa = tiny.num_kv_heads < tiny.num_heads
    return dict(hidden_size=2 * d, num_heads=2,
                num_kv_heads=1 if gqa else None, intermediate_size=96)


def _case(family: str, width: str):
    """(JAX model, perturbed JAX params as numpy, port model fp32 on the
    CPU holding them), once per (family, width)."""
    key = (family, width)
    if key not in _CACHE:
        over = _overrides(family, width)
        jmodel = jm.get_model_class(family)(size="tiny", **over)
        params = jax.tree.map(np.asarray,
                              jmodel.init(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(zlib.crc32(f"{family}/{width}".encode()))
        params = jax.tree.map(
            lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(
                a.dtype), params)
        tmodel = tm.get_model_class(family)(size="tiny", device="cpu",
                                            **over)
        tm.load_jax_params(tmodel, params)
        _CACHE[key] = (jmodel, params, tmodel)
    return _CACHE[key]


def test_supported_model_types_are_the_jax_table():
    assert tfactory.SUPPORTED_MODEL_TYPES == jfactory.SUPPORTED_MODEL_TYPES
    assert set(PRESETS) == set(jfactory.SUPPORTED_MODEL_TYPES)


@pytest.mark.parametrize("family", list(PRESETS))
def test_registry_and_presets_match_jax(family):
    """The name resolves in both registries to a class of the same name,
    and every preset (and the default size) has JAX's fields."""
    jcls, tcls = jm.get_model_class(family), tm.get_model_class(family)
    assert tcls.__name__ == jcls.__name__
    fn = PRESETS[family][0]
    jfn, tfn = getattr(jm, fn), getattr(tm, fn)
    for size in PRESETS[family][1]:
        jc, tc = jfn(size), tfn(size)
        assert _fields(tc) == _fields(jc), size
        assert tc.head_dim == jc.head_dim
        assert tc.num_params() == jc.num_params()
    assert _fields(tfn()) == _fields(jfn())
    assert _fields(tfn("tiny", rope_theta=123.0)) == \
        _fields(jfn("tiny", rope_theta=123.0))
    with pytest.raises(KeyError):
        tfn("no-such-size")


@pytest.mark.parametrize("family", MOE)
def test_moe_families_are_refused(family):
    """Once refused, the MoE families now build and match JAX: the
    model's logits on JAX ``init``'s weights within 1e-5 of the largest,
    and ``build_engine``'s greedy tokens equal to the JAX engine's."""
    jmodel = jm.get_model_class(family)(size="tiny")
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    tmodel = tm.get_model_class(family)(size="tiny", device="cpu")
    tm.load_jax_params(tmodel, params)
    tokens = np.random.default_rng(7).integers(0, 512, (2, 13))
    ref = np.asarray(jax.jit(jmodel.apply)(params, tokens))
    with torch.no_grad():
        got = tmodel.apply(torch.from_numpy(tokens)).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < LOGITS_TOL
    prompts = [np.random.default_rng(3).integers(0, 512, n).tolist()
               for n in (11, 20)]
    want = jbuild_engine(family, "tiny", dict(ENGINE_KW),
                         params=params).generate(prompts, max_new_tokens=4)
    got = build_engine(family, "tiny", dict(ENGINE_KW), params=params,
                       device="cpu").generate(prompts, max_new_tokens=4)
    assert got == [list(map(int, o)) for o in want]


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("family", DENSE)
def test_params_and_logits_match_jax(family, width):
    jmodel, params, tmodel = _case(family, width)
    c = tmodel.config
    if WIDTHS[width]:
        assert c.head_dim == WIDTHS[width]
    flat = flatten_tree(params)
    assert {k: tuple(v.shape) for k, v in flat.items()} == \
        {k: tuple(p.shape) for k, p in tmodel.params.items()}
    n = sum(v.size for v in flat.values())
    assert c.num_params() == jmodel.config.num_params() == n
    tokens = np.random.default_rng(7).integers(0, c.vocab_size, (2, 13))
    ref = np.asarray(jax.jit(jmodel.apply)(params, tokens))
    with torch.no_grad():
        got = tmodel.apply(torch.from_numpy(tokens)).numpy()
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < LOGITS_TOL, err


def check_engine_tokens(family, width):
    """Two prompts (one over two prefill chunks), 4 greedy tokens each,
    through both engines on the same perturbed weights."""
    _, params, _ = _case(family, width)
    over = _overrides(family, width)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n).tolist() for n in (11, 20)]
    je = jbuild_engine(family, "tiny", dict(ENGINE_KW), params=params,
                       **over)
    te = build_engine(family, "tiny", dict(ENGINE_KW), params=params,
                      device="cpu", **over)
    want = je.generate(prompts, max_new_tokens=4)
    got = te.generate(prompts, max_new_tokens=4)
    assert got == [list(map(int, o)) for o in want]
    assert te.free_blocks == te.num_kv_blocks


@pytest.mark.parametrize("width", ["tiny", "d80"])
@pytest.mark.parametrize("family", DENSE)
def test_build_engine_greedy_tokens_match_jax(family, width):
    check_engine_tokens(family, width)


@pytest.mark.parametrize("family", ["mistral", "opt"])
def test_positions_past_the_table(family):
    """A chunk's pad slots may sit past max_seq_len (a row near the end of
    its context in a wide tick). Rotary positions clamp as JAX's gather
    clamps them: the logits equal JAX's. Learned positions clamp where
    JAX's take fills NaN (and its attention spreads a NaN value row over
    the whole sequence, 0 x NaN): the sequence inside the table equals
    JAX's, and the port's logits stay finite."""
    jmodel, params, tmodel = _case(family, "tiny")
    s = tmodel.config.max_seq_len
    tokens = np.random.default_rng(2).integers(0, 512, (2, 8))
    positions = np.stack([np.arange(s - 5, s + 3), np.arange(8)])
    ref = np.asarray(jax.jit(jmodel.apply)(params, tokens,
                                            positions=positions))
    with torch.no_grad():
        got = tmodel.apply(torch.from_numpy(tokens),
                           torch.from_numpy(positions)).numpy()
    assert np.isfinite(got).all()
    rows = slice(None) if family == "mistral" else slice(1, 2)
    err = np.abs(got[rows] - ref[rows]).max() / np.abs(ref[rows]).max()
    assert err < LOGITS_TOL, err
