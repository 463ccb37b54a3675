"""The port's v1 inference engine (deepspeed_tpu_torch/__init__.py
``init_inference``, inference/engine.py, inference/auto_tp.py and
``DecoderLM.init_cache``/``decode``) against the JAX package's
(deepspeed_tpu/inference/engine.py; the counterparts of
tests/test_inference.py), fp32 on the CPU, on the same perturbed weights.

Held: decode logits against the full forward (2e-4, the JAX test's
tolerance) and against JAX's decode (1e-5 of the largest |logit|);
greedy tokens against JAX's ``generate`` and against a stepwise argmax;
top-k and top-p sampled tokens against JAX's under the near-tie rule of
tests/test_torch_sampling.py (where a row's tokens first differ, the JAX
top-2 margin of gumbel noise plus filtered logits there must be under
1e-4; greedy: of the logits), for GPT-2, Llama (GQA), Mistral (the
window) and Bloom (ALiBi), and equal to JAX's for weight-only int8 and
Mixtral's capacity and grouped forms; the decode step ``generate``
replays as a CUDA graph on the card, run here on the CPU with every host
read of a tensor (``item``, ``tolist``, ``int``, ``bool``, ``cpu``)
patched to raise; the sequence-length guards; the ``.npz``
load; ``auto_tp_rules`` and the model's rules against JAX's (a spec as
the tuple of a ``PartitionSpec``); each refusal of what is not ported.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu import models as jm
from deepspeed_tpu.inference.auto_tp import auto_tp_rules as jauto_tp_rules
from deepspeed_tpu_torch import models as tm
from deepspeed_tpu_torch.inference.auto_tp import auto_tp_rules, get_tp_rules
from deepspeed_tpu_torch.models.convert import flatten_tree


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs tiny models: one intra-op thread a worker
    keeps it from spinning against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NEAR_TIE = 1e-4
# family -> model overrides: the cache's window (Mistral, a window of 5
# so it cuts within the test's sequences), ALiBi (Bloom), parallel
# residual with partial rotary (GPT-J), learned positions (GPT-2), GQA
FAMILIES = {"llama": {}, "gpt2": {}, "mistral": dict(sliding_window=5),
            "bloom": {}, "gptj": {}}
_CACHE: dict = {}


def _pair(family):
    """(JAX model, perturbed numpy params) of the family's tiny preset."""
    if family not in _CACHE:
        jmodel = jm.get_model_class(family)(size="tiny", **FAMILIES[family])
        params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(len(family))
        params = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(
            a.shape)).astype(a.dtype), params)
        _CACHE[family] = (jmodel, params)
    return _CACHE[family]


def _port(family, **config):
    jmodel, params = _pair(family)
    model = tm.get_model_class(family)(size="tiny", device="cpu",
                                       **FAMILIES[family])
    return tds.init_inference(model, config=dict(dtype="float32", **config),
                              params=params)


def _jax(family, **config):
    jmodel, params = _pair(family)
    return jds.init_inference(jmodel, dtype="float32", params=params,
                              **config)


def _prompts(n=2, length=7, seed=5):
    return np.random.default_rng(seed).integers(0, 512, (n, length))


def _step_margins(family, seq, prompt_len, seed=None, **sample):
    """Per row and new position: the JAX top-2 margin of the next-token
    logits (greedy) or of gumbel noise + the filtered logits with the
    step's key (sampled: PRNGKey(seed), one split before each draw)."""
    jmodel, params = _pair(family)
    logits = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(seq)),
                        np.float32)[:, prompt_len - 1:-1]
    if seed is None:
        top2 = np.sort(logits, -1)[..., -2:]
        return top2[..., 1] - top2[..., 0]
    key = jax.random.PRNGKey(seed)
    out = np.zeros(logits.shape[:2], np.float32)
    for t in range(logits.shape[1]):
        key, sub = jax.random.split(key)
        x = logits[:, t] / np.float32(sample.get("temperature", 1.0))
        if sample.get("top_k", 0) > 0:
            kth = np.sort(x, -1)[:, -sample["top_k"]][:, None]
            x = np.where(x < kth, -1e30, x)
        top_p = sample.get("top_p", 0.0)
        if 0.0 < top_p < 1.0:
            srt = -np.sort(-x, -1)
            p = np.exp(srt - srt[:, :1])
            p /= p.sum(-1, keepdims=True)
            keep = (np.cumsum(p, -1) - p) < top_p
            kth = np.take_along_axis(srt, keep.sum(-1, keepdims=True) - 1,
                                     -1)
            x = np.where(x < kth, -1e30, x)
        g = np.asarray(jax.random.gumbel(sub, x.shape))
        top2 = np.sort(g + x, -1)[:, -2:]
        out[:, t] = top2[:, 1] - top2[:, 0]
    return out


def _assert_tokens(family, want, got, prompt_len, seed=None, **sample):
    """Equal, or each row equal up to a first difference at a JAX
    near-tie (the rows diverge from there)."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape
    np.testing.assert_array_equal(got[:, :prompt_len], want[:, :prompt_len])
    if np.array_equal(want, got):
        return
    margins = _step_margins(family, want, prompt_len, seed, **sample)
    for row in range(want.shape[0]):
        diff = np.flatnonzero(want[row] != got[row])
        if len(diff):
            t = diff[0] - prompt_len
            assert margins[row, t] < NEAR_TIE, (row, t, margins[row, t])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_decode_matches_full_forward_and_jax(family):
    """Prefill of 8 then 4 single-token steps over the static cache: the
    full forward's logits (2e-4) and JAX's decode (1e-5 of max |logit|),
    the window cutting and ALiBi biasing across the cache."""
    jmodel, params = _pair(family)
    model = _port(family).module
    tokens = np.random.default_rng(1).integers(0, 512, (2, 12))
    with torch.no_grad():
        full = model.apply(torch.from_numpy(tokens)).numpy()
        cache = model.init_cache(2, 16)
        steps = []
        logits, cache = model.decode(torch.from_numpy(tokens[:, :8]), cache)
        steps.append(logits)
        for i in range(8, 12):
            logits, cache = model.decode(
                torch.from_numpy(tokens[:, i:i + 1]), cache)
            steps.append(logits)
    assert cache["index"] == 12
    inc = torch.cat(steps, 1).numpy()
    np.testing.assert_allclose(inc, full, rtol=2e-4, atol=2e-4)
    jcache = jmodel.init_cache(2, 16)
    ref, jcache = jmodel.decode(params, jnp.asarray(tokens[:, :8]), jcache)
    refs = [np.asarray(ref)]
    for i in range(8, 12):
        ref, jcache = jmodel.decode(params, jnp.asarray(tokens[:, i:i + 1]),
                                    jcache)
        refs.append(np.asarray(ref))
    ref = np.concatenate(refs, 1)
    assert np.abs(inc - ref).max() / np.abs(ref).max() < 1e-5


@pytest.mark.parametrize("family", list(FAMILIES))
def test_generate_greedy_matches_jax_and_forward(family):
    """init_inference(...).generate: JAX's greedy tokens, the prompt kept,
    the forward's logits, and a stepwise argmax over full forwards."""
    prompts = _prompts()
    eng = _port(family)
    got = eng.generate(prompts, max_new_tokens=6)
    assert got.shape == (2, 13) and got.dtype == torch.int64
    want = _jax(family).generate(jnp.asarray(prompts), max_new_tokens=6)
    _assert_tokens(family, want, got.numpy(), prompts.shape[1])
    seq = torch.from_numpy(prompts)
    for _ in range(6):
        nxt = eng.forward(seq)[:, -1].argmax(-1)
        seq = torch.cat([seq, nxt[:, None]], 1)
    assert torch.equal(seq, got)
    jmodel, params = _pair(family)
    ref = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(prompts)))
    out = eng(prompts).numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5
    assert torch.equal(eng.generate(prompts[0], max_new_tokens=6), got[:1])


SAMPLING = {"top_k": dict(temperature=0.8, top_k=5, seed=0),
            "top_p_top_k": dict(temperature=0.8, top_k=50, top_p=0.9,
                                seed=3),
            "top_p_tight": dict(top_p=0.2, seed=11)}


@pytest.mark.parametrize("name", list(SAMPLING))
@pytest.mark.parametrize("family", ["llama", "gpt2", "mistral", "bloom"])
def test_generate_sampling_matches_jax(family, name):
    """Sampled tokens: JAX's keys and filters, equal under the near-tie
    rule; another seed draws other tokens."""
    kw = SAMPLING[name]
    prompts = _prompts(seed=9)
    got = _port(family).generate(prompts, max_new_tokens=6, do_sample=True,
                                 **kw)
    want = _jax(family).generate(jnp.asarray(prompts), max_new_tokens=6,
                                 do_sample=True, **kw)
    sample = {k: v for k, v in kw.items() if k != "seed"}
    _assert_tokens(family, want, got.numpy(), prompts.shape[1],
                   seed=kw["seed"], **sample)
    if name == "top_k":
        other = _port(family).generate(prompts, max_new_tokens=6,
                                       do_sample=True,
                                       **dict(kw, seed=kw["seed"] + 1))
        assert not torch.equal(other, got)


def test_seq_len_guards():
    """The JAX engine's two guards, with its messages: the model's
    max_seq_len and the config's max_out_tokens."""
    eng = _port("gpt2")
    max_len = eng.module.config.max_seq_len
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.generate(np.zeros((1, max_len - 2), np.int64),
                     max_new_tokens=10)
    small = _port("gpt2", max_out_tokens=16)
    with pytest.raises(ValueError, match="max_out_tokens"):
        small.generate(np.zeros((1, 12), np.int64), max_new_tokens=5)
    assert small.generate(np.zeros((1, 12), np.int64),
                          max_new_tokens=4).shape == (1, 16)


def test_checkpoint_npz_load(tmp_path):
    """config["checkpoint"] a .npz of the tree's "/"-joined names (what
    save_16bit_model writes): the same weights as JAX's engine reads, and
    its logits."""
    jmodel, params = _pair("llama")
    path = str(tmp_path / "model_weights.npz")
    np.savez(path, **flatten_tree(params))
    model = tm.Llama(size="tiny", device="cpu")
    eng = tds.init_inference(model, config={"dtype": "float32",
                                            "checkpoint": path})
    for name, arr in flatten_tree(params).items():
        np.testing.assert_array_equal(eng.module.params[name].detach()
                                      .numpy(), arr)
    jeng = jds.init_inference(jm.Llama(size="tiny"), dtype="float32",
                              checkpoint=path)
    tokens = _prompts()
    ref = np.asarray(jeng.forward(jnp.asarray(tokens)))
    got = eng.forward(tokens).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


def _spec_tuples(rules):
    return [(pat, tuple(spec)) for pat, spec in rules]


def test_auto_tp_rules_match_jax():
    """A foreign tree's inferred rules (the JAX test's tree, and the
    model's own tree as a nested dict and as the port's flat parameter
    names) and the model's rules through get_tp_rules, as JAX gives
    them."""
    foreign = {"h": {"0": {"attn": {"q_proj": np.zeros((8, 8)),
                                    "o_proj": np.zeros((8, 8))},
                           "mlp": {"up_proj": np.zeros((8, 32)),
                                   "down_proj": np.zeros((32, 8))}}}}
    assert auto_tp_rules(foreign) == _spec_tuples(jauto_tp_rules(foreign))
    rules = dict(auto_tp_rules(foreign))
    assert rules[r"h/0/attn/q_proj$"] == (None, "tp")
    assert rules[r"h/0/attn/o_proj$"] == ("tp", None)
    jmodel, params = _pair("gpt2")
    want = _spec_tuples(jauto_tp_rules(params))
    assert auto_tp_rules(params) == want
    model = _port("gpt2").module
    assert auto_tp_rules(dict(model.params)) == want
    assert get_tp_rules(model, params) == \
        _spec_tuples(jmodel.partition_rules())


def test_refusals_name_their_roadmap_items(tmp_path):
    model = tm.GPT2(size="tiny", device="cpu")
    # a checkpoint of the JAX memory tiers (host optimizer files)
    host_opt = tmp_path / "offload_run"
    (host_opt / "global_step1").mkdir(parents=True)
    np.savez(host_opt / "global_step1" / "host_opt_rank0.npz", x=np.zeros(1))
    (host_opt / "latest").write_text("global_step1")
    cases = [(dict(tensor_parallel={"tp_size": 4}), "Slice D item 12"),
             (dict(dtype="int8"), "not a blanket cast; use "),
             (dict(quantize_weights=True, tensor_parallel={"tp_size": 2}),
              "single-replica serving path"),
             (dict(checkpoint=str(host_opt)), "Slice E")]
    for config, match in cases:
        with pytest.raises(NotImplementedError, match=match):
            tds.init_inference(model, config=dict({"dtype": "float32"},
                                                  **config))
    # a checkpoint path loads an HF directory (checkpoint/huggingface.py);
    # one without config.json is refused
    with pytest.raises(FileNotFoundError, match="config.json"):
        tds.init_inference(str(tmp_path), device="cpu")
    # the keyword form of the config, as JAX takes it
    eng = tds.init_inference(model, dtype="float32", max_out_tokens=32)
    assert eng.config.max_out_tokens == 32 and eng.dtype == torch.float32


def _int8_pair():
    """The tiny Llama with JAX ``quantize_dense_params`` at min_size 1
    (every projection and the head int8), both engines over that tree."""
    from deepspeed_tpu.linear.quantization import quantize_dense_params
    jmodel, params = _pair("llama")
    qparams = jax.tree.map(np.asarray, quantize_dense_params(
        jax.tree.map(jnp.asarray, params), min_size=1,
        scale_dtype=jnp.float32))
    je = jds.init_inference(jmodel, dtype="float32", params=qparams)
    te = tds.init_inference(tm.Llama(size="tiny", device="cpu"),
                            dtype="float32", params=qparams)
    assert "layers/wq_q" in te.module.params
    return je, te


def _moe_pair(grouped):
    from test_torch_moe_models import moe_case
    _, params, _ = moe_case("mixtral", "tiny")
    cfg = {"dtype": "float32", "max_out_tokens": 48,
           "moe_grouped_dispatch": grouped}
    je = jds.init_inference(jm.Mixtral(size="tiny", max_seq_len=64),
                            config=dict(cfg),
                            params=jax.tree.map(np.asarray, params))
    te = tds.init_inference(tm.Mixtral(size="tiny", max_seq_len=64,
                                       device="cpu"),
                            config=dict(cfg), params=params)
    return je, te


PAIRS = {"int8": _int8_pair, "mixtral_capacity": lambda: _moe_pair(False),
         "mixtral_grouped": lambda: _moe_pair(True)}


@pytest.mark.parametrize("case", list(PAIRS))
def test_int8_and_moe_sampled_generate_matches_jax(case):
    """Sampled tokens (temperature, top-k and top-p) of weight-only int8
    and of Mixtral's capacity and grouped forms equal JAX's."""
    je, te = PAIRS[case]()
    kw = SAMPLING["top_p_top_k"]
    prompts = _prompts(seed=13)
    want = np.asarray(je.generate(jnp.asarray(prompts), max_new_tokens=6,
                                  do_sample=True, **kw))
    got = te.generate(prompts, max_new_tokens=6, do_sample=True, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


HOST_READS = ("item", "tolist", "__int__", "__bool__", "cpu")
GUARD_CASES = {"gpt2": {}, "llama": {}, "mistral": {}, "bloom": {},
               "gptj": {}, "llama_sampled": dict(
                   greedy=False, temperature=0.8, top_k=50, top_p=0.9),
               "int8": {}, "mixtral_capacity": {}, "mixtral_grouped": {}}


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_decode_step_reads_nothing_back_to_the_host(case, monkeypatch):
    """The step generate() captures on the card (the forward over the
    cache at its device index, the key's split, the draw, the token's
    write at the device step counter), run on the CPU with every host
    read of a tensor patched to raise: the tokens of two steps are
    generate()'s."""
    from deepspeed_tpu_torch.inference.engine import GenerateState
    from deepspeed_tpu_torch.ops import threefry
    family = case.split("_")[0]
    if case in PAIRS:
        eng = PAIRS[case]()[1]
    else:
        eng = _port(family)
    sampling = dict(greedy=True, temperature=1.0, top_k=0, top_p=0.0)
    sampling.update(GUARD_CASES[case])
    prompts = torch.from_numpy(_prompts(seed=21))
    state = GenerateState(eng.module, 2, 12, 3, eng.dtype, eng.device,
                          sampling)
    state.prefill(prompts, threefry.prng_key(4))

    def host_read(*args, **kwargs):
        raise AssertionError("a host read in the decode step")

    with monkeypatch.context() as patch:
        for name in HOST_READS:
            patch.setattr(torch.Tensor, name, host_read)
        state.step()
        state.step()
    want = eng.generate(prompts, max_new_tokens=3, seed=4,
                        do_sample=not sampling["greedy"],
                        **{k: v for k, v in sampling.items()
                           if k != "greedy"})
    assert torch.equal(torch.cat([prompts, state.out], 1), want)
    assert int(state.cache["index"]) == prompts.shape[1] + 2


def test_generate_keeps_one_state_a_cache_length():
    """generate() over many prompt lengths keeps the last call's state
    only, its cache the call's bucket (the next of 2^k and 3 * 2^(k-1)
    from prompt + new tokens, at most max_out_tokens): a call of the same
    bucket and
    sampling reuses it, another bucket or sampling replaces it and the
    old state is freed; the tokens are those of a state of the call's
    exact length."""
    import gc
    import weakref
    from deepspeed_tpu_torch.inference.engine import GenerateState
    from deepspeed_tpu_torch.ops import threefry
    eng = _port("gpt2", max_out_tokens=48)
    greedy = dict(greedy=True, temperature=1.0, top_k=0, top_p=0.0)
    grid = sorted({2 ** k for k in range(8)} | {3 * 2 ** k for k in range(7)})
    old, buckets = None, []
    for length in range(3, 31, 3):
        prompts = torch.from_numpy(_prompts(length=length, seed=length))
        got = eng.generate(prompts, max_new_tokens=4)
        state = eng._run[1]
        bucket = min(next(g for g in grid if g >= length + 4), 48)
        assert state.cache["k"].shape[2] == bucket
        if buckets and buckets[-1] == bucket:
            assert state is old()
        else:
            buckets.append(bucket)
            gc.collect()
            assert old is None or old() is None
        old = weakref.ref(state)
        del state
        exact = GenerateState(eng.module, 2, length + 4, 4, eng.dtype,
                              eng.device, greedy)
        exact.prefill(prompts, threefry.prng_key(0))
        for _ in range(3):
            exact.step()
        assert torch.equal(got[:, length:], exact.out)
    assert buckets == [8, 12, 16, 24, 32, 48]
    eng.generate(prompts, max_new_tokens=4, do_sample=True, top_k=5)
    gc.collect()
    assert old() is None and eng._run[0][1:] == (48, 1.0, 5, 0.0, False)
