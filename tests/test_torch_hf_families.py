"""Hugging Face checkpoints of every family JAX ingests, read by the port
(deepspeed_tpu_torch ``checkpoint/huggingface.py``), on the CPU.

Over the JAX package's cases (tests/test_hf_checkpoint.py ``CASES``:
fifteen tiny random ``transformers`` models saved as safetensors):

- the port's logits agree with ``transformers``' within JAX's tolerance,
  ``max(2e-4, 1e-3 * scale)``, scale the largest reference logit;
- every mapped leaf, cast to fp32, equals the JAX ``from_pretrained``'s
  bit for bit, eager and lazy (``Deferred`` leaves);
- the config translation gives JAX's fields;
- the MoE families (mixtral, qwen2_moe) map bit-equal to JAX, and their
  logits agree with ``transformers``' at JAX's tolerance, with JAX's
  drop-free capacity override (``OVERRIDES``: HF routes exactly).

tests/test_torch_hf_checkpoint.py holds the reader, the entry points and
fine-tuning.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint.huggingface import (
    HuggingFaceCheckpointEngine as JHF)
from deepspeed_tpu_torch.checkpoint import (HuggingFaceCheckpointEngine,
                                            from_pretrained)
from deepspeed_tpu_torch.models.convert import (Deferred, flatten_tree,
                                                materialize)
from test_hf_checkpoint import CASES, OVERRIDES, _save

MOE = ("mixtral", "qwen2_moe")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", sorted(set(CASES) - set(MOE)))
def test_logits_match_hf(tmp_path, name):
    hf, d = _save(tmp_path, name)
    model, _ = from_pretrained(d, device="cpu", **OVERRIDES.get(name, {}))
    tokens = np.random.default_rng(0).integers(0, 250, (2, 16))
    with torch.no_grad():
        ref = hf(torch.tensor(tokens)).logits.float().numpy()
        ours = model.apply(torch.tensor(tokens)).float().numpy()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(ours, ref, atol=max(2e-4, 1e-3 * scale),
                               rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_leaves_and_config_equal_jax(tmp_path, name):
    _, d = _save(tmp_path, name)
    over = OVERRIDES.get(name, {})
    jeng, eng = JHF(d), HuggingFaceCheckpointEngine(d, device="cpu")
    assert eng.family == jeng.family
    jcfg, cfg = jeng.model_config(**over), eng.model_config(**over)
    want = {k: v for k, v in dataclasses.asdict(jcfg).items()
            if k != "param_dtype"}
    got = {k: v for k, v in dataclasses.asdict(cfg).items()
           if k != "param_dtype"}
    assert got == want
    ref = flatten_tree(jax.tree.map(np.asarray, jeng.load_params(jcfg)))
    lazy = flatten_tree(eng.load_params(cfg, lazy=True))
    assert any(isinstance(v, Deferred) for v in lazy.values())
    for leaves in (flatten_tree(eng.load_params(cfg)),
                   flatten_tree(materialize(
                       eng.load_params(cfg, lazy=True)))):
        assert set(leaves) == set(ref)
        for key, leaf in leaves.items():
            assert isinstance(leaf, torch.Tensor), key
            got_leaf = leaf.float().numpy()
            assert got_leaf.shape == ref[key].shape, key
            assert got_leaf.tobytes() == ref[key].astype(
                np.float32).tobytes(), key


@pytest.mark.parametrize("name", MOE)
def test_moe_models_are_refused(tmp_path, name):
    """Once refused, the MoE checkpoints now build: the logits of
    ``from_pretrained``'s model agree with ``transformers``' within JAX's
    tolerance (tests/test_hf_checkpoint.py, the same override)."""
    hf, d = _save(tmp_path, name)
    model, _ = from_pretrained(d, device="cpu", **OVERRIDES[name])
    tokens = np.random.default_rng(0).integers(0, 250, (2, 16))
    with torch.no_grad():
        ref = hf(torch.tensor(tokens)).logits.float().numpy()
        ours = model.apply(torch.tensor(tokens)).float().numpy()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(ours, ref, atol=max(2e-4, 1e-3 * scale),
                               rtol=0)
