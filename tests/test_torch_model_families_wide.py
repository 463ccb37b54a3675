"""The model families' v2 engines against the JAX package's at head dims
96 and 256 (tests/test_torch_model_families.py holds the rest: the
registry, the presets, parameters and logits at every width, the
engines at tiny and D 80): greedy tokens of ``build_engine(...,
device="cpu")`` equal to the JAX ``build_engine``'s on the same
perturbed weights."""

import pytest

from test_torch_model_families import DENSE, check_engine_tokens


@pytest.mark.parametrize("width", ["d96", "d256"])
@pytest.mark.parametrize("family", DENSE)
def test_build_engine_greedy_tokens_match_jax_wide(family, width):
    check_engine_tokens(family, width)
