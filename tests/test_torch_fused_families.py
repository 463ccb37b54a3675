"""The eleven dense model families through the port's fused serving path
at their tiny presets, fp32 on the CPU: ``build_engine(...,
device="cpu").generate_fused(k_steps=4)`` gives the same engine's
per-tick ``generate`` tokens and the JAX engine's ``generate_fused``
tokens, greedy, on the perturbed weights of
tests/test_torch_model_families.py ``_case``
(tests/test_torch_fused_families_wide.py: the same at head dim 256)."""

import pytest

from test_torch_model_families import DENSE
from test_torch_train_families import (  # noqa: F401 (a fixture)
    check_generate_fused, one_torch_thread)


@pytest.mark.parametrize("family", DENSE)
def test_generate_fused_matches_generate_and_jax(family):
    check_generate_fused(family, "tiny")
