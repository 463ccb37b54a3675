"""The eleven dense model families through the port's fused serving path
widened to head dim 256 (GPT-J-6B's), fp32 on the CPU, as
tests/test_torch_fused_families.py holds them at their tiny presets."""

import pytest

from test_torch_model_families import DENSE
from test_torch_train_families import (  # noqa: F401 (a fixture)
    check_generate_fused, one_torch_thread)


@pytest.mark.parametrize("family", DENSE)
def test_generate_fused_matches_generate_and_jax_wide(family):
    check_generate_fused(family, "d256")
