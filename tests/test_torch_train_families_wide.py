"""Training the dense model families at head dims 96 and 256 against the
JAX package's, fp32 on the CPU (tests/test_torch_train_families.py holds
tiny and D 80, and says what each check holds and at which bounds)."""

import pytest

from deepspeed_tpu_torch.models.transformer import REMAT_POLICIES
from test_torch_model_families import DENSE
from test_torch_train_families import (  # noqa: F401 (a fixture)
    check_loss_and_grads, check_policy, check_policy_and_chunk_vs_jax,
    one_torch_thread)


@pytest.mark.parametrize("width", ["d96", "d256"])
@pytest.mark.parametrize("family", DENSE)
def test_loss_and_grads_match_jax_wide(family, width):
    check_loss_and_grads(family, width)


@pytest.mark.parametrize("policy", REMAT_POLICIES)
@pytest.mark.parametrize("width", ["d96", "d256"])
@pytest.mark.parametrize("family", DENSE)
def test_remat_policy_matches_no_remat_wide(family, width, policy):
    check_policy(family, width, policy)


@pytest.mark.parametrize("width", ["d96", "d256"])
@pytest.mark.parametrize("family", DENSE)
def test_remat_and_loss_chunk_match_jax_wide(family, width):
    check_policy_and_chunk_vs_jax(family, width)

