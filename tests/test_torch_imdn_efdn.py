"""The port's IMDN (models -1, 26) and EFDN (01) on the CPU against the
torch-reference goldens and the JAX package (checks in
``tests/test_torch_zoo_cases.py``). All three are gated at ``fasthi``."""

import pytest

import test_torch_zoo_cases as cases

IDS = [-1, 1, 26]


@pytest.mark.parametrize("stem", cases.goldens(IDS))
def test_matches_golden(stem):
    cases.check_golden(stem)


@pytest.mark.parametrize("mid", IDS)
def test_matches_jax_parity(mid):
    cases.check_jax_parity(mid)


@pytest.mark.parametrize("mid", IDS)
def test_blocks_match_jax_fasthi(mid):
    cases.check_blocks(mid, "fasthi")


@pytest.mark.parametrize("mid", IDS)
def test_model_matches_jax_fasthi(mid):
    cases.check_fasthi_model(mid)


@pytest.mark.parametrize("mid", IDS)
def test_complexity_matches_jax(mid):
    cases.check_complexity(mid)


@pytest.mark.parametrize("mid", IDS)
def test_weight_carry_consumes_every_key(mid):
    cases.check_weight_carry(mid)


@pytest.mark.parametrize("mid", IDS)
def test_registry_fields_match_jax(mid):
    cases.check_registry_fields(mid)


@pytest.mark.parametrize("mid", IDS)
def test_server_tier(mid):
    cases.check_server_tier(mid, "fasthi")
