"""The port's RFDN skeleton (models 00, 05, 06, 08, 13, 22, 25, 35, 37, 38,
40) on the CPU against the torch-reference goldens and the JAX package
(checks in ``tests/test_torch_zoo_cases.py``)."""

import pytest

import test_torch_zoo_cases as cases

# tier of each model in results/protocol/zoo_sustained_gated.json; "fast"
# is not ported, so those models run under parity
GATED = {0: "fast", 5: "fast", 6: "high", 8: "high", 13: "fasthi", 22: "high", 25: "fasthi",
         35: "fast", 37: "fasthi", 38: "high", 40: "fast"}
IDS = sorted(GATED)


@pytest.mark.parametrize("stem", cases.goldens(IDS))
def test_matches_golden(stem):
    cases.check_golden(stem)


@pytest.mark.parametrize("mid", IDS)
def test_matches_jax_parity(mid):
    cases.check_jax_parity(mid)


@pytest.mark.parametrize("mid", [m for m in IDS if GATED[m] in ("high", "fasthi")])
def test_blocks_match_jax_gated_tier(mid):
    cases.check_blocks(mid, GATED[mid])


@pytest.mark.parametrize("mid", [m for m in IDS if GATED[m] == "fasthi"])
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
    cases.check_server_tier(mid, GATED[mid])


@pytest.mark.parametrize("mid", [m for m in IDS if GATED[m] == "fast"])
def test_fast_tier_blocks_match_jax_parity(mid):
    """The four models gated at the unported ``fast`` tier: their blocks
    under parity (f32), so that the variant blocks (PLAINRFDN's, team35's)
    are held one by one too."""
    cases.check_blocks(mid, "high")
