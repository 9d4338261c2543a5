"""The port's attention family, IMDTN (09), HNCT (12), MobileSR (20) and
SCET (30), on the CPU against the torch-reference goldens and the JAX
package (checks in ``tests/test_torch_zoo_cases.py``): goldens under
parity, the JAX apply under parity, one block with its attention core and
one other under the gated tier, the JAX complexity count, the weight carry,
the registry's fields and the server's default tier."""

import pytest

import test_torch_zoo_cases as cases

# tier of each model in results/protocol/zoo_sustained_gated.json
GATED = {9: "fast16", 12: "high", 20: "fast16", 30: "fast"}
IDS = sorted(GATED)


@pytest.mark.parametrize("stem", cases.goldens(IDS))
def test_matches_golden(stem):
    cases.check_golden(stem)


@pytest.mark.parametrize("mid", IDS)
def test_matches_jax_parity(mid):
    cases.check_jax_parity(mid)


@pytest.mark.parametrize("mid", IDS)
def test_blocks_match_jax_gated_tier(mid):
    cases.check_blocks(mid, GATED[mid])


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
