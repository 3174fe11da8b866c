"""The port's generic dynamics on the real-URDF ANYmal and Atlas against
jiminy_tpu on the CPU at float64: configuration maps, RNEA, ABA (with
external forces), CRBA, the energies and the Jacobians, as
`tests/test_torch_generic.py` holds them on the toys and random chains
(shared checks in `tests/generic_checks.py`), at 1e-12 absolute.
"""

import pytest

from generic_checks import (
    check_configuration_maps,
    check_dynamics,
    check_jacobians,
    check_models_carry_across,
    make_case,
)


@pytest.fixture(scope="module", params=("anymal", "atlas"))
def case(request):
    return make_case(request.param)


def test_models_carry_across(case):
    check_models_carry_across(case)


def test_configuration_maps_match_jax(case):
    check_configuration_maps(case)


def test_dynamics_match_jax(case):
    check_dynamics(case)


def test_jacobians_match_jax(case):
    check_jacobians(case)
