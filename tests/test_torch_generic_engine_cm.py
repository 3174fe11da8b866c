"""One engine period of the ANYmal in constraint contact mode (ground
contacts and joint bounds as PGS rows, 28 rows) on the port's generic path
against jiminy_tpu's jitted generic period at float64, from warm-started
states with active rows: `tests/test_torch_generic_engine.py` holds the
spring-damper mode and says how (1e-10 of each output's scale).
"""

from test_torch_generic_engine import check_period


def test_anymal_generic_constrained_period_matches_jax():
    check_period(constraint=True, seed=12)
