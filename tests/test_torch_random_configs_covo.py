"""JAX's randomized-config net, its CoVO online cases: the port's solve
against JAX's on the CPU (``tests/test_torch_random_configs.py`` holds the
contract and the env of every case)."""

import pytest

from tests.test_torch_random_configs import online_solve_matches_jax, solved_on_the_cpu


@pytest.mark.parametrize("c", solved_on_the_cpu("covo_online"))
def test_covo_online_solve_matches_jax(c):
    online_solve_matches_jax(c)
