"""Solver (controller) protocol.

``action, control_params, info = solver(obs, state, env_params,
control_params, env_info)`` — the JAX call signature without the
``rng_act`` key: a solver owns its generators (seeded by :meth:`seed`).
"""

from __future__ import annotations


class BaseSolver:
    def __init__(self, env, control_params) -> None:
        self.env = env
        self.init_control_params = control_params

    def seed(self, seed: int) -> None:
        """Seed the solver's generators (none here)."""

    def reset(self, env_state=None, env_params=None, control_params=None):
        """Return fresh solver params."""
        return self.init_control_params

    def __call__(self, obs, state, env_params, control_params, env_info=None):
        raise NotImplementedError
