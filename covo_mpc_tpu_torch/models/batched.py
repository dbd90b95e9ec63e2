"""B episodes of one env stepped at once: the env side of the batched protocol.

Counterpart of what ``jax.vmap`` makes of :class:`covo_mpc_tpu.models.
QuadEnv`'s ``reset`` and auto-resetting ``step`` in
:func:`covo_mpc_tpu.runtime.eval.evaluate_batched`. No new env code: the
pure methods (:meth:`QuadEnv.reset_from_draws`, :meth:`QuadEnv.
step_from_draws`) and the auto-reset select (``tree_select``) run under
``torch.func.vmap`` over the tensor leaves of the stacked states, draws and
infos (``structs.vmap_trees``), with one ``env_params`` shared by every
episode, as JAX passes one to each. Each episode draws from its own
generators (:meth:`draw_reset`, :meth:`draw_step`: a list of B generators,
one draw each, stacked), as JAX splits one key per episode, so an
episode's trajectory does not depend on the other episodes of its batch.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from covo_mpc_tpu_torch.models.quad_env import QuadEnv, ResetDraws, StepDraws
from covo_mpc_tpu_torch.models.structs import EnvParams3D, stack, tree_select, vmap_trees
from covo_mpc_tpu_torch.utils import prng

Source = Union[Sequence[torch.Generator], torch.Tensor]


class BatchedEnv:
    """``env`` over B episodes: every state, draw, obs and info carries a
    leading episode axis on its tensor leaves (``structs.stack``)."""

    def __init__(self, env: QuadEnv):
        self.env = env

    def _params(self, params: Optional[EnvParams3D]) -> EnvParams3D:
        return self.env.default_params if params is None else params

    # -- draws: one per episode, from the episode's own generator or key -------
    def draw_reset(self, src: Source) -> ResetDraws:
        if prng.is_key(src):
            return vmap_trees(self.env.draw_reset, (src,))
        return stack([self.env.draw_reset(g) for g in src])

    def draw_step(self, src: Source) -> StepDraws:
        if prng.is_key(src):
            return vmap_trees(self.env.draw_step, (src,))
        return stack([self.env.draw_step(g) for g in src])

    # -- pure: given draws --------------------------------------------------------
    def reset_from_draws(self, draws: ResetDraws, params: Optional[EnvParams3D] = None):
        """Returns (obs, info, state), each batched."""
        return vmap_trees(self.env.reset_from_draws, (draws,), (self._params(params),))

    def step_from_draws(self, step_draws: StepDraws, reset_draws: ResetDraws, state,
                        action: torch.Tensor, params: Optional[EnvParams3D] = None):
        """The auto-resetting step (:meth:`QuadEnv.step`) of every episode
        under its step and reset draws: returns (obs, state, reward, done,
        info), each batched; the select on each episode's ``done`` runs
        inside the vmapped function."""
        env = self.env

        def one(sd, rd, st, a, p):
            obs_st, st_st, reward, done, info = env.step_from_draws(sd, st, a, p)
            obs_re, info_re, st_re = env.reset_from_draws(rd, p)
            return (torch.where(done, obs_re, obs_st), tree_select(done, st_re, st_st),
                    reward, done, tree_select(done, info_re, info))

        return vmap_trees(one, (step_draws, reset_draws, state, action),
                          (self._params(params),))

    # -- from generators or keys ------------------------------------------------------
    def reset(self, src: Source, params: Optional[EnvParams3D] = None):
        """Each episode's reset from its generator or key: (obs, info, state)."""
        return self.reset_from_draws(self.draw_reset(src), params)

    def step(self, src: Source, state, action: torch.Tensor,
             params: Optional[EnvParams3D] = None):
        """Each episode's auto-resetting step: its step draws, then its reset
        draws, from its generator (the order of :meth:`QuadEnv.step`), or
        from its key split as JAX's step splits it (``key, key_reset``)."""
        if prng.is_key(src):
            step_keys, reset_keys = prng.split(src).unbind(-2)
            return self.step_from_draws(self.draw_step(step_keys),
                                        self.draw_reset(reset_keys), state, action, params)
        draws = [(self.env.draw_step(g), self.env.draw_reset(g)) for g in src]
        return self.step_from_draws(stack([d[0] for d in draws]),
                                    stack([d[1] for d in draws]), state, action, params)
