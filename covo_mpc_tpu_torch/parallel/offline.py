"""CoVO offline's Σ schedule, its designs sharded over a rank mesh.

Counterpart of :mod:`covo_mpc_tpu.parallel.offline`. ``CoVOSolver``'s
offline reset (``solvers/covo.py``) runs a sequential phase 1, the PID
expansion episode of max_steps model steps, then an embarrassingly
parallel phase 2, one nominal rollout, Hessian and design a state
(``CoVOSolver.offline_sigma_at``). Here phase 1 runs replicated on every
rank (the same key chain, or the same seeded generator, so the same
states), phase 2's states are split over the mesh axis, each rank designs
its block, and the (max_steps, D, D) schedule is assembled with an
``all_gather``. A step count the ranks do not divide is padded with the
first states (their designs are made and dropped), as JAX pads. The
values are the single-device reset's: the same states, keys and draws go
into each design. Nothing is communicated but the schedule itself.
"""

from __future__ import annotations

import dataclasses

import torch

from covo_mpc_tpu_torch.models.structs import EnvState3D
from covo_mpc_tpu_torch.parallel.mesh import SAMPLE_AXIS, Mesh


def _pad_and_shard(x, pad: int, ax, dim: int = 0):
    """``x`` padded on ``dim`` with its first ``pad`` entries, then this
    rank's block of it along the axis (None stays None)."""
    if x is None:
        return None
    if pad:
        x = torch.cat([x, x.narrow(dim, 0, pad)], dim=dim)
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.index * n, n)


def _shard_states(states: EnvState3D, pad: int, ax) -> EnvState3D:
    return EnvState3D(**{
        f.name: (_pad_and_shard(getattr(states, f.name), pad, ax)
                 if f.name != "control_params" else states.control_params)
        for f in dataclasses.fields(EnvState3D)
    })


def make_distributed_offline_schedule(solver, mesh: Mesh, axis: str = SAMPLE_AXIS):
    """Shard a CoVO-offline solver's Σ-schedule over ``mesh`` (JAX:
    make_distributed_offline_schedule).

    Returns ``schedule(env_state, env_params, control_params, key=None) ->
    control_params'``, a drop-in for ``solver.reset`` with the single
    device's values. ``key`` is JAX's ``rng_control`` for a key-drawing
    solver (parity, invariant), whose phase 1 and designs draw from its
    chain; otherwise the solver's device generator draws phase 1's
    disturbances and, under "periodic" / "mixed", the nominal rollouts'
    and Hessians' uniforms for every state at once, in the single reset's
    order, and each rank takes its block (so seed the solver alike on every
    rank)."""
    if getattr(solver, "mode", None) != "offline":
        raise ValueError("requires a CoVOSolver with mode='offline'")
    ax = mesh.axis(axis)
    T = solver.env.default_params.max_steps_in_episode
    pad = (-T) % ax.size

    def schedule(env_state, env_params, control_params=None, key=None):
        if control_params is None:
            control_params = solver.init_control_params
        keys = disturb = step_draws = hess_draws = None
        if solver.draws_from_keys:
            keys, disturb = solver.offline_schedule_keys(solver._key(key))
        states = solver.offline_schedule_inputs(env_state, env_params, disturb)
        if not solver.draws_from_keys:
            step_draws, hess_draws = solver._draw(solver.H, T), solver._draw(T, solver.H)
        cov, factor = solver.offline_sigma_at(
            _shard_states(states, pad, ax), env_params, control_params.sample_sigma,
            _pad_and_shard(keys, pad, ax), _pad_and_shard(step_draws, pad, ax, dim=1),
            _pad_and_shard(hess_draws, pad, ax))
        return control_params.replace(a_cov_offline=ax.all_gather(cov)[:T],
                                      a_factor_offline=ax.all_gather(factor)[:T])

    return schedule
