"""Two-stage speculative CoVO pipeline over a mesh ``pipe`` axis.

Counterpart of :mod:`covo_mpc_tpu.parallel.pipeline`. Speculative CoVO
(``solvers/covo.py``) cuts a solve into ``act`` (shift, sample, rollout,
update: the obs -> action path) and ``prepare`` (the Hessian and the
designer at the model-predicted next state). This maps the cut onto two
ranks: each control step, pipe rank 0 acts with the factor the design
stage made last step, while pipe rank 1, at the same time on its own
device, designs the factor for the next step. Each stage's product
crosses to the other rank in one masked SUM over the mesh (the new mean,
the min cost and the (D, D) factor in one buffer, each part zero on every
rank but its owner), so every rank returns the same three results.

Staleness contract (JAX's, pipeline.py:17-25): the design stage runs
beside the mean update it cannot see, so it predicts the next state one
deterministic model step along the PRE-update shifted mean (speculative
CoVO's ``prepare`` uses the post-update mean) and designs Σ around that
pre-update nominal. The key split is this mode's own: ``k_act, k_step,
k_prep = split(key, 3)``. ``tests/test_torch_pipeline.py`` holds the step
against a stage-sequential oracle.

A ``samples`` axis inside each pipe row (``make_pipeline_mesh(samples=k)``)
shards the act row's N samples over its k ranks (global-id invariant
draws, the three collectives within the row, as ``parallel/sharded.py``)
while the design row designs the next factor redundantly on its k ranks.
Under the invariant sampler the result is the two-rank pipeline's at any
k. Only sample rank 0 of each row contributes its product to the
exchange.
"""

from __future__ import annotations

import torch

from covo_mpc_tpu_torch.models import dynamics
from covo_mpc_tpu_torch.models.structs import FDIST, VEL
from covo_mpc_tpu_torch.ops import covariance, sampling
from covo_mpc_tpu_torch.ops.hessian import make_hessian_adjoint
from covo_mpc_tpu_torch.ops.rollout import hessian_draws_from_key
from covo_mpc_tpu_torch.parallel.mesh import SAMPLE_AXIS, Mesh
from covo_mpc_tpu_torch.parallel.sharded import (
    MeshSolve,
    check_divisible,
    check_engine,
    local_ids,
    make_covo_local_core,
    shift_mean,
)
from covo_mpc_tpu_torch.utils import prng

PIPE_AXIS = "pipe"
ACT_STAGE = 0  # pipe index running sample / rollout / update
DESIGN_STAGE = 1  # pipe index running the Hessian and the designer


def make_pipeline_mesh(samples: int = 1, device=None) -> Mesh:
    """The (pipe=2[, samples=k]) mesh of the speculative pipeline over the
    job's 2k ranks, row-major: pipe row p holds ranks p k .. p k + k - 1
    (JAX: make_pipeline_mesh)."""
    if samples == 1:
        return Mesh((PIPE_AXIS,), (2,), device)
    return Mesh((PIPE_AXIS, SAMPLE_AXIS), (2, samples), device)


def predict_next_state(env, x0, t0, mean, params, key):
    """The design stage's next state (packed, (16,)): one deterministic
    model step from ``x0`` with ``mean[0]``, the disturbance updated from
    the pre-step state under the draw from ``key`` (JAX's key chain)."""
    det = params.replace(dyn_noise_scale=params.dyn_noise_scale * 0.0)
    u, _ = dynamics.control_to_thrust_omega(torch.clamp(mean[0], -1.0, 1.0), det)
    x1 = dynamics.bodyrate_step(x0, u, det, env._dt)
    draw = env.disturb_from_key(key, deterministic=True)
    f1 = env.disturb_fn(det, x0.new_zeros(3) if draw is None else draw, t0,
                        x0[..., VEL], x0[..., FDIST])
    return torch.cat([x1[..., :13], f1], dim=-1)


class PipelineStep(MeshSolve):
    """``step(x0, t0, pos_traj, vel_traj, a_mean (H, dA), factor (D, D),
    params, key, gamma_mean=1.0, discount=1.0) -> (a_mean_new (H, dA),
    factor_next (D, D), min_cost)``, every input and output replicated:
    ``factor`` is the Σ factor designed last step (cold start:
    :func:`make_init_factor`), ``factor_next`` feeds the next call."""

    def __init__(self, env, mesh, N, H, lam, sample_sigma, axis, engine, rng,
                 hessian_primal, hessian_mode, seed, capture):
        super().__init__(env, mesh, seed, capture)
        if mesh.shape.get(axis) != 2:
            raise ValueError(f"the speculative pipeline has exactly two stages; mesh axis "
                             f"{axis!r} has size {mesh.shape.get(axis)}")
        if hessian_mode not in ("adjoint", "gn"):
            raise ValueError(f"pipeline design stage supports 'adjoint'/'gn', "
                             f"got {hessian_mode!r}")
        engine = check_engine(env, engine)
        self.stage = mesh.index(axis)
        self.samples = mesh.axis(SAMPLE_AXIS) if SAMPLE_AXIS in mesh.shape else None
        k = self.samples.size if self.samples is not None else 1
        self.n_local = check_divisible(N, k)
        self.everyone = mesh.axis(tuple(mesh.shape))
        self.owner = self.samples is None or self.samples.index == 0
        self.N, self.H, self.rng = N, H, rng
        self.dA, self.D = env.action_dim, H * env.action_dim
        self.sample_sigma = sample_sigma
        self.act_core = make_covo_local_core(env, H, lam, engine, rng)
        part = hessian_primal or ("cuda" if engine == "cuda" else "torch")
        self.hess = make_hessian_adjoint(env, H, primal=part, tail=part,
                                         second_order=hessian_mode == "adjoint")

    def _act(self, x0, t0, pos_traj, vel_traj, mean, factor, params, gamma_mean,
             discount, k_act, k_step):
        """CoVO's act with last step's factor on the act row's samples."""
        ax, n = self.samples, self.n_local
        word = None
        if self.rng == sampling.KERNEL:
            word = self.words(ax.size, ax.index) if ax is not None else self.words(1, 0)
        return self.act_core(x0, t0, pos_traj, vel_traj, mean.reshape(-1), factor,
                             gamma_mean, discount, params, k_act, k_step, n_local=n,
                             ids=local_ids(ax, n, x0.device), seed_word=word, axis=ax)

    def _design(self, x0, t0, pos_traj, vel_traj, mean, params, k_prep):
        """The next step's factor at the predicted state around the shifted
        pre-update nominal."""
        x1 = predict_next_state(self.env, x0, t0, mean, params, k_prep)
        R = self.hess(shift_mean(mean).reshape(-1), x1, t0 + 1, pos_traj, vel_traj,
                      params, hessian_draws_from_key(self.env, k_prep, self.H))
        return covariance.optimize_sigma_ns(R, self.sample_sigma, self.D)[1]

    def solve(self, x0, t0, pos_traj, vel_traj, a_mean, factor, params, key,
              gamma_mean=1.0, discount=1.0):
        mean = shift_mean(a_mean)
        k_act, k_step, k_prep = prng.split(key, 3).unbind(-2)
        # one buffer: the factor first (its view stays 16-byte aligned, as
        # the sampling kernels take it), then the mean and the min cost
        DD, n_mean = self.D * self.D, self.H * self.dA
        buf = torch.zeros(DD + n_mean + 1, device=x0.device)
        if self.stage == ACT_STAGE:
            a_new, min_cost = self._act(x0, t0, pos_traj, vel_traj, mean, factor, params,
                                        gamma_mean, discount, k_act, k_step)
            if self.owner:
                buf = torch.cat([buf[:DD], a_new.reshape(-1), min_cost.reshape(1)])
        else:
            f_next = self._design(x0, t0, pos_traj, vel_traj, mean, params, k_prep)
            if self.owner:
                buf = torch.cat([f_next.reshape(-1), buf[DD:]])
        buf = self.everyone.psum(buf)
        return (buf[DD:DD + n_mean].reshape(self.H, self.dA),
                buf[:DD].reshape(self.D, self.D), buf[DD + n_mean])


def make_pipeline_step(env, mesh: Mesh, N: int, H: int, lam: float,
                       sample_sigma: float = 0.5, axis: str = PIPE_AXIS,
                       engine: str = "auto", rng: str = "invariant",
                       hessian_primal=None, hessian_mode: str = "adjoint",
                       seed: int = 0, capture: bool = False) -> PipelineStep:
    """The pipelined speculative-CoVO control step (:class:`PipelineStep`;
    JAX: make_pipeline_step). Raises unless the pipe axis has two ranks and
    the samples axis (if any) divides N. ``engine`` / ``rng`` pick the act
    stage's sampler and rollout as in ``parallel/sharded.py`` (K1 under
    kernel rng, K4 under invariant on ``engine="cuda"``); the design stage
    runs K2 + K3 on ``engine="cuda"`` (``hessian_primal`` overrides). Kernel
    rng: the act row's sample rank s takes word s of the step's words.
    ``capture`` as in ``parallel/sharded.py``."""
    return PipelineStep(env, mesh, N, H, lam, sample_sigma, axis, engine, rng,
                        hessian_primal, hessian_mode, seed, capture)


def make_init_factor(env, H: int, sample_sigma: float = 0.5, hessian_primal: str = "torch",
                     hessian_mode: str = "adjoint"):
    """Cold-start Σ factor for :func:`make_pipeline_step` (JAX:
    make_init_factor): designed at the reset state around the shifted
    nominal, as speculative CoVO's reset designs step 0's. Pass the
    pipeline's ``hessian_mode``. Returns ``init_factor(x0, t0, pos_traj,
    vel_traj, a_mean, params, key) -> factor (D, D)``, the Hessian's draws
    from ``key``."""
    hess = make_hessian_adjoint(env, H, primal=hessian_primal, tail=hessian_primal,
                                second_order=hessian_mode == "adjoint")
    D = H * env.action_dim

    def init_factor(x0, t0, pos_traj, vel_traj, a_mean, params, key):
        R = hess(shift_mean(a_mean).reshape(-1), x0, t0, pos_traj, vel_traj, params,
                 hessian_draws_from_key(env, key, H))
        return covariance.optimize_sigma_ns(R, sample_sigma, D)[1]

    return init_factor
