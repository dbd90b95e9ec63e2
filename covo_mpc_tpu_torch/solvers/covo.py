"""CoVO-MPC, online mode: covariance-optimal sampling-based MPC.

Counterpart of :class:`covo_mpc_tpu.solvers.covo.CoVOSolver` with
``mode="online"``. One solve, in order:

1. shift the mean;
2. the Hessian of the H-step cost around it, Gauss–Newton
   (``hessian_mode="gn"``) or the exact adjoint (``"adjoint"``): primal
   K2, local derivatives, chain K3 + pullback;
3. the Newton–Schulz Sigma-designer (matmuls + one Cholesky);
4. the joint sample + rollout: K1 (``rng_mode="kernel"``), or z from the
   solver's device generator, then K4 (``engine="cuda"``,
   ``rng_mode="fast"``) or the plain rollout (``engine="torch"``);
5. softmax weights and the mean update.

A solve never syncs with the host: the per-solve Philox seed comes from a
CPU generator the solver owns. ``engine="cuda"`` runs K1 or K4, K2 and K3
(their wrappers take the plain versions for CPU tensors);
``engine="torch"`` is the plain path. Offline and speculative modes, the
other Hessian estimators and the eigh-free ``ns_pallas`` designer are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch

from covo_mpc_tpu_torch.models.structs import pack_state
from covo_mpc_tpu_torch.ops import covariance, reductions, sampling
from covo_mpc_tpu_torch.ops.hessian import make_hessian_adjoint
from covo_mpc_tpu_torch.ops.rollout_cuda import make_rollout_joint_sampling
from covo_mpc_tpu_torch.solvers.base import BaseSolver, make_cost_rollout


@dataclasses.dataclass
class CoVOParams:
    gamma_mean: float
    gamma_sigma: float
    discount: float
    sample_sigma: float
    a_mean: torch.Tensor  # (H, dA)
    a_cov: torch.Tensor  # (H*dA, H*dA) joint covariance

    def replace(self, **changes) -> "CoVOParams":
        return dataclasses.replace(self, **changes)


def covo_params_from_numpy(leaves: Mapping[str, Any], device="cpu") -> CoVOParams:
    """Build :class:`CoVOParams` from the JAX struct's leaves as numpy
    arrays: scalars as Python floats, arrays as float32 tensors on
    ``device``. The offline/speculative leaves are not read."""
    kw = {}
    for f in dataclasses.fields(CoVOParams):
        v = np.asarray(leaves[f.name])
        kw[f.name] = (float(v) if v.ndim == 0 else
                      torch.from_numpy(v.astype(np.float32)).to(device))
    return CoVOParams(**kw)


class CoVOSolver(BaseSolver):
    def __init__(
        self,
        env,
        control_params: CoVOParams,
        N: int,
        H: int,
        lam: float,
        mode: str = "online",
        rng_mode: str = sampling.FAST,
        hessian_mode: str = "gn",
        collect_debug: bool = False,
        engine: str = "torch",
        sigma_mode: str = "ns",
        seed: int = 0,
    ) -> None:
        super().__init__(env, control_params)
        # TF32 truncates fp32 matmuls the way the TPU's bf16 default did,
        # which NaNs the NS designer's lambda_min refinement
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if mode != "online":
            raise NotImplementedError(f"CoVO mode {mode!r} is not ported yet")
        if hessian_mode not in ("gn", "adjoint"):
            raise NotImplementedError(
                f"hessian_mode {hessian_mode!r} is not ported yet "
                "(use 'gn' or 'adjoint')"
            )
        if collect_debug:
            raise NotImplementedError("debug pose collection is not ported yet")
        if sigma_mode == "ns":
            self._optimize_sigma = covariance.optimize_sigma_ns
        elif sigma_mode == "eigh":
            self._optimize_sigma = covariance.optimize_sigma
        else:
            raise NotImplementedError(f"sigma_mode {sigma_mode!r} is not ported yet")
        self.rollout = make_cost_rollout(env, engine, rng_mode)

        self.N, self.H, self.lam = N, H, lam
        self.mode = mode
        self.rng_mode = rng_mode
        self.engine = engine
        self.action_dim = env.action_dim
        self.D = H * env.action_dim
        part = "cuda" if engine == "cuda" else "torch"
        self._hessian = make_hessian_adjoint(
            env, H, primal=part, tail=part,
            second_order=hessian_mode == "adjoint",
        )
        self.rollout_sampling = (make_rollout_joint_sampling(env)
                                 if rng_mode == sampling.KERNEL else None)
        # CPU generator for the kernel's Philox seeds (no device read per
        # solve), device generator for the fast sampler's normals
        self.generator = torch.Generator()
        self.device_generator = torch.Generator(device=env.device)
        self.seed(seed)

    def seed(self, seed: int) -> None:
        self.generator.manual_seed(seed)
        self.device_generator.manual_seed(seed)

    def get_hessian(self, env_state, env_params, a_mean):
        """R = d^2 cost / d a^2 around the nominal sequence (Gauss–Newton
        or the exact adjoint)."""
        return self._hessian(a_mean.flatten(), pack_state(env_state),
                             env_state.time, env_state.pos_traj,
                             env_state.vel_traj, env_params)

    def __call__(self, obs, env_state, env_params, control_params: CoVOParams,
                 info: Optional[dict] = None, z: Optional[torch.Tensor] = None):
        """One solve. ``z`` (N, D) feeds given standard normals to the
        sampler (tests hand in the ones JAX drew); by default they come
        from the solver's generators."""
        if info is not None and info.get("noisy_state") is not None:
            env_state = info["noisy_state"]

        # shift the mean only — CoVO re-designs Sigma from scratch each step
        a_mean = torch.cat([control_params.a_mean[1:], control_params.a_mean[-1:]])
        R = self.get_hessian(env_state, env_params, a_mean)
        a_cov, factor = self._optimize_sigma(R, control_params.sample_sigma, self.D)

        x0 = pack_state(env_state)
        args = (x0, env_state.time, env_state.pos_traj, env_state.vel_traj)
        if self.rollout_sampling is not None:
            seed = int(torch.randint(0, 2**63 - 1, (), generator=self.generator))
            costs, a_t = self.rollout_sampling(
                *args, a_mean, factor, env_params, seed, self.N,
                deterministic=True, discount=control_params.discount,
                z=None if z is None else z.T.contiguous(),
            )
        else:
            a_t = torch.clamp(
                sampling.sample_joint_t(self.device_generator, a_mean.flatten(),
                                        factor, self.N, z=z),
                -1.0, 1.0,
            )
            costs = self.rollout(*args, a_t, env_params, deterministic=True,
                                 discount=control_params.discount, layout="hdn")

        weight = reductions.mppi_weights(costs, self.lam)
        new_mean = reductions.mean_update_t(
            weight, a_t.reshape(self.H, self.action_dim, self.N), a_mean,
            control_params.gamma_mean,
        )
        control_params = control_params.replace(a_mean=new_mean, a_cov=a_cov)
        return new_mean[0], control_params, {}
