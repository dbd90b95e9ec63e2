"""Solver factory + hyperparameter parsing (the packed "N{N}_H{H}_lam{lam}"
string of the JAX factory): "pid", "random", "mppi" and the CoVO modes.

``get_solver``'s defaults are JAX's: the reference-parity path
(``rng_mode="parity"``, ``hessian_mode="fwd_fwd"``, ``sigma_mode="eigh"``,
``collect_debug=True``, on the plain engine, which ``engine="auto"``
picks under ``collect_debug`` as JAX picks "jnp"). The fast path on the
card names its settings: :data:`FAST_PATH`.
"""

from __future__ import annotations

import torch

from covo_mpc_tpu_torch.ops import covariance, sampling
from covo_mpc_tpu_torch.solvers.base import RandomSolver, resolve_engine
from covo_mpc_tpu_torch.solvers.covo import CoVOParams, CoVOSolver
from covo_mpc_tpu_torch.solvers.mppi import MPPIParams, MPPISolver
from covo_mpc_tpu_torch.solvers.pid import PIDParams, PIDSolver

DEFAULT_N = 8192
DEFAULT_H = 32
DEFAULT_LAM = 0.01
DEFAULT_SIGMA = 0.5

# the settings of the main path's fast solves (the port's defaults before it
# took JAX's): torch-generator draws, Gauss–Newton, Newton–Schulz, no poses
FAST_PATH = dict(rng_mode=sampling.FAST, hessian_mode="gn", sigma_mode="ns",
                 collect_debug=False)


def parse_sample_params(param_text: str):
    """Parse "N{N}_H{H}_lam{lam}" -> (N, H, lam, sigma)."""
    if param_text == "" or param_text is None:
        return DEFAULT_N, DEFAULT_H, DEFAULT_LAM, DEFAULT_SIGMA
    parts = param_text.split("_")
    return int(parts[0][1:]), int(parts[1][1:]), float(parts[2][3:]), DEFAULT_SIGMA


def hover_sequence(env, H: int) -> torch.Tensor:
    """Initial nominal sequence (H, 4): normalized hover thrust, zero body
    rates, on the env's device."""
    p = env.default_params
    thrust = (p.m * p.g / p.max_thrust) * 2.0 - 1.0
    zero = torch.zeros_like(thrust)
    return torch.stack([thrust, zero, zero, zero]).expand(H, 4).clone()


def resolve_hessian_mode(env, hessian_mode: str, rng_mode: str) -> str:
    """Resolve ``hessian_mode="auto"`` as JAX does: the adjoint estimator,
    except under the parity sampler, which keeps the reference's own
    estimator (fwd_fwd)."""
    if hessian_mode != "auto":
        return hessian_mode
    return covariance.FWD_FWD if rng_mode == sampling.PARITY else "adjoint"


def resolve_sigma_mode(sigma_mode: str, rng_mode: str) -> str:
    """Resolve ``sigma_mode="auto"`` as JAX does: the Newton–Schulz
    designer, eigh under the parity sampler."""
    if sigma_mode != "auto":
        return sigma_mode
    return "eigh" if rng_mode == sampling.PARITY else "ns"


def get_solver(
    env,
    name: str,
    controller_params: str = "",
    debug: bool = False,
    rng_mode: str = sampling.PARITY,
    hessian_mode: str = covariance.FWD_FWD,
    collect_debug: bool = True,
    engine: str = "auto",
    sigma_mode: str = "eigh",
    seed: int = 0,
    collect_metrics: bool = False,
):
    """Build (solver, control_params) by name: "pid", "random", "mppi", or
    any name containing "covo" (the mode by substring, as the reference:
    "offline", then "spec" / "latency" for speculative, else online).
    The defaults are JAX's (the module docstring); ``**FAST_PATH`` names the
    main path's. ``engine="auto"`` runs the plain path under
    ``collect_debug`` or for an env on the CPU, else the CUDA kernels.
    ``hessian_mode`` and ``sigma_mode`` are CoVO's ("auto" resolves as
    JAX's factory does). ``collect_metrics`` makes MPPI and CoVO report each
    solve's health in ``info["metrics"]``."""
    if name == "pid":
        params = PIDParams.default(env.device, Kp=10.0, Kd=5.0, Ki=0.0, Kp_att=10.0)
        return PIDSolver(env, params), params
    if name == "random":
        return RandomSolver(env, None, seed=seed, rng_mode=rng_mode), None
    if name != "mppi" and "covo" not in name:
        raise NotImplementedError(f"unknown controller {name!r}")
    N, H, lam, sigma = parse_sample_params(controller_params)
    if debug:
        N, H = 4, 2  # fast-feedback smoke config
    engine = resolve_engine(env, engine, collect_debug)
    if name == "mppi":
        a_cov = (torch.eye(env.action_dim, device=env.device) * sigma**2).expand(
            H, env.action_dim, env.action_dim).contiguous()
        params = MPPIParams(
            gamma_mean=1.0,
            gamma_sigma=0.0,
            discount=1.0,
            sample_sigma=sigma,
            a_mean=hover_sequence(env, H),
            a_cov=a_cov,
            # carried factor: the sampler reads it every solve, and the
            # gamma_sigma == 0 update leaves it as it is
            a_cov_chol=torch.linalg.cholesky(a_cov).contiguous(),
        )
        solver = MPPISolver(env, params, N=N, H=H, lam=lam, rng_mode=rng_mode,
                            collect_debug=collect_debug, engine=engine, seed=seed,
                            collect_metrics=collect_metrics)
        return solver, params
    if "offline" in name:
        mode = "offline"
    elif "spec" in name or "latency" in name:
        mode = "speculative"
    else:
        mode = "online"
    D = H * env.action_dim
    eye = torch.eye(D, device=env.device)
    params = CoVOParams(
        gamma_mean=1.0,
        gamma_sigma=0.0,
        discount=1.0,
        sample_sigma=sigma,
        a_mean=hover_sequence(env, H),
        a_cov=eye * sigma**2,
        # isotropic cold-start factor for step 0 when reset() is given no
        # state to design from (factor @ factor.T == a_cov)
        a_factor=eye * sigma if mode == "speculative" else None,
    )
    solver = CoVOSolver(
        env, params, N=N, H=H, lam=lam, mode=mode, rng_mode=rng_mode,
        hessian_mode=resolve_hessian_mode(env, hessian_mode, rng_mode),
        collect_debug=collect_debug, engine=engine,
        sigma_mode=resolve_sigma_mode(sigma_mode, rng_mode), seed=seed,
        collect_metrics=collect_metrics,
    )
    return solver, params
