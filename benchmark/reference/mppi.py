"""Reference of one MPPI control step of B vehicles (per-step Cholesky
factors of the shifted covariances, the per-step in-kernel draw, the
stochastic rollout under each vehicle's shared disturbance draw,
softmax-weighted mean; the covariance kept at gamma_sigma = 0), from the
observed states, the previous means and covariances, the solve's Philox
key and the vehicles' disturbance draws."""

from __future__ import annotations

import torch

from benchmark.reference import quad


def solve(p: quad.Plant, ctrl: dict, obs: dict, mean_prev, cov_prev, key: int, slots,
          draws, block: int = 256):
    """Returns (new means (B, H, 4), new covariances (B, H, 4, 4), the
    means' sensitivity (B,), ``quad.weighted_mean``).
    ``draws`` (B, 3) are the standard normals of each vehicle's rollout
    force (scaled by the plant's noise scale from step 1 on)."""
    B, H, _ = mean_prev.shape
    N = int(ctrl["N"])
    nominal, covs = quad.shift(mean_prev), quad.shift(cov_prev)
    chol = torch.linalg.cholesky_ex(covs.float() if covs.dtype == torch.bfloat16
                                   else covs).L.to(covs.dtype)
    means, sens = [], []
    for lo in range(0, B, block):
        sl = slice(lo, lo + block)
        x0, t0 = obs["x0"][sl], obs["t0"][sl]
        z = quad.kernel_normals(key, slots[sl], N, H, x0.device).to(x0.dtype)
        acts = quad.clip(nominal[sl, None] + torch.einsum("bhij,bnhj->bnhi", chol[sl], z))
        force = p.dyn_noise_scale * draws[sl]
        costs = quad.rollout_costs(p, x0, t0, obs["pos_traj"][sl], obs["vel_traj"][sl],
                                   acts, force)
        mean, s = quad.weighted_mean(costs, acts, float(ctrl["lam"]))
        means.append(mean)
        sens.append(s)
    return torch.cat(means), covs, torch.cat(sens)
