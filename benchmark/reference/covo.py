"""Reference of one CoVO-online control step of B vehicles (Gauss-Newton
Hessian, Newton-Schulz design, the joint in-kernel draw, deterministic
rollout, softmax-weighted mean), from the observed states, the previous
means and the solve's Philox key."""

from __future__ import annotations

import torch

from benchmark.reference import quad


def solve(p: quad.Plant, ctrl: dict, obs: dict, mean_prev, key: int, slots,
          block: int = 256):
    """Returns (new means (B, H, 4), Sigma (B, D, D), the means'
    sensitivity (B,), ``quad.weighted_mean``). ``obs`` holds the
    observed packed states ``x0`` (B, 16), times ``t0`` (B,) and trajectory
    tables ``pos_traj`` / ``vel_traj`` (B, T, 3); ``slots`` (B,) the
    vehicles' draw slots. Vehicles go through in blocks of ``block``."""
    B, H, _ = mean_prev.shape
    D, N = 4 * H, int(ctrl["N"])
    nominal = quad.shift(mean_prev)
    means, sigmas, sens = [], [], []
    for lo in range(0, B, block):
        sl = slice(lo, lo + block)
        x0, t0 = obs["x0"][sl], obs["t0"][sl]
        R = quad.gn_hessian(p, x0, t0, obs["pos_traj"][sl], obs["vel_traj"][sl],
                            nominal[sl])
        sigma, factor = quad.ns_sigma(R, float(ctrl["sample_sigma"]))
        z = quad.kernel_normals(key, slots[sl], N, D // 4, x0.device)
        z = z.reshape(z.shape[0], N, D).to(x0.dtype)
        acts = quad.clip(nominal[sl].reshape(-1, 1, D) + z @ factor.mT)
        costs = quad.rollout_costs(p, x0, t0, obs["pos_traj"][sl], obs["vel_traj"][sl],
                                   acts.reshape(-1, N, H, 4), x0.new_zeros(x0.shape[0], 3))
        mean, s = quad.weighted_mean(costs, acts, float(ctrl["lam"]))
        means.append(mean.reshape(-1, H, 4))
        sigmas.append(sigma)
        sens.append(s)
    return torch.cat(means), torch.cat(sigmas), torch.cat(sens)
