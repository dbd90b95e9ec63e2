"""Plain PyTorch reference of the quadrotor control step: the plant, the
tracking cost, the H-step rollout, the Gauss-Newton cost Hessian, the
Newton-Schulz covariance design, the Philox draws of the sampling kernels
and the weighted-mean update.

Written from the model's equations and the configuration's constants. It
imports nothing of the program under test and takes nothing it derived:
every input is a state, a mean or a seed that the benchmark reads off the
program's carry or makes itself, and every intermediate (Hessian, Sigma,
factor, normals, samples, costs, weights) is worked out again here.

Every function takes a ``dtype``-carrying tensor and computes in that
dtype: float64 is the yardstick; float32 with TF32 matmuls (and bfloat16
for the env step) is the control that a sound check must reject.

Layout of a packed state (..., 16): pos (3), quat (x, y, z, w) (4), vel
(3), omega (3), force (3). Tensors carry a leading vehicle axis B.
"""

from __future__ import annotations

import math

import torch
from torch.func import hessian, jacfwd, vmap

M64 = (1 << 64) - 1
GOLDEN = 0x9E3779B97F4A7C15


class Plant:
    """The configuration's ``env`` constants as tensors of one dtype."""

    def __init__(self, env: dict, dtype=torch.float64, device="cpu"):
        def t(v):
            return torch.as_tensor(v, dtype=dtype, device=device)

        self.dtype, self.device = dtype, torch.device(device)
        self.m, self.g, self.dt = t(env["m"]), t(env["g"]), float(env["dt"])
        self.max_thrust = t(env["max_thrust"])
        self.max_torque = t(env["max_torque"])
        self.max_omega = t(env["max_omega"])
        self.action_scale = t(env["action_scale"])
        self.alpha = t(env["alpha_bodyrate"])
        self.dyn_noise_scale = float(env["dyn_noise_scale"])
        self.max_steps = int(env["max_steps_in_episode"])
        self.pos_limit = float(env["pos_limit"])


# --- the plant --------------------------------------------------------------


def clip(a):
    """Clip to [-1, 1] as a min of a max (derivative 1/2 at the bounds,
    the model's stated convention)."""
    one = a.new_ones(())
    return torch.minimum(torch.maximum(a, -one), one)


def action_map(p: Plant, a):
    """Normalized action (..., 4) -> (thrust (..., 1), body-rate target
    (..., 3), torque (..., 3))."""
    a = clip(a)
    thrust = (a[..., 0:1] + 1.0) / 2.0 * p.max_thrust
    torque = a[..., 1:4] * p.max_torque
    return thrust, torque / p.max_torque * p.max_omega, torque


def _xyzw(q):
    """Components as (..., 1) slices: under ``torch.func.jacfwd`` a 0-d
    tensor times a Python float has a float64 tangent."""
    return q[..., 0:1], q[..., 1:2], q[..., 2:3], q[..., 3:4]


def quat_mul(q1, q2):
    x1, y1, z1, w1 = _xyzw(q1)
    x2, y2, z2, w2 = _xyzw(q2)
    return torch.cat([w1 * x2 + w2 * x1 + (y1 * z2 - z1 * y2),
                      w1 * y2 + w2 * y1 + (z1 * x2 - x1 * z2),
                      w1 * z2 + w2 * z1 + (x1 * y2 - y1 * x2),
                      w1 * w2 - (x1 * x2 + y1 * y2 + z1 * z2)], dim=-1)


def normalize(q):
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))


def body_step(p: Plant, pos, quat, vel, omega, force, thrust, omega_tar):
    """One explicit Euler step of first-order body-rate dynamics: the
    collective thrust along the body z axis plus the force, gravity on z,
    quaternion kinematics renormalized, body rates relaxing to the target."""
    thrust = thrust * p.action_scale
    omega_tar = omega_tar * p.action_scale
    q = normalize(quat)
    x, y, z, w = _xyzw(q)
    body_z = torch.cat([2.0 * (x * z + w * y), 2.0 * (y * z - w * x),
                        w * w - x * x - y * y + z * z], dim=-1)
    acc = (body_z * thrust + force) / p.m
    acc = torch.cat([acc[..., :2], acc[..., 2:] - p.g], dim=-1)
    q_dot = 0.5 * quat_mul(q, torch.cat([omega, torch.zeros_like(omega[..., :1])], -1))
    return (pos + vel * p.dt, normalize(q + q_dot * p.dt), vel + acc * p.dt,
            p.alpha * omega + (1.0 - p.alpha) * omega_tar)


def step16(p: Plant, x, a, force_next):
    """Packed state (..., 16) under action (..., 4): the dynamics integrate
    the state's own force, and ``force_next`` becomes the next force."""
    thrust, omega_tar, _ = action_map(p, a)
    pos, quat, vel, omega = body_step(p, x[..., 0:3], x[..., 3:7], x[..., 7:10],
                                      x[..., 10:13], x[..., 13:16], thrust, omega_tar)
    return torch.cat([pos, quat, vel, omega, force_next.expand_as(x[..., 13:16])], -1)


# --- the tracking cost --------------------------------------------------------


def _abs(x):
    return torch.where(x >= 0, x, -x)


def reward(pos, vel, quat, pos_tar, vel_tar):
    """Tracking reward with a yaw penalty (the cost model of both
    controllers): 1.3 - 0.05 |v - v*| - barrier(|p - p*|) - 0.2 |yaw|."""
    err_pos = torch.linalg.vector_norm(pos_tar - pos, dim=-1)
    err_vel = torch.linalg.vector_norm(vel_tar - vel, dim=-1)
    log1p = torch.log(err_pos + 1.0)
    barrier = (err_pos * 0.4 + torch.clamp(log1p * 4.0, 0.0, 1.0) * 0.4
               + torch.clamp(log1p * 8.0, 0.0, 1.0) * 0.2
               + torch.clamp(log1p * 16.0, 0.0, 1.0) * 0.1
               + torch.clamp(log1p * 32.0, 0.0, 1.0) * 0.1)
    x, y, z, w = _xyzw(quat)
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z)).squeeze(-1)
    return 1.3 - 0.05 * err_vel - barrier - _abs(yaw) * 0.2


def targets(t0, table, H: int, offset: int = 0):
    """(B, H, 3) rows t0 + offset .. t0 + offset + H - 1 of (B, T, 3)
    tables, held at the last row."""
    T = table.shape[-2]
    idx = torch.clamp(t0[:, None].long() + offset + torch.arange(H, device=t0.device),
                      0, T - 1)
    return torch.gather(table, 1, idx[..., None].expand(*idx.shape, 3))


def rollout_costs(p: Plant, x0, t0, pos_tab, vel_tab, acts, force):
    """Costs (B, N) of N action sequences ``acts`` (B, N, H, 4) from x0 (B,
    16) at times t0 (B,): the negated sum of the rewards of the PRE-step
    states (targets at t0 + h); a sample that reached a terminal state (t
    past the episode, |pos| past the limit) keeps its last reward. Step 0
    integrates x0's force, every later step ``force`` (B, 3)."""
    B, N, H, _ = acts.shape
    ptar, vtar = targets(t0, pos_tab, H), targets(t0, vel_tab, H)
    x = x0[:, None, :].expand(B, N, 16)
    r_prev = d_prev = None
    total = torch.zeros(B, N, dtype=x0.dtype, device=x0.device)
    for h in range(H):
        r = reward(x[..., 0:3], x[..., 7:10], x[..., 3:7], ptar[:, None, h], vtar[:, None, h])
        d = (t0[:, None] + h >= p.max_steps) | (torch.abs(x[..., 0:3]) > p.pos_limit).any(-1)
        if d_prev is not None:
            r = torch.where(d_prev, r_prev, r)
            d = d | d_prev
        total = total + r
        x = step16(p, x, acts[:, :, h], force[:, None, :])
        r_prev, d_prev = r, d
    return -total


# --- the Gauss-Newton Hessian of the H-step cost ------------------------------


def gn_hessian(p: Plant, x0, t0, pos_tab, vel_tab, nominal):
    """(B, D, D): R = -sum_{h < H-1} S_h^T (grad^2 r)(s_{h+1}) S_h, with
    s_{h+1} the 13-dim state after step h of the deterministic rollout of
    the nominal (B, H, 4) from x0 (x0's force in step 0, none after), S_h =
    d s_{h+1} / d a and the reward's targets at t0 + 1 + h. The model's
    step clips the action before its action map, which clips it again."""
    B, H, _ = nominal.shape
    ptar, vtar = targets(t0, pos_tab, H, 1), targets(t0, vel_tab, H, 1)
    zero = nominal.new_zeros(3)

    def states(a_flat, x):
        a = a_flat.reshape(H, 4)
        out = []
        for h in range(H):
            # the step clips the action, then the action map clips it again:
            # a component on a bound has the derivative 1/2 x 1/2 there
            x = step16(p, x, clip(a[h]), zero)
            out.append(x[:13])
        return torch.stack(out)

    def reward13(s, pt, vt):
        return reward(s[0:3], s[7:10], s[3:7], pt, vt)

    def one(a_flat, x, pt, vt):
        S = jacfwd(states)(a_flat, x)  # (H, 13, D)
        s = states(a_flat, x)
        Hr = vmap(hessian(reward13))(s, pt, vt)  # (H, 13, 13)
        mask = (torch.arange(H, device=s.device) < H - 1).to(s.dtype)
        return -torch.einsum("hkd,hkl,hle,h->de", S, Hr, S, mask)

    return vmap(one)(nominal.reshape(B, 4 * H), x0, ptar, vtar)


# --- the Newton-Schulz covariance design ---------------------------------------
# Sigma = c (R + o I)^{-1/2} with o = -lambda_min(R) + 1e-2 and c fixing det
# Sigma = det(sigma^2 I): the configuration's designer ("ns"), whose fixed
# iteration counts and constants are part of what it states.

_LIFT = (3.4445, -4.7750, 2.0315)


def _fro(M):
    return torch.sqrt(torch.sum(M * M, dim=(-2, -1), keepdim=True))


def _unit(M):
    n = _fro(M)
    return M / torch.where(n > 0, n, torch.ones_like(n))


def _vdot(A, B):
    return (A * B).sum(dim=(-2, -1), keepdim=True)


def _lambda_max(B, squarings: int = 14, every: int = 3):
    M = _unit(B)
    for _ in range(-(-squarings // every)):
        for _ in range(every):
            M = M @ M
        M = _unit(M)
    return _vdot(M, B @ M) / (_vdot(M, M) + 1e-30)


def _inv_sqrt(A, lift: int, polish: int):
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    Y, Z = A, eye
    a, b, c = _LIFT
    for _ in range(lift):
        X = Z @ Y
        Q = a * eye + b * X + c * (X @ X)
        Y, Z = Y @ Q, Q @ Z
    for _ in range(polish):
        T = 0.5 * (3.0 * eye - Z @ Y)
        Y, Z = Y @ T, T @ Z
    return Z


def ns_sigma(R, sample_sigma: float):
    """(Sigma, factor) (B, D, D) of the Hessian stack R, the factor the
    lower Cholesky factor of Sigma."""
    D = R.shape[-1]
    R = (R + R.mT) / 2.0
    eye = torch.eye(D, dtype=R.dtype, device=R.device)
    bound = _fro(R) + 1e-30
    lam_rough = bound - _lambda_max(bound * eye - R)
    off1 = -lam_rough + 1e-2 + 5e-3 * (bound - lam_rough)
    s1 = (bound + off1) * 1.05
    Z1 = _inv_sqrt((R + off1 * eye) / s1, 3, 4)
    lam_min = s1 / _lambda_max(Z1 @ Z1) - off1
    offset = -lam_min + 1e-2
    s = (bound + offset) * 1.05 + 1e-30
    Z = _inv_sqrt((R + offset * eye) / s, 8, 5)
    Z = (Z + Z.mT) / 2.0
    L = torch.linalg.cholesky_ex(Z).L
    log_det_A = D * torch.log(s) - 4.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)
                                                   ).sum(-1)[..., None, None]
    log_const = (D * math.log(sample_sigma) * 4.0 + log_det_A) / D
    scale = torch.exp(0.5 * log_const) / torch.sqrt(s)
    return scale * Z, torch.sqrt(scale) * L


# --- the sampling kernels' draws -------------------------------------------------


def splitmix64(x: int) -> int:
    x &= M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return x ^ (x >> 31)


def solve_key(seed: int, k: int) -> int:
    """The 64-bit Philox key of the k-th solve (k = 1, 2, ...) of a solver
    seeded with ``seed``: splitmix64(seed + k * golden), modulo 2^64."""
    return splitmix64(seed + k * GOLDEN)


_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a`` and
    the words ``b`` (int64 tensors), in 16-bit limbs so nothing overflows."""
    a1, a0 = a >> 16, a & 0xFFFF
    b1, b0 = b >> 16, b & 0xFFFF
    mid = a1 * b0 + a0 * b1
    low = a0 * b0 + ((mid & 0xFFFF) << 16)
    return a1 * b1 + (mid >> 16) + (low >> 32), low & _MASK32


def philox4x32_10(c, key: int):
    """Philox4x32-10 of counters c (4 int64 tensors of 32-bit words) under
    the 64-bit key (low word first)."""
    c0, c1, c2, c3 = c
    k0, k1 = key & _MASK32, key >> 32
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & _MASK32, (k1 + 0xBB67AE85) & _MASK32
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def normals4(c, key: int):
    """(..., 4) standard normals of one Philox call as the kernels make
    them: Box-Muller on words (0, 1) and (2, 3) in float32 (u1 in (0, 1]
    from the top 24 bits), returned as float64."""
    r = philox4x32_10(c, key)
    inv24 = 1.0 / 16777216.0
    two_pi = torch.tensor(6.283185307179586, dtype=torch.float32)
    out = []
    for a, b in ((r[0], r[1]), (r[2], r[3])):
        u1 = ((a >> 8).float() + 1.0) * inv24
        u2 = (b >> 8).float() * inv24
        rad = torch.sqrt(-2.0 * torch.log(u1))
        ang = two_pi.to(u2.device) * u2
        out += [rad * torch.cos(ang), rad * torch.sin(ang)]
    return torch.stack(out, dim=-1).double()


def kernel_normals(key: int, slots, N: int, rows: int, device):
    """(B, N, rows, 4) normals: row j of sample n of the vehicle in slot s
    from counter (j, n, 0, s). CoVO's joint draw reads rows = D / 4 (z[n,
    4j .. 4j+3]); MPPI's per-step draw rows = H (z_h[n])."""
    s = torch.as_tensor(slots, dtype=torch.int64, device=device)[:, None, None]
    n = torch.arange(N, dtype=torch.int64, device=device)[None, :, None]
    j = torch.arange(rows, dtype=torch.int64, device=device)[None, None, :]
    shape = (s.shape[0], N, rows)
    c = (j.expand(shape), n.expand(shape), torch.zeros(shape, dtype=torch.int64,
                                                       device=device), s.expand(shape))
    return normals4(c, key)


# --- the update ------------------------------------------------------------------


def weighted_mean(costs, acts, lam: float):
    """(mean, sensitivity): sum_n w_n a_n with w = softmax(-(c - min c) /
    lambda) over the N samples (costs (B, N), acts (B, N, ...)), and per
    vehicle the largest change of a mean component that costs perturbed by
    a relative 1 (|d c_n| <= |c_n| + 1) could make to first order, d m / d
    c_k = -w_k (a_k - m) / lambda: the mean's own conditioning, large
    where the best samples' costs nearly tie."""
    w = torch.exp(-(costs - costs.amin(-1, keepdim=True)) / lam)
    w = w / w.sum(-1, keepdim=True)
    mean = torch.einsum("bn,bn...->b...", w, acts)
    dev = (acts - mean[:, None]).abs().flatten(2)
    sens = torch.einsum("bn,bnd->bd", w * (costs.abs() + 1.0), dev).amax(-1) / lam
    return mean, sens


def shift(x):
    """Receding-horizon shift along axis 1, repeating the last entry."""
    return torch.cat([x[:, 1:], x[:, -1:]], dim=1)


# --- the env step --------------------------------------------------------------------

STATE_FIELDS = ("pos", "quat", "vel", "omega", "omega_tar", "pos_tar", "vel_tar",
                "acc_tar", "last_thrust", "last_torque", "time", "vel_hist",
                "omega_hist", "action_hist", "pos_traj", "vel_traj", "acc_traj")


def env_step(p: Plant, pre: dict, action):
    """The deterministic part of each vehicle's auto-resetting step from
    its pre-step state (dict of (B, ...) tensors) under ``action`` (B, 4):
    ``(post, done)``, post a dict of the fields of STATE_FIELDS. A vehicle
    whose pre-step state is terminal restarts: zero pose and rates, identity
    attitude, time 0, its new trajectory's first row as targets (the
    trajectory itself is a fresh draw, so it is taken from ``pre['new_*']``
    when given, else left out). The force and the observation noise are
    random draws and are not reproduced."""
    a = torch.clamp(action, -1.0, 1.0)
    thrust, omega_tar, torque = action_map(p, a)
    pos, quat, vel, omega = body_step(p, pre["pos"], pre["quat"], pre["vel"],
                                      pre["omega"], pre["f_disturb"], thrust, omega_tar)
    time = pre["time"] + 1
    T = pre["pos_traj"].shape[1]
    idx = torch.clamp(time.long(), 0, T - 1)
    b = torch.arange(idx.shape[0], device=idx.device)
    normed = torch.cat([thrust / p.max_thrust * 2.0 - 1.0, torque / p.max_torque], -1)
    post = dict(pos=pos, quat=quat, vel=vel, omega=omega, omega_tar=omega_tar,
                pos_tar=pre["pos_traj"][b, idx], vel_tar=pre["vel_traj"][b, idx],
                acc_tar=pre["acc_traj"][b, idx], last_thrust=thrust[:, 0],
                last_torque=torque,
                time=time,
                vel_hist=torch.cat([pre["vel_hist"][:, 1:], pre["vel"][:, None]], 1),
                omega_hist=torch.cat([pre["omega_hist"][:, 1:], pre["omega"][:, None]], 1),
                action_hist=torch.cat([pre["action_hist"][:, 1:], normed[:, None]], 1),
                pos_traj=pre["pos_traj"], vel_traj=pre["vel_traj"], acc_traj=pre["acc_traj"])
    done = ((pre["time"] >= p.max_steps)
            | (torch.abs(pre["pos"]) > p.pos_limit).any(-1))
    return post, done


def reset_state(like: dict) -> dict:
    """The restart state's fields, given the post-step state ``like`` (its
    fresh trajectory tables are taken as they are)."""
    out = {k: torch.zeros_like(like[k]) for k in STATE_FIELDS}
    out["quat"][..., 3] = 1.0
    for tab, tar in (("pos_traj", "pos_tar"), ("vel_traj", "vel_tar"),
                     ("acc_traj", "acc_tar")):
        out[tab] = like[tab]
        out[tar] = like[tab][:, 0]
    return out
