"""The comparison that decides ``correct``.

The window clones the carry around a few replays drawn from the seed (all
vehicles of a fleet, several steps of a single vehicle), and around the
replay in which an episode restarts inside the graph. Once the window
has closed and the program is freed, the plain reference
(``benchmark/reference``) works out each of those steps again from its
pre-step carry: the observed states, the previous means (and MPPI's
covariances), the solve's Philox key from the seed and the solve count,
and MPPI's rollout-force draws from each vehicle's solve generator, seeded
by the batched protocol's rule from the seed and the vehicle's index.

Numbers compared, each the largest over the checked answers:

- ``mean_gap``: the new mean of every vehicle (and the action that left
  the card) against the reference's, the largest component's distance in
  units of EPS x the mean's own sensitivity (``quad.weighted_mean``: how
  far costs off by a relative EPS can move it; large where the best
  samples' costs nearly tie, as at lambda = 0.01 they often do) plus
  FLOOR. The rollout kernel's costs enter through the softmax weights, the
  design through the sampling factor.
- ``sigma_gap`` (a single CoVO vehicle, whose carry holds Sigma): the
  largest entry of |Sigma - Sigma_ref| over the largest of |Sigma_ref|.
- ``env_gap``: every deterministic field of each vehicle's next state (pose,
  rates, targets, time, histories, trajectory; a restarted vehicle's reset
  state) against the reference's env step under the program's action,
  |x - x_ref| / max(1, |x_ref|). The force and the observation noise are
  random draws and are not compared.

The control (``control=True``) puts the reference itself in the program's
place one precision down, as the configuration's ``control`` names it for
each layer: ``tf32`` (float32 with TF32 matmuls: the CoVO solve, whose
time is matmuls) or ``bfloat16`` (the next step down for float32 work that
has no sizeable matmul: MPPI's solve, every env step).
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch

from benchmark.reference import quad

NAMES = ("mean_gap", "sigma_gap", "env_gap")
EPS = 1e-5  # the relative cost error that mean_gap's unit allows for
FLOOR = 1e-4  # and its floor, in action units


def episode_seeds(seed: int, episode: int) -> tuple:
    """The batched protocol's (reset, step, solve) generator seeds of
    vehicle ``episode`` from ``seed``."""
    return tuple(int(w) for w in
                 np.random.SeedSequence([seed, episode]).generate_state(3, np.uint64))


def solve_draws(seed: int, replay: int, B: int, device) -> torch.Tensor:
    """(B, 3) float64: each vehicle's ``replay``-th standard-normal triple
    from its solve generator (one triple a solve)."""
    probe = torch.Generator(device=device)
    probe.manual_seed(0)
    torch.randn(3, generator=probe, device=device)
    step = probe.get_offset()
    out = []
    for b in range(B):
        g = torch.Generator(device=device)
        g.manual_seed(episode_seeds(seed, b)[2])
        g.set_offset((replay - 1) * step)
        out.append(torch.randn(3, generator=g, device=device))
    return torch.stack(out).double()


@contextlib.contextmanager
def tf32(on: bool):
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _cast(d: dict, dtype) -> dict:
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in d.items()}


PRECISION = {"float64": (torch.float64, False), "tf32": (torch.float32, True),
             "bfloat16": (torch.bfloat16, False)}


def _solve(cfg: dict, rec: dict, dtype):
    """The reference's (new means, Sigma or None, the means' sensitivity)
    for a record, in dtype."""
    mod = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    pre = rec["pre"]
    o = _cast(pre["obs"], dtype)
    obs = dict(x0=torch.cat([o["pos"], o["quat"], o["vel"], o["omega"], o["f_disturb"]], -1),
               t0=o["time"], pos_traj=o["pos_traj"], vel_traj=o["vel_traj"])
    B = obs["x0"].shape[0]
    p = quad.Plant(cfg["env"], dtype, obs["x0"].device)
    key = quad.solve_key(rec["solve_seed"], rec["replay"])
    slots = list(range(rec["slot0"], rec["slot0"] + B))
    mean = pre["mean"].to(dtype)
    if cfg["reference"] == "covo":
        return mod.solve(p, cfg["controller"], obs, mean, key, slots)
    draws = solve_draws(rec["solve_seed"], rec["replay"], B, mean.device).to(dtype)
    means, _, sens = mod.solve(p, cfg["controller"], obs, mean, pre["cov"].to(dtype), key,
                               slots, draws)
    return means, None, sens


def _env(cfg: dict, rec: dict, dtype) -> dict:
    """The expected next state of every vehicle of a record in dtype: the
    env step under the program's action, a restart where the pre-step
    state is terminal."""
    pre = _cast(rec["pre"]["state"], dtype)
    p = quad.Plant(cfg["env"], dtype, pre["pos"].device)
    post, done = quad.env_step(p, pre, rec["post"]["action"].to(dtype))
    restart = quad.reset_state(_cast(rec["post"]["state"], dtype))
    return {k: torch.where(done.reshape(-1, *[1] * (v.dim() - 1)), restart[k], v)
            for k, v in post.items()}


def _rel(a, b):
    """Per vehicle: the largest |a - b| / max(1, |b|) over a field's entries."""
    a, b = a.double(), b.double()
    d = (a - b).abs() / torch.clamp(b.abs(), min=1.0)
    return torch.nan_to_num(d.reshape(d.shape[0], -1).amax(-1), nan=float("inf"))


def readings(cfg: dict, rec: dict, control: bool = False) -> dict:
    """Per vehicle of one record, each number's reading: the program's
    answers, or the control's, against the float64 reference."""
    mean_ref, sigma_ref, sens = _solve(cfg, rec, torch.float64)
    env_ref = _env(cfg, rec, torch.float64)
    post = rec["post"]
    if control:
        dtype, on = PRECISION[cfg["control"]["solve"]]
        with tf32(on):
            mean, sigma, _ = _solve(cfg, rec, dtype)
        dtype, on = PRECISION[cfg["control"]["env"]]
        with tf32(on):
            env = _env(cfg, rec, dtype)
        action = mean[:, 0]
        if post.get("sigma") is None:
            sigma = None
    else:
        mean, sigma, env, action = post["mean"], post.get("sigma"), post["state"], post["action"]
    gap = (mean.double() - mean_ref).abs().flatten(1).amax(-1)
    gap = torch.maximum(gap, (action.double() - mean_ref[:, 0]).abs().amax(-1))
    out = dict(mean_gap=torch.nan_to_num(gap / (EPS * sens + FLOOR), nan=float("inf")),
               raw_mean_gap=gap, sensitivity=sens)
    if sigma_ref is not None and sigma is not None:
        d = (sigma.double() - sigma_ref).abs().flatten(1).amax(-1)
        out["sigma_gap"] = torch.nan_to_num(d / sigma_ref.abs().flatten(1).amax(-1),
                                            nan=float("inf"))
    out["env_gap"] = torch.stack([_rel(env[k], env_ref[k]) for k in quad.STATE_FIELDS]
                                 ).amax(0)
    return {k: v.cpu() for k, v in out.items()}


def worst(per: list, k: int = 5) -> list:
    """The ``k`` answers with the largest mean_gap: (record, vehicle,
    mean_gap, raw gap, sensitivity), to look at what drives it."""
    rows = [(i, b, float(r["mean_gap"][b]), float(r["raw_mean_gap"][b]),
             float(r["sensitivity"][b]))
            for i, r in enumerate(per) for b in range(r["mean_gap"].numel())]
    return sorted(rows, key=lambda x: -x[2])[:k]


def judge(cfg: dict, records: list, limits: dict, control: bool = False) -> dict:
    """Every number's largest reading over the records' answers beside its
    limit, the answers checked and those that failed a limit; ``finite``
    holds each number's largest finite reading and how many were not (a
    control whose design overflows reads inf on those answers)."""
    per = [readings(cfg, rec, control) for rec in records]
    numbers, finite, failed, answers = {}, {}, 0, 0
    for name in NAMES:
        vals = [r[name] for r in per if name in r]
        if vals:
            vals = torch.cat(vals)
            numbers[name] = float(vals.max())
            ok = vals[torch.isfinite(vals)]
            finite[name] = dict(largest=float(ok.max()) if ok.numel() else None,
                                nonfinite=int(vals.numel() - ok.numel()))
    for r in per:
        bad = torch.zeros_like(r["mean_gap"], dtype=torch.bool)
        for name in NAMES:
            if name in r:
                bad |= ~(r[name] <= limits[name])
        failed += int(bad.sum())
        answers += bad.numel()
    return dict(numbers=numbers, finite=finite, failed=failed, answers=answers,
                worst=worst(per), correct=bool(records) and failed == 0)
