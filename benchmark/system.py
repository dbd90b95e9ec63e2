"""The system under test: ``covo_mpc_tpu_torch`` built from a configuration
and a traffic file through its public entry points, and one captured
control step that the window replays.

- ``path: "single"`` (one vehicle): ``get_solver``'s solve and
  ``QuadEnv.step`` (with its auto-reset select) captured as one CUDA graph
  with ``runtime.graphs.capture``; the graph writes the carry (obs, state,
  solver params, info) back and the action into a buffer.
- ``path: "batched"`` (a fleet): the batched protocol's runner
  (``runtime.make_batched_episode_runner``), which captures one batched
  control step of the controller's twin and ``BatchedEnv.step``; each
  vehicle draws from its own reset, step and solve generators, seeded from
  the seed and its index.

Either way an episode restarts inside the graph when its state is
terminal, so the window only replays; ``to_restart`` counts the replays
to the next such restart, so that the check can judge it. ``snapshot`` clones the carry, so
that the answers of a replay can be judged once the window has closed;
``eager_step`` runs one step outside the graph, in the spans the traced
run reads.
"""

from __future__ import annotations

import time

import numpy as np
import torch

FIELDS = ("pos", "quat", "vel", "omega", "omega_tar", "pos_tar", "vel_tar", "acc_tar",
          "last_thrust", "last_torque", "time", "vel_hist", "omega_hist", "action_hist",
          "pos_traj", "vel_traj", "acc_traj", "f_disturb")


def vehicle_seeds(seed: int) -> tuple:
    """(solver, reset, step) seeds of the single vehicle from the run's seed."""
    return tuple(int(w) for w in
                 np.random.SeedSequence([seed, 1]).generate_state(3, np.uint64))


def _clone(tree):
    from covo_mpc_tpu_torch.models.structs import tree_flatten, tree_unflatten

    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [t.clone() for t in leaves])


def _fields(state, batched: bool) -> dict:
    return {k: (getattr(state, k) if batched else getattr(state, k)[None]) for k in FIELDS}


def _env(cfg):
    from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv

    e = cfg["env"]
    return QuadEnv(EnvConfig(task=e["task"], enable_randomizer=e["enable_randomizer"],
                             disturb_type=e["disturb_type"],
                             disable_rollover_terminate=e["disable_rollover_terminate"],
                             generate_noisy_state=e["generate_noisy_state"]), device="cuda")


def _to_restart(env, state) -> int:
    """Replays from now to the one whose pre-step state is at the episode's
    last step (the time most vehicles of a fleet share), which restarts it."""
    t = torch.mode(state.time.reshape(-1).long()).values
    return int(env.default_params.max_steps_in_episode - t)


def _solver(cfg, env, seed: int):
    from covo_mpc_tpu_torch.solvers import get_solver

    c = cfg["controller"]
    kw = dict(rng_mode=c["rng_mode"], collect_debug=False, engine=c["engine"], seed=seed)
    if "hessian_mode" in c:
        kw.update(hessian_mode=c["hessian_mode"], sigma_mode=c["sigma_mode"])
    solver, _ = get_solver(env, c["name"], f"N{c['N']}_H{c['H']}_lam{c['lam']}", **kw)
    return solver


class Single:
    """One vehicle: the captured control step over the solve and the env
    step; the action leaves the card every step."""

    closed_loop = True

    def __init__(self, cfg: dict, traffic: dict, seed: int, log=lambda msg: None):
        from covo_mpc_tpu_torch.runtime import graphs

        self.graphs = graphs
        log("port imported")
        self.env = _env(cfg)
        self.seeds = vehicle_seeds(seed)
        self.solver = _solver(cfg, self.env, self.seeds[0])
        log("env and solver built")
        dev = self.env.device
        self.reset_gen = torch.Generator(device=dev)
        self.step_gen = torch.Generator(device=dev)
        self.host_action = torch.empty(self.env.action_dim, pin_memory=True)
        carry = self._first_carry(seed)
        log("reset")
        env, solver, gen = self.env, self.solver, self.step_gen

        def step(carry, env_params, action_out):
            obs, state, cparams, info = carry
            action, cparams, _ = solver(obs, state, env_params, cparams, info)
            obs, state, _, _, info = env.step(gen, state, action, env_params)
            graphs.copy_into(carry, (obs, state, cparams, info))
            action_out.copy_(action)

        self.cap = graphs.capture(step, carry, self.env.default_params,
                                  torch.zeros(self.env.action_dim, device=dev),
                                  streams=[*self.solver.random_streams(), self.step_gen])
        self.captured_at = time.monotonic()
        log("captured")
        graphs.copy_into(self.cap.args[0], carry)
        self.replays = 0

    def _first_carry(self, seed: int):
        s_solve, s_reset, s_step = vehicle_seeds(seed)
        self.solve_seed = s_solve
        self.solver.seed(s_solve)
        self.reset_gen.manual_seed(s_reset)
        self.step_gen.manual_seed(s_step)
        obs, info, state = self.env.reset(self.reset_gen)
        cparams = self.solver.reset(state, self.env.default_params,
                                    self.solver.init_control_params)
        return obs, state, cparams, info

    def start(self, seed: int) -> None:
        """Restart from the seed's reset (no new capture)."""
        self.graphs.copy_into(self.cap.args[0], self._first_carry(seed))
        self.replays = 0

    def replay(self) -> None:
        self.cap.replay()
        self.replays += 1

    def step(self) -> None:
        """One control step as the window runs it: replay, then the action
        to the host and a synchronise."""
        self.replay()
        self.host_action.copy_(self.cap.args[2], non_blocking=True)
        torch.cuda.current_stream().synchronize()

    def snapshot(self) -> dict:
        obs, state, cparams, info = self.cap.args[0]
        return _clone(dict(state=_fields(state, False), obs=_fields(info["noisy_state"], False),
                           mean=cparams.a_mean[None], sigma=cparams.a_cov[None]))

    def record(self, pre: dict) -> dict:
        """The answer of the replay just made, beside its pre-step carry."""
        post = self.snapshot()
        post["action"] = self.host_action.to(post["mean"].device)[None]
        return dict(replay=self.replays, solve_seed=self.solve_seed, slot0=0,
                    pre=pre, post=post)

    def nodes(self) -> int:
        from covo_mpc_tpu_torch.runtime.profiling import graph_nodes

        return graph_nodes(self.cap)

    def to_restart(self) -> int:
        return _to_restart(self.env, self.cap.args[0][1])

    def eager_step(self) -> None:
        obs, state, cparams, info = _clone(self.cap.args[0])
        params = self.cap.args[1]
        with torch.profiler.record_function("bench.solve"):
            action, _, _ = self.solver(obs, state, params, cparams, info)
        with torch.profiler.record_function("bench.env"):
            self.env.step(self.step_gen, state, action, params)


class Batched:
    """A fleet: the batched protocol's captured control step over B
    vehicles, replayed back to back."""

    closed_loop = False

    def __init__(self, cfg: dict, traffic: dict, seed: int, log=lambda msg: None):
        from covo_mpc_tpu_torch.runtime import make_batched_episode_runner

        log("port imported")
        self.env = _env(cfg)
        self.B = int(traffic["vehicles"])
        self.kind = cfg["reference"]
        self.runner = make_batched_episode_runner(self.env, _solver(cfg, self.env, seed),
                                                  steps=1)
        log("env, solver and twin built")
        self.start(seed)
        self.captured_at = time.monotonic()
        log("reset, captured and replayed once")
        self.cap = self.runner.captured[self.B]
        self._gens = None

    def start(self, seed: int) -> None:
        """Reset every vehicle from the seed and replay once (the first call
        captures the step)."""
        self.solve_seed = seed
        self.runner(seed, 0, self.B)
        self.replays = 1

    def replay(self) -> None:
        self.cap.replay()
        self.replays += 1

    step = replay

    def snapshot(self) -> dict:
        obs, state, tcarry, info = self.cap.args[0]
        mean, cov = (tcarry, None) if self.kind == "covo" else tcarry
        out = dict(state=_fields(state, True), obs=_fields(info["noisy_state"], True),
                   mean=mean)
        if cov is not None:
            out["cov"] = cov
        return _clone(out)

    def record(self, pre: dict) -> dict:
        post = self.snapshot()
        post["action"] = post["mean"][:, 0]
        return dict(replay=self.replays, solve_seed=self.solve_seed, slot0=0,
                    pre=pre, post=post)

    def nodes(self) -> int:
        from covo_mpc_tpu_torch.runtime.profiling import graph_nodes

        return graph_nodes(self.cap)

    def to_restart(self) -> int:
        return _to_restart(self.env, self.cap.args[0][1])

    def eager_step(self) -> None:
        if self._gens is None:
            dev = self.env.device
            self._gens = [[torch.Generator(device=dev).manual_seed(1000 * k + b)
                           for b in range(self.B)] for k in range(2)]
        step_gens, solve_gens = self._gens
        obs, state, tcarry, info = _clone(self.cap.args[0])
        params, offset = self.cap.args[1], self.cap.args[2]
        twin, benv = self.runner.twin, self.runner.benv
        with torch.profiler.record_function("bench.solve"):
            action, _ = twin(state, info, params, tcarry, solve_gens, offset)
        with torch.profiler.record_function("bench.env"):
            benv.step(step_gens, state, action, params)


def build(cfg: dict, traffic: dict, seed: int, log=lambda msg: None):
    """The traffic's path (``single`` or ``batched``) built, captured and
    started from ``seed``; ``log`` hears each phase."""
    return {"single": Single, "batched": Batched}[traffic["path"]](cfg, traffic, seed, log)
