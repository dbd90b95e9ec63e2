"""The port's disturbance models ("periodic", "sin", "drag", "mixed")
against the JAX package: the models, the env step, the plain rollout and
the kernels' packing (dist table and draw), the 13- and 16-dim Hessians, and
CoVO / MPPI solves under drag and mixed.

Every random number enters the port as a tensor, so these tests hand it the
numbers JAX drew from its keys: the uniforms of "periodic" / "mixed" (one
per rollout, one per Hessian step), the normals of the samplers. JAX's
Pallas rollouts run in interpret mode, as the JAX package's own tests run
them on the CPU. Small sizes: N=256, H=8, tracking_zigzag, t0 = 47 so that
the horizon crosses a redraw (disturb_period = 50), a start force of
(0.02, -0.01, 0.015) and non-zero disturb_params (the wind and the sinusoid),
as tests/test_pallas_rollout.py:169-180 sets them. Tolerances: the models
and the env step atol 1e-5 (fp32 in another order); rollout costs atol 2e-4,
rtol 1e-5 (the JAX kernel tests'); tables 1e-6; the Hessians relative
Frobenius 1e-5 (as tests/test_torch_ops.py); one solve 2e-4 (BASELINE.md's
per-solve contract).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covo_mpc_tpu.models import dynamics as jdyn
from covo_mpc_tpu.models import pack_state as jpack
from covo_mpc_tpu.ops import hessian as jhess
from covo_mpc_tpu.ops.hessian import make_hessian_adjoint as j_hessian_adjoint
from covo_mpc_tpu.ops.rollout import make_rollout as j_make_rollout
from covo_mpc_tpu.ops.rollout_pallas import _pack_kernel_inputs as j_pack
from covo_mpc_tpu.ops.rollout_pallas import build_kernel_disturb as j_build_kernel_disturb
from covo_mpc_tpu.ops.rollout_pallas import make_pallas_rollout as j_pallas_rollout
from covo_mpc_tpu.ops.rollout_pallas import make_pallas_rollout_batched as j_rollout_batched
from covo_mpc_tpu.solvers import get_solver as j_get_solver
from covo_mpc_tpu.solvers.factory import hover_sequence as j_hover
from covo_mpc_tpu_torch.models import dynamics, pack_state
from covo_mpc_tpu_torch.models.quad_env import StepDraws
from covo_mpc_tpu_torch.models.structs import stack_params
from covo_mpc_tpu_torch.ops import rollout_cuda
from covo_mpc_tpu_torch.ops.hessian import make_hessian_adjoint, make_hessian_batched
from covo_mpc_tpu_torch.ops.rollout import make_rollout
from covo_mpc_tpu_torch.solvers import covo_params_from_numpy, get_solver, mppi_params_from_numpy
from tests.test_torch_models import (
    assert_states_close,
    leaves,
    make_envs,
    obs_noise_from_key,
    t,
    to_torch_params,
    to_torch_state,
)

N, H = 256, 8
D = 4 * H
T0 = 47  # a redraw (t % 50 == 0) falls inside the horizon
F0 = np.array([0.02, -0.01, 0.015], np.float32)
KINDS = ["periodic", "sin", "drag", "mixed"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _wind(seed=0):
    """disturb_params (6,): the drag's wind (first 3) and the sinusoid's
    amplitude / period / phase factors."""
    return np.random.default_rng(seed).uniform(-1.0, 1.0, 6).astype(np.float32)


def _uniform(key, params):
    """The uniform draw JAX's periodic / mixed models make from ``key``."""
    s = params.disturb_scale
    return jax.random.uniform(key, (3,), minval=-s, maxval=s)


def _rollout_draw(kind, step_key, params, fast=False):
    """The draw a JAX rollout under ``kind`` shares, in the port's form."""
    if kind not in dynamics.UNIFORM_DRAW:
        return None
    return t(_uniform(jdyn.derive_dynamics_keys(step_key, fast=fast), params))


def _hessian_draws(key, params, n=H):
    """The per-step uniforms of JAX's Hessian key chain
    (hessian.build_hessian_aux_table / build_hessian_disturb_table)."""
    out = []
    for _ in range(n):
        rng_act, key = jax.random.split(key)
        out.append(np.asarray(_uniform(jdyn.derive_dynamics_keys(rng_act), params)))
    return t(np.stack(out))


@functools.lru_cache(maxsize=None)
def _setup(kind, wind=True):
    """JAX env + params (with the wind) and a noisy reset state at T0 with
    the start force F0, and the port's copies."""
    jenv, env = make_envs(disturb_type=kind)
    jp = jenv.default_params
    if wind:
        jp = jp.replace(disturb_params=jnp.asarray(_wind()))
    _, info, _ = jenv.reset_env(jax.random.PRNGKey(0), jp)
    noisy = info["noisy_state"].replace(time=jnp.int32(T0),
                                        f_disturb=jnp.asarray(F0))
    return jenv, env, jp, noisy, to_torch_params(jp), to_torch_state(noisy)


# --- the models -------------------------------------------------------------


@pytest.mark.parametrize("kind", ["gaussian", "none"] + KINDS)
def test_disturb_fns_match_jax(kind):
    """Each model against JAX's on the same draw, at times on and off a
    redraw, for 64 velocities and forces."""
    jp = make_envs()[0].default_params.replace(disturb_params=jnp.asarray(_wind(1)))
    p = to_torch_params(jp)
    rng = np.random.default_rng(2)
    vel = rng.normal(size=(64, 3)).astype(np.float32) * 2.0
    f = rng.normal(size=(64, 3)).astype(np.float32) * 0.1
    key = jax.random.PRNGKey(4)
    for time in (0, 37, 50, 51):
        ref = jdyn.get_disturb_fn(kind)(key, jp, time, vel, f)
        if kind == "gaussian":
            draw = t(jax.random.normal(key, (3,)))
        elif kind in dynamics.UNIFORM_DRAW:
            draw = t(_uniform(key, jp))
        else:
            draw = None
        got = dynamics.get_disturb_fn(kind)(p, draw, torch.tensor(time, dtype=torch.int32),
                                            t(vel), t(f))
        np.testing.assert_allclose(np.broadcast_to(got.numpy(), (64, 3)),
                                   np.asarray(ref), atol=1e-6, err_msg=f"{kind} t={time}")


def test_drag_derivative_at_zero_relative_velocity():
    """|rel_v| takes JAX's derivative at 0: d^2(x|x|)/dx^2 = 2 there (torch.abs
    would give 0), so the exact Hessian under drag keeps its curvature."""
    p = make_envs(disturb_type="drag")[1].default_params
    jp = make_envs(disturb_type="drag")[0].default_params
    fj = lambda v: jdyn.drag_disturb(None, jp, None, v, None)[0]  # noqa: E731
    ref = jax.hessian(fj)(jnp.zeros(3))
    got = torch.func.hessian(
        lambda v: dynamics.drag_disturb(p, None, None, v, None)[0])(torch.zeros(3))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-7)
    assert float(got[0, 0]) != 0.0


@pytest.mark.parametrize("kind", KINDS)
def test_step_from_draws_matches_jax(kind):
    """Five env steps from t = 48 (a redraw at 50), each fed the draws JAX's
    step_env made; the port starts every step from the JAX state."""
    jenv, env, jp, noisy, p, _ = _setup(kind)
    _, _, jstate = jenv.reset_env(jax.random.PRNGKey(2), jp)
    jstate = jstate.replace(time=jnp.int32(48), f_disturb=jnp.asarray(F0))
    rng = np.random.default_rng(4)
    key = jax.random.PRNGKey(9)
    for i in range(5):
        key, k = jax.random.split(key)
        action = rng.uniform(-1.1, 1.1, size=4).astype(np.float32)
        ref = jenv.step_env(k, jstate, action, jp)
        draws = StepDraws(disturb=_rollout_draw(kind, k, jp),
                          obs_noise=obs_noise_from_key(jax.random.split(k)[0]))
        got = env.step_from_draws(draws, to_torch_state(jstate), t(action), p)
        assert_states_close(got[1], ref[1], msg=f"{kind} step {i}")
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-5)
        jstate = ref[1]


def test_draw_disturb_kinds():
    """What each model draws: normals (gaussian / none, none when
    deterministic), uniforms in [-scale, scale) (periodic / mixed, also when
    deterministic), nothing (sin / drag)."""
    gen = torch.Generator().manual_seed(0)
    for kind in ["gaussian", "none"] + KINDS:
        env = make_envs(disturb_type=kind)[1]
        d = env.draw_disturb(gen, 4, 5)
        det = env.draw_disturb(gen, 5, deterministic=True)
        if kind in ("gaussian", "none"):
            assert d.shape == (4, 5, 3) and det is None
        elif kind in dynamics.UNIFORM_DRAW:
            assert d.shape == (4, 5, 3) and det.shape == (5, 3)
            assert float(d.abs().max()) <= 0.2
        else:
            assert d is None and det is None


# --- the plain rollout and the kernels' packing -----------------------------


@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_rollout_matches_pallas_and_jnp(kind, deterministic):
    """The plain rollout (engine="torch", the kernels' plain version) against
    the Pallas rollout in interpret mode and JAX's jnp rollout, fed the
    uniform JAX draws from the step key (deterministic rollouts too: only the
    gaussian scale is zeroed)."""
    jenv, env, jp, noisy, p, st = _setup(kind)
    actions = (np.random.default_rng(1).normal(size=(N, H, 4)) * 0.4).astype(np.float32)
    key = jax.random.PRNGKey(3)
    args = (jpack(noisy), T0, noisy.pos_traj, noisy.vel_traj, actions, jp, key)
    kw = dict(deterministic=deterministic, discount=0.99)
    ref_jnp, _ = j_make_rollout(jenv)(*args, **kw)
    ref_pl, _ = j_pallas_rollout(jenv, interpret=True)(*args, **kw)
    draw = _rollout_draw(kind, key, jp)
    got = make_rollout(env)(pack_state(st), st.time, st.pos_traj, st.vel_traj,
                            t(actions), p, draw, **kw)
    for ref in (ref_jnp, ref_pl):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-5)
    # the K4 wrapper's plain route is the same function, launching nothing
    launches = rollout_cuda.ROLLOUT_KERNEL.launches
    got4 = rollout_cuda.make_rollout_costs(env)(
        pack_state(st), st.time, st.pos_traj, st.vel_traj, t(actions), p, draw, **kw)
    assert rollout_cuda.ROLLOUT_KERNEL.launches == launches
    np.testing.assert_array_equal(got4.numpy(), got.numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_build_kernel_disturb_matches_jax(kind):
    """The kernels' (dist, draw) and the whole operand pack against JAX's,
    given JAX's uniform: "table" the chained force of each step, "drag"
    zeros and the draw, "mixed" the sin values at t0 + h and the draw."""
    jenv, env, jp, noisy, p, st = _setup(kind)
    key = jax.random.PRNGKey(3)
    table, jdraw = j_build_kernel_disturb(jenv, jpack(noisy), noisy.time, jp, key,
                                          False, H)
    # JAX packs the uniform under drag too (its kernel reads none there)
    draw = t(_uniform(jdyn.derive_dynamics_keys(key), jp))
    dist, kdraw = rollout_cuda.build_kernel_disturb(env, pack_state(st), st.time, p,
                                                    draw, False, H)
    assert rollout_cuda.disturb_mode(env) == {"periodic": "table", "sin": "table"}.get(
        kind, kind)
    np.testing.assert_allclose(dist.numpy(), np.asarray(table).reshape(-1), atol=1e-6)
    np.testing.assert_allclose(kdraw.numpy(), np.asarray(jdraw), atol=1e-7)
    ours = rollout_cuda._pack_kernel_inputs(env, pack_state(st), st.time, st.pos_traj,
                                            st.vel_traj, p, draw, False, 0.98, H)
    ref = j_pack(jenv, jpack(noisy), noisy.time, noisy.pos_traj, noisy.vel_traj, jp,
                 key, False, 0.98, H)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)


def test_rollouts_need_the_uniform_draw():
    """"periodic" and "mixed" rollouts, deterministic or not, raise without
    their draw; "sin" and "drag" need none."""
    for kind in KINDS:
        _, env, _, _, p, st = _setup(kind)
        args = (pack_state(st), st.time, st.pos_traj, st.vel_traj,
                torch.zeros(8, H, 4), p)
        if kind in dynamics.UNIFORM_DRAW:
            with pytest.raises(ValueError):
                make_rollout(env)(*args, deterministic=True)
            with pytest.raises(ValueError):
                rollout_cuda.build_kernel_disturb(env, args[0], st.time, p, None, True, H)
        else:
            assert torch.isfinite(make_rollout(env)(*args)).all()


@pytest.mark.parametrize("kind", ["mixed", "periodic"])
def test_batched_rollout_matches_pallas(kind):
    """B=2 scenarios (one at t0 = 47, one at 49): K6's plain route against
    JAX's batched Pallas rollout in interpret mode, each scenario under its
    own uniform draw, and the (B, 3H) dist table against JAX's vmapped
    packing."""
    jenv, env = make_envs(disturb_type=kind)
    jp = jenv.default_params.replace(disturb_params=jnp.asarray(_wind()))
    jp_b = jax.tree.map(lambda x: jnp.stack([jnp.asarray(x)] * 2), jp)
    jp_b = jp_b.replace(m=jnp.array([0.027, 0.031]))
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    sts = [jenv.reset_env(k, jp)[1]["noisy_state"] for k in keys]
    x0s = jnp.stack([jpack(s) for s in sts]).at[:, 13:16].set(jnp.asarray(F0))
    t0s = jnp.array([47, 49], jnp.int32)
    pos = jnp.stack([s.pos_traj for s in sts])
    vel = jnp.stack([s.vel_traj for s in sts])
    actions = (np.random.default_rng(6).normal(size=(2, N, H, 4)) * 0.4).astype(np.float32)
    step_keys = jax.random.split(jax.random.PRNGKey(7), 2)
    ref = j_rollout_batched(jenv, interpret=True)(x0s, t0s, pos, vel, actions, jp_b,
                                                 step_keys, False, 0.99)
    draws = torch.stack([_rollout_draw(kind, k, jp) for k in step_keys])
    pb = to_torch_params(jp_b)
    args = (t(x0s), torch.from_numpy(np.array(t0s)), t(pos), t(vel))
    got = rollout_cuda.make_rollout_batched_costs(env)(
        *args, t(actions), pb, draws, False, 0.99, layout="nhd")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-5)
    _, _, dist, _, _ = rollout_cuda._pack_kernel_inputs(env, *args, pb, draws, False,
                                                        0.99, H)
    jdist = jax.vmap(lambda x0, t0, pt, vt, p, k: j_pack(
        jenv, x0, t0, pt, vt, p, k, False, 0.99, H)[2])(x0s, t0s, pos, vel, jp_b, step_keys)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), atol=1e-6)


# --- the Hessians -----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_hessian(kind, second_order, wind=True):
    jenv, env, jp, noisy, p, st = _setup(kind, wind)
    a = (np.random.default_rng(7).normal(size=(H, 4)) * 0.3).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ref = j_hessian_adjoint(jenv, H, second_order=second_order)(
        a.reshape(-1), jpack(noisy), noisy.time, noisy.pos_traj, noisy.vel_traj, jp, key)
    return a, np.asarray(ref), _hessian_draws(key, jp)


@pytest.mark.parametrize("part", ["torch", "cuda"])
@pytest.mark.parametrize("second_order", [False, True], ids=["gn", "adjoint"])
@pytest.mark.parametrize("kind", KINDS)
def test_hessian_matches_jax(kind, second_order, part):
    """The gn and exact-adjoint Hessians against JAX's make_hessian_adjoint,
    fed the uniforms of its per-step key chain: the 13-dim state with the
    (H, 3) force table (sin, periodic; K2 on the table for part="cuda") and
    the 16-dim state (drag, mixed; K3 at sd=16 for part="cuda")."""
    _, env, _, _, p, st = _setup(kind)
    a, ref, draws = _jax_hessian(kind, second_order)
    got = make_hessian_adjoint(env, H, primal=part, tail=part, second_order=second_order)(
        t(a).reshape(-1), pack_state(st), st.time, st.pos_traj, st.vel_traj, p, draws)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) < 1e-5


def test_hessian_aux_and_disturb_tables_match_jax():
    """The mixed aux table (H, 7) and the periodic / sin force tables
    (H, 3) against JAX's, from the same key chain."""
    key = jax.random.PRNGKey(9)
    from covo_mpc_tpu_torch.ops import hessian

    for kind in ("mixed", "periodic", "sin"):
        jenv, env, jp, noisy, p, st = _setup(kind)
        draws = _hessian_draws(key, jp)
        if kind == "mixed":
            ref = jhess.build_hessian_aux_table(jenv, jpack(noisy), noisy.time, jp, key, H)
            got = hessian.build_hessian_aux_table(env, st.time, p, draws, H)
        else:
            ref = jhess.build_hessian_disturb_table(jenv, jpack(noisy), noisy.time, jp,
                                                    key, H)
            got = hessian.build_hessian_disturb_table(env, pack_state(st), st.time, p,
                                                      draws, H)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, err_msg=kind)


@pytest.mark.parametrize("second_order", [False, True], ids=["gn", "adjoint"])
def test_drag_hessian_at_zero_relative_velocity(second_order):
    """At the exact reset state (zero velocity) with no wind, rel_v = 0 on
    the hover nominal's first step, where |rel_v| is not differentiable: the
    port takes JAX's convention (derivative +1 at 0), so its 16-dim Hessian
    equals JAX's."""
    jenv, env = make_envs(disturb_type="drag")
    jp = jenv.default_params
    _, _, state = jenv.reset_env(jax.random.PRNGKey(0), jp)
    a = np.tile(np.asarray(j_hover(jenv, 1)), (H, 1)).astype(np.float32)
    ref = j_hessian_adjoint(jenv, H, second_order=second_order)(
        a.reshape(-1), jpack(state), state.time, state.pos_traj, state.vel_traj, jp,
        jax.random.PRNGKey(9))
    st = to_torch_state(state)
    assert float(st.vel.abs().max()) == 0.0
    got = make_hessian_adjoint(env, H, second_order=second_order)(
        t(a).reshape(-1), pack_state(st), st.time, st.pos_traj, st.vel_traj,
        to_torch_params(jp))
    assert _rel(got.numpy(), np.asarray(ref)) < 1e-5


def test_batched_hessian_matches_single_under_mixed():
    """make_hessian_batched (vmap over scenarios, per-scenario draws) equals
    the single-scenario Hessian of each scenario."""
    _, env, _, _, p, st = _setup("mixed")
    a, _, draws = _jax_hessian("mixed", True)
    x0 = pack_state(st)
    x0s = torch.stack([x0, x0])
    t0s = torch.stack([st.time, st.time + 2])
    a2 = torch.stack([t(a).reshape(-1), t(a).reshape(-1) * 0.5])
    draws2 = torch.stack([draws, draws.flip(0)])
    got = make_hessian_batched(env, H)(a2, x0s, t0s, torch.stack([st.pos_traj] * 2),
                                       torch.stack([st.vel_traj] * 2),
                                       stack_params([p, p]), draws2)
    hess = make_hessian_adjoint(env, H)
    for b in range(2):
        ref = hess(a2[b], x0s[b], t0s[b], st.pos_traj, st.vel_traj, p, draws2[b])
        assert _rel(got[b].numpy(), ref.numpy()) < 1e-5


# --- one solve under drag / mixed -------------------------------------------

PSTR = f"N{N}_H{H}_lam0.01"


@pytest.mark.parametrize("kind,engine,rng_mode,hessian_mode", [
    ("drag", "torch", "fast", "gn"), ("drag", "cuda", "kernel", "gn"),
    ("drag", "cuda", "fast", "adjoint"), ("mixed", "torch", "fast", "gn"),
])
def test_covo_solve_matches_jax(kind, engine, rng_mode, hessian_mode):
    """Two chained CoVO-online solves against JAX's jnp engine on the same
    normals (act_key = split(rng)[1]) and, under mixed, the rollout's
    uniform (from step_key, fast keys) and the Hessian's (rng's key chain)."""
    jenv, env = make_envs(disturb_type=kind)
    jsolver, jcp = j_get_solver(jenv, "covo_online", PSTR, rng_mode="fast",
                                hessian_mode=hessian_mode, sigma_mode="ns",
                                engine="jnp", collect_debug=False)
    jp = jenv.default_params
    obs, info, state = jenv.reset_env(jax.random.PRNGKey(0), jp)
    solver, _ = get_solver(env, "covo_online", PSTR, rng_mode=rng_mode,
                           hessian_mode=hessian_mode,
                           sigma_mode="ns", engine=engine, collect_debug=False)
    p, st = to_torch_params(jp), to_torch_state(state)
    tinfo = {"noisy_state": to_torch_state(info["noisy_state"])}
    cp = covo_params_from_numpy(leaves(jcp), device="cpu")
    for key in (jax.random.PRNGKey(5), jax.random.PRNGKey(6)):
        a_r, jcp, _ = jsolver(obs, state, jp, key, jcp, info)
        rest, act_key = jax.random.split(key)
        step_key = jax.random.split(rest)[1]
        z = torch.from_numpy(np.array(jax.random.normal(act_key, (N, D))))
        a, cp, _ = solver(None, st, p, cp, tinfo, z=z,
                          draw=_rollout_draw(kind, step_key, jp, fast=True),
                          hess_draws=(_hessian_draws(key, jp)
                                      if kind in dynamics.UNIFORM_DRAW else None))
        np.testing.assert_allclose(a.numpy(), np.asarray(a_r), atol=2e-4)
        np.testing.assert_allclose(cp.a_mean.numpy(), np.asarray(jcp.a_mean), atol=2e-4)
        np.testing.assert_allclose(cp.a_cov.numpy(), np.asarray(jcp.a_cov), atol=2e-4)
        cp = covo_params_from_numpy(leaves(jcp), device="cpu")


@pytest.mark.parametrize("kind,engine,rng_mode", [
    ("drag", "torch", "fast"), ("drag", "cuda", "kernel"), ("mixed", "cuda", "fast"),
])
def test_mppi_solve_matches_jax(kind, engine, rng_mode):
    """Two chained MPPI solves under drag (no draw) and mixed (the shared
    uniform from step_key, fast keys) against JAX's jnp engine."""
    jenv, env = make_envs(disturb_type=kind)
    jsolver, jcp = j_get_solver(jenv, "mppi", PSTR, rng_mode="fast", engine="jnp",
                                collect_debug=False)
    jp = jenv.default_params
    obs, info, state = jenv.reset_env(jax.random.PRNGKey(0), jp)
    solver, _ = get_solver(env, "mppi", PSTR, rng_mode=rng_mode, engine=engine, collect_debug=False)
    p, st = to_torch_params(jp), to_torch_state(state)
    tinfo = {"noisy_state": to_torch_state(info["noisy_state"])}
    cp = mppi_params_from_numpy(leaves(jcp), device="cpu")
    for key in (jax.random.PRNGKey(5), jax.random.PRNGKey(6)):
        a_r, jcp, _ = jsolver(obs, state, jp, key, jcp, info)
        rest, act_key = jax.random.split(key)
        z = torch.from_numpy(np.array(jax.random.normal(act_key, (N, H, 4))))
        draw = _rollout_draw(kind, jax.random.split(rest)[1], jp, fast=True)
        a, cp, _ = solver(None, st, p, cp, tinfo, z=z, draw=draw)
        np.testing.assert_allclose(a.numpy(), np.asarray(a_r), atol=2e-4)
        for name in ("a_mean", "a_cov", "a_cov_chol"):
            np.testing.assert_allclose(getattr(cp, name).numpy(),
                                       np.asarray(getattr(jcp, name)), atol=2e-4)
        cp = mppi_params_from_numpy(leaves(jcp), device="cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_closed_loop_modes_run(kind):
    """A short closed loop per model and CoVO mode on the CPU (the solvers
    draw their own uniforms): online, speculative and offline CoVO and MPPI
    track finitely."""
    from covo_mpc_tpu_torch.runtime import make_episode_runner

    _, env = make_envs(disturb_type=kind)
    for name in ("covo_online", "covo_speculative", "covo_offline", "mppi"):
        solver, _ = get_solver(env, name, "N64_H4_lam0.01", rng_mode="fast",
                               engine="torch",
                               hessian_mode="gn", sigma_mode="ns", collect_debug=False)
        err, _, _ = make_episode_runner(env, solver, steps=8)(
            torch.Generator().manual_seed(0), torch.Generator().manual_seed(1))
        assert bool(torch.isfinite(err).all()), name
