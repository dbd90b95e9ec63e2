"""covo_mpc_tpu_torch.models against the JAX package on the same inputs.

Every random number the port's env needs enters its pure methods as a
tensor, so these tests hand it the numbers JAX drew from the same keys and
compare the results (atol 1e-5: fp32 arithmetic in another order). The
helpers at the top are shared with the other test_torch_* files.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covo_mpc_tpu.models import EnvConfig as JEnvConfig
from covo_mpc_tpu.models import QuadEnv as JQuadEnv
from covo_mpc_tpu.models import dynamics as jdyn
from covo_mpc_tpu.models import rewards as jrew
from covo_mpc_tpu.models import trajectory as jtraj
from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv, dynamics, rewards
from covo_mpc_tpu_torch.models.quad_env import ResetDraws, StepDraws
from covo_mpc_tpu_torch.models.structs import (
    EnvParams3D,
    params_from_numpy,
    state_from_numpy,
)
from covo_mpc_tpu_torch.models.trajectory import ZigzagDraws, num_segments, zigzag_from_draws

ATOL = 1e-5
STATE_FIELDS = [
    "pos", "vel", "quat", "omega", "omega_tar", "pos_tar", "vel_tar",
    "acc_tar", "last_thrust", "last_torque", "time", "f_disturb",
    "vel_hist", "omega_hist", "action_hist", "pos_traj", "vel_traj",
]
ENV_KW = dict(task="tracking_zigzag", enable_randomizer=False,
              disturb_type="gaussian", disable_rollover_terminate=True,
              generate_noisy_state=True)


def make_envs(**overrides):
    kw = dict(ENV_KW, **overrides)
    return JQuadEnv(JEnvConfig(**kw)), QuadEnv(EnvConfig(**kw), device="cpu")


def leaves(struct) -> dict:
    """A JAX struct's leaves as numpy arrays."""
    return {f.name: np.asarray(getattr(struct, f.name))
            for f in dataclasses.fields(struct)
            if getattr(struct, f.name) is not None}


def to_torch_state(jstate):
    return state_from_numpy(leaves(jstate), device="cpu")


def to_torch_params(jparams):
    return params_from_numpy(leaves(jparams), device="cpu")


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def zigzag_draws_from_key(key, max_steps) -> ZigzagDraws:
    """The uniforms the JAX zigzag generator draws from ``key``."""
    n = num_segments(max_steps)
    seg_keys = jax.random.split(key, n)
    start = jax.random.uniform(seg_keys[0], (3,), minval=-1.0, maxval=1.0)
    segs = [
        np.concatenate([
            np.asarray(jax.random.uniform(k, (2,), minval=-jnp.pi / 3,
                                          maxval=jnp.pi / 3)),
            np.asarray(jax.random.uniform(k, minval=1.0, maxval=1.5))[None],
        ])
        for k in seg_keys
    ]
    return ZigzagDraws(start=t(start), segs=t(np.stack(segs)))


def obs_noise_from_key(info_key):
    """The (13,) standard normals JAX's get_info draws for noisy_state."""
    k_pos, k_vel, k_quat, k_omega, _ = jax.random.split(info_key, 5)
    return t(np.concatenate([
        np.asarray(jax.random.normal(k_pos, (3,))),
        np.asarray(jax.random.normal(k_vel, (3,))),
        np.asarray(jax.random.normal(k_quat, (4,))),
        np.asarray(jax.random.normal(k_omega, (3,))),
    ]))


def reset_draws_from_key(jenv, key, params) -> ResetDraws:
    """The draws JAX's reset_env(key) makes, in the port's form."""
    traj_key, disturb_key, _ = jax.random.split(key, 3)
    scale = float(params.disturb_scale)
    f = jax.random.uniform(disturb_key, (3,), minval=-scale, maxval=scale)
    info_key, _ = jax.random.split(key)
    return ResetDraws(
        traj=zigzag_draws_from_key(traj_key, jenv._max_steps),
        f_disturb=t(np.asarray(f) / scale),
        obs_noise=obs_noise_from_key(info_key),
    )


def step_draws_from_key(key) -> StepDraws:
    """The draws JAX's step_env(key) makes, in the port's form."""
    dk = jdyn.derive_dynamics_keys(key)
    info_key, _ = jax.random.split(key)
    return StepDraws(disturb=t(jax.random.normal(dk, shape=(3,))),
                     obs_noise=obs_noise_from_key(info_key))


def assert_states_close(ours, ref, atol=ATOL, msg=""):
    for f in STATE_FIELDS:
        np.testing.assert_allclose(
            np.asarray(getattr(ours, f)), np.asarray(getattr(ref, f)),
            atol=atol, err_msg=f"{msg}:{f}",
        )


# --------------------------------------------------------------------------


def test_default_params_match():
    jenv, env = make_envs()
    ours, ref = env.default_params, leaves(jenv.default_params)
    for f in dataclasses.fields(EnvParams3D):
        np.testing.assert_allclose(np.asarray(getattr(ours, f.name)),
                                   ref[f.name], rtol=1e-7, err_msg=f.name)


@pytest.mark.parametrize("reward", ["penyaw", "realworld"])
def test_rewards_match(reward):
    rng = np.random.default_rng(0)
    pos, vel, pt, vt = (rng.normal(size=(64, 3)).astype(np.float32) for _ in range(4))
    quat = rng.normal(size=(64, 4)).astype(np.float32)
    if reward == "penyaw":
        ref = jrew.tracking_penyaw_reward(pos, vel, quat, pt, vt)
        got = rewards.tracking_penyaw_reward(t(pos), t(vel), t(quat), t(pt), t(vt))
    else:
        ref = jrew.tracking_realworld_reward(pos, quat, pt)
        got = rewards.tracking_realworld_reward(t(pos), t(quat), t(pt))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_bodyrate_step_matches():
    jenv, env = make_envs()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    a = rng.uniform(-1.2, 1.2, size=(64, 4)).astype(np.float32)
    jp = jenv.default_params
    u_ref, torque_ref = jdyn.control_to_thrust_omega(a, jp)
    ref = jdyn.bodyrate_step(x, u_ref, jp, jenv._dt)
    u, torque = dynamics.control_to_thrust_omega(t(a), env.default_params)
    got = dynamics.bodyrate_step(t(x), u, env.default_params, env._dt)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_ref), atol=ATOL)
    np.testing.assert_allclose(torque.numpy(), np.asarray(torque_ref), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_zigzag_from_jax_uniforms(seed):
    key = jax.random.PRNGKey(seed)
    ref = jtraj.generate_zigzag_traj(300, 0.02, key)
    got = zigzag_from_draws(300, 0.02, zigzag_draws_from_key(key, 300))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)


def test_reset_env_matches():
    jenv, env = make_envs()
    key = jax.random.PRNGKey(11)
    jp = jenv.default_params
    obs_r, info_r, state_r = jenv.reset_env(key, jp)
    obs, info, state = env.reset_from_draws(
        reset_draws_from_key(jenv, key, jp), env.default_params
    )
    assert_states_close(state, state_r, msg="state")
    assert_states_close(info["noisy_state"], info_r["noisy_state"], msg="noisy")
    np.testing.assert_allclose(obs.numpy(), np.asarray(obs_r), atol=ATOL)
    for k in ("discount", "err_pos", "err_vel", "obs_param", "obs_adapt"):
        np.testing.assert_allclose(np.asarray(info[k]), np.asarray(info_r[k]),
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("deterministic", [False, True])
def test_step_env_matches(deterministic):
    """Five steps from a reset state; the port starts every step from the
    JAX state (carried across with state_from_numpy) so errors do not
    compound."""
    jenv, env = make_envs()
    jp = jenv.default_params
    _, _, jstate = jenv.reset_env(jax.random.PRNGKey(2), jp)
    rng = np.random.default_rng(4)
    key = jax.random.PRNGKey(9)
    for i in range(5):
        key, k = jax.random.split(key)
        action = rng.uniform(-1.1, 1.1, size=4).astype(np.float32)
        ref = jenv.step_env(k, jstate, action, jp, deterministic=deterministic)
        got = env.step_from_draws(step_draws_from_key(k), to_torch_state(jstate),
                                  t(action), to_torch_params(jp),
                                  deterministic=deterministic)
        obs_r, next_r, rew_r, done_r, info_r = ref
        obs, nxt, rew, done, info = got
        assert_states_close(nxt, next_r, msg=f"step {i}")
        assert_states_close(info["noisy_state"], info_r["noisy_state"],
                            msg=f"noisy {i}")
        np.testing.assert_allclose(obs.numpy(), np.asarray(obs_r), atol=ATOL)
        np.testing.assert_allclose(float(rew), float(rew_r), atol=ATOL)
        assert bool(done) == bool(done_r)
        np.testing.assert_allclose(float(info["err_pos"]), float(info_r["err_pos"]),
                                   atol=ATOL)
        jstate = next_r


@pytest.mark.parametrize("time,pos", [(299, 0.5), (300, 0.0), (10, 3.5)])
def test_is_terminal_matches(time, pos):
    jenv, env = make_envs()
    jp = jenv.default_params
    _, _, jstate = jenv.reset_env(jax.random.PRNGKey(2), jp)
    jstate = jstate.replace(time=jnp.int32(time), pos=jnp.full(3, pos))
    ref = jenv.is_terminal(jstate, jp)
    got = env.is_terminal(to_torch_state(jstate), env.default_params)
    assert bool(got) == bool(ref)


def test_auto_reset_step_selects():
    """step() returns the stepped state while running and the reset state
    once the pre-step state is terminal; replaying the generator shows
    which draws each branch used."""
    _, env = make_envs()
    p = env.default_params
    gen = torch.Generator().manual_seed(0)
    _, _, state = env.reset(gen, p)
    action = torch.tensor([0.1, 0.0, 0.0, 0.0])
    for time, done_expected in ((5, False), (300, True)):
        st = state.replace(time=torch.tensor(time, dtype=torch.int32))
        saved = gen.get_state()
        obs, nxt, _, done, info = env.step(gen, st, action, p)
        gen.set_state(saved)
        obs_s, nxt_s, _, _, _ = env.step_env(gen, st, action, p)
        _, _, reset_state = env.reset_env(gen, p)
        assert bool(done) == done_expected
        expected = reset_state if done_expected else nxt_s
        assert_states_close(nxt, expected, atol=0.0, msg=str(time))
        if not done_expected:
            np.testing.assert_array_equal(obs.numpy(), obs_s.numpy())


def test_generator_draws_have_the_stated_ranges():
    _, env = make_envs()
    gen = torch.Generator().manual_seed(1)
    d = env.draw_reset(gen)
    assert d.traj.segs.shape == (num_segments(300), 3)
    assert float(d.traj.segs[:, :2].abs().max()) <= math.pi / 3
    assert 1.0 <= float(d.traj.segs[:, 2].min()) and float(d.traj.segs[:, 2].max()) < 1.5
    assert float(d.f_disturb.abs().max()) <= 1.0
    assert d.obs_noise.shape == (13,)
