"""The rest of the port's env against the JAX package: ``substeps``, the
observation types, rollover termination, ``models/misc.py``,
``models/wrappers.py``, ``utils/stats.py`` and ``viz/meshcat_vis.py``.

On the CPU, on the same JAX keys for both packages (the port's env draws
JAX's values from a key, ``utils/prng.py``). Tolerances: env steps and
observations within 1e-6 over the steps checked (what float32 rounding of
the same ops leaves between XLA and PyTorch over a few steps); terminal
flags, keys and integer fields exactly; the stats and viz helpers as JAX's
own tests hold them (tests/test_stats.py, tests/test_viz.py,
tests/test_wrappers.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covo_mpc_tpu.models import EnvConfig as JEnvConfig
from covo_mpc_tpu.models import LogWrapper as JLogWrapper
from covo_mpc_tpu.models import QuadEnv as JQuadEnv
from covo_mpc_tpu.models import misc as jmisc
from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv, misc
from covo_mpc_tpu_torch.models.wrappers import LogWrapper, advance_log, fresh_log
from covo_mpc_tpu_torch.utils import prng
from covo_mpc_tpu_torch.utils.stats import assert_sampled_mean_agreement
from covo_mpc_tpu_torch.viz import meshcat_vis
from tests.test_torch_models import STATE_FIELDS, make_envs, to_torch_state

STEP_ATOL = 1e-6


def words(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _run_both(jenv, env, steps: int, seed: int = 4, actions=None):
    """Reset and ``steps`` auto-resetting steps of both envs from one key
    chain, with the same actions (``actions`` (steps, 4), or numpy normals
    x 0.3): yields (obs, state, reward, done, jax's obs, state, reward,
    done)."""
    jp, p = jenv.default_params, env.default_params
    key = jax.random.PRNGKey(seed)
    key, k = jax.random.split(key)
    jobs, _, jstate = jenv.reset(k, jp)
    obs, _, state = env.reset(words(k), p)
    yield obs, state, None, None, jobs, jstate, None, None
    if actions is None:
        actions = np.random.default_rng(seed).standard_normal((steps, 4)) * 0.3
    jstep = jax.jit(jenv.step)
    for a in np.asarray(actions, np.float32):
        key, k = jax.random.split(key)
        jobs, jstate, jr, jd, _ = jstep(k, jstate, jnp.asarray(a), jp)
        obs, state, r, d, _ = env.step(words(k), state, torch.from_numpy(a), p)
        yield obs, state, r, d, jobs, jstate, jr, jd


def _assert_step(out, atol=STEP_ATOL, msg=""):
    obs, state, r, d, jobs, jstate, jr, jd = out
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=atol, err_msg=msg)
    for f in STATE_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(state, f)),
                                   np.asarray(getattr(jstate, f)), atol=atol,
                                   err_msg=f"{msg}:{f}")
    if r is not None:
        np.testing.assert_allclose(float(r), float(jr), atol=atol, err_msg=msg)
        assert bool(d) == bool(jd), msg


# --- substeps -------------------------------------------------------------------------


def test_substeps_two_match_jax_on_the_same_keys():
    """EnvConfig(substeps=2): JAX scans the lower controller and raw_step
    twice under one key (quad_env.py:272-280); the port's model_step
    repeats raw_step under the key's one draw. Six steps within 1e-6, and
    they differ from substeps=1 (the second raw_step is taken)."""
    jenv, env = make_envs(substeps=2)
    outs = list(_run_both(jenv, env, 6))
    for i, out in enumerate(outs):
        _assert_step(out, msg=f"step {i}")
    _, env1 = make_envs()
    one = list(_run_both(make_envs()[0], env1, 1))[-1][1]
    assert not torch.allclose(outs[1][1].pos, one.pos)
    assert int(outs[1][1].time) == 2  # each raw_step advances the time


def test_lower_controllers_other_than_base_raise_as_jaxs():
    """Only the "base" lower controller is in scope: JAX raises for the
    others (quad_env.py:70-77), and so does the port."""
    with pytest.raises(NotImplementedError):
        JQuadEnv(JEnvConfig(lower_controller="l1"))
    with pytest.raises(NotImplementedError, match="lower controller"):
        QuadEnv(EnvConfig(lower_controller="l1"), device="cpu")


# --- observation types and rollover termination ---------------------------------------


@pytest.mark.parametrize("obs_type", ["quad_params", "params", "adapt_hist"])
def test_obs_types_match_jax(obs_type):
    """The three other observation types: their width, and the obs of a
    reset and five steps under domain randomization on JAX's keys."""
    jenv, env = make_envs(obs_type=obs_type, enable_randomizer=True)
    assert env.obs_dim == jenv.obs_dim
    for i, out in enumerate(_run_both(jenv, env, 5)):
        assert out[0].shape == (env.obs_dim,)
        _assert_step(out, msg=f"{obs_type} step {i}")


def test_rollover_termination_matches_jax():
    """disable_rollover_terminate=False: is_terminal on states tilted past
    90 degrees (the quaternion's w below cos 45 degrees), spinning past 100
    rad/s, out of bounds and level, as JAX's; and a closed
    loop of large actions that rolls over steps, terminates and auto-resets
    as JAX's."""
    jenv, env = make_envs(disable_rollover_terminate=False)
    jp, p = jenv.default_params, env.default_params
    _, _, jstate = jenv.reset(jax.random.PRNGKey(2), jp)
    def tilted(deg):
        half = np.deg2rad(deg) / 2
        return dict(quat=jnp.array([np.sin(half), 0.0, 0.0, np.cos(half)], jnp.float32))

    cases = {
        "level": dict(),
        "tilted 95 deg": tilted(95.0),
        "tilted 85 deg": tilted(85.0),
        "spinning": dict(omega=jnp.array([0.0, 0.0, 101.0])),
        "out of bounds": dict(pos=jnp.array([0.0, 3.5, 0.0])),
    }
    flags = {}
    for name, change in cases.items():
        js = jstate.replace(**change)
        ours = bool(env.is_terminal(to_torch_state(js), p))
        assert ours == bool(jenv.is_terminal(js, jp)), name
        flags[name] = ours
    assert flags == {"level": False, "tilted 95 deg": True, "tilted 85 deg": False,
                     "spinning": True, "out of bounds": True}
    dones = []
    roll = np.tile(np.array([0.0, 1.0, 0.0, 0.0], np.float32), (40, 1))
    for i, out in enumerate(_run_both(jenv, env, 40, seed=7, actions=roll)):
        _assert_step(out, atol=1e-5, msg=f"rollover loop step {i}")
        dones.append(bool(out[3]))
    assert any(dones[1:]), "full roll rate never rolled the quadrotor over"


# --- misc -------------------------------------------------------------------------------


def test_misc_matches_jax():
    xs = np.array([0.1, 3.5, -4.0, 10.0, -np.pi, np.pi], np.float32)
    np.testing.assert_allclose(misc.angle_normalize(torch.from_numpy(xs)).numpy(),
                               np.asarray(jmisc.angle_normalize(jnp.asarray(xs))),
                               atol=1e-6)
    center = np.array([1.0, 2.0, 3.0], np.float32)
    for seed in (3, 11):
        ours = misc.sample_sphere(prng.PRNGKey(seed), 2.0, torch.from_numpy(center))
        ref = jmisc.sample_sphere(jax.random.PRNGKey(seed), 2.0, jnp.asarray(center))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)
        assert float(torch.linalg.norm(ours - torch.from_numpy(center))) <= 2.0
    _, env = make_envs()
    p = env.default_params
    assert torch.equal(misc.constant_disturbance(None, None, p), p.d_offset)


# --- wrappers ---------------------------------------------------------------------------


def test_log_wrapper_accumulates_as_jaxs():
    """JAX's test (tests/test_wrappers.py) on both wrappers from one key
    chain: four steps accumulate the same returns and lengths, and no
    episode has ended."""
    kw = dict(task="hovering", disturb_type="none")
    jenv, env = make_envs(**kw)
    jenv, env = JLogWrapper(jenv), LogWrapper(env)
    key = jax.random.PRNGKey(0)
    _, _, jstate = jenv.reset(key, jenv.default_params)
    _, info, state = env.reset(words(key), env.default_params)
    assert not bool(info["returned_episode"])
    total = 0.0
    for _ in range(4):
        key, k = jax.random.split(key)
        _, jstate, _, _, jinfo = jenv.step(k, jstate, jnp.zeros(4), jenv.default_params)
        _, state, reward, _, info = env.step(words(k), state, torch.zeros(4),
                                             env.default_params)
        total += float(reward)
    assert int(state.episode_lengths) == int(jstate.episode_lengths) == 4
    assert float(state.episode_returns) == pytest.approx(total, abs=1e-5)
    np.testing.assert_allclose(float(state.episode_returns),
                               float(jstate.episode_returns), atol=1e-5)
    assert not bool(info["returned_episode"]) and not bool(jinfo["returned_episode"])


def test_advance_log_latches_on_done():
    log = fresh_log()
    for r in (1.0, 2.0):
        log = advance_log(log, torch.tensor(r), torch.tensor(False))
    log = advance_log(log, torch.tensor(4.0), torch.tensor(True))
    assert float(log.returns) == 0.0 and int(log.length) == 0
    assert float(log.last_returns) == 7.0 and int(log.last_length) == 3
    assert float(log.last_reward) == 4.0
    log = advance_log(log, torch.tensor(0.5), torch.tensor(False))
    assert float(log.returns) == 0.5 and float(log.last_returns) == 7.0


# --- stats (JAX's tests/test_stats.py) ----------------------------------------------------


def _draws(rng, bias=0.0, S=4, sd=0.006, shape=(4, 4)):
    """Synthetic solve outputs at the noise scale JAX calibrated (per
    coordinate sd 0.001-0.013 at N=8192, H=4)."""
    truth = rng.standard_normal(shape) * 0.1
    ref = truth + rng.standard_normal(shape) * sd
    return [truth + bias + rng.standard_normal(shape) * sd for _ in range(S)], ref


def test_stats_unbiased_passes():
    rng = np.random.default_rng(0)
    for _ in range(20):
        samples, ref = _draws(rng)
        assert_sampled_mean_agreement([torch.from_numpy(s) for s in samples], ref)


def test_stats_bias_below_a_flat_atol_is_rejected():
    rng = np.random.default_rng(1)
    samples, ref = _draws(rng, bias=0.05)
    assert np.all(np.abs(np.mean(samples, axis=0) - ref) < 0.25)
    with pytest.raises(AssertionError, match="biased"):
        assert_sampled_mean_agreement(samples, ref)


def test_stats_floor_guards_a_degenerate_spread():
    samples = [np.zeros((3,)) for _ in range(4)]
    assert_sampled_mean_agreement(samples, np.full((3,), 1e-4))
    with pytest.raises(AssertionError):
        assert_sampled_mean_agreement(samples, np.full((3,), 6e-3))


def test_stats_needs_two_samples():
    with pytest.raises(ValueError):
        assert_sampled_mean_agreement([np.zeros(3)], np.zeros(3))


# --- viz (JAX's tests/test_viz.py) --------------------------------------------------------


def test_viz_quat_to_matrix_identity():
    np.testing.assert_allclose(meshcat_vis._quat_xyzw_to_matrix([0.0, 0.0, 0.0, 1.0]),
                               np.eye(4), atol=1e-12)


def test_viz_vec_to_transform_frame():
    M = meshcat_vis._vec_to_transform([1.0, 2.0, 3.0], [0.0, 0.0, 2.0], scale=1.5)
    np.testing.assert_allclose(M[:3, 3], [1.0, 2.0, 3.0])
    np.testing.assert_allclose(M[:3, 2], [0.0, 0.0, 3.0])
    f = np.array([0.3, -0.4, 0.5])
    R = meshcat_vis._vec_to_transform(np.zeros(3), f, scale=2.0)[:3, :3]
    lengths = np.linalg.norm(R, axis=0)
    np.testing.assert_allclose(lengths, np.linalg.norm(f) * 2.0, atol=1e-12)
    np.testing.assert_allclose(R.T @ R, np.diag(lengths**2), atol=1e-12)
    np.testing.assert_allclose(R[:, 2] / lengths[2], f / np.linalg.norm(f), atol=1e-12)


def test_viz_vec_to_transform_zero_force():
    M = meshcat_vis._vec_to_transform([1.0, 0.0, 0.0], [0.0, 0.0, 0.0])
    np.testing.assert_allclose(M[:3, :3], 0.0)
    np.testing.assert_allclose(M[:3, 3], [1.0, 0.0, 0.0])


def test_viz_replay_requires_meshcat():
    with pytest.raises(ImportError, match="meshcat"):
        meshcat_vis._require_meshcat()
