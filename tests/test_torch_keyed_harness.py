"""Key-drawing controllers (``rng_mode="parity"`` / ``"invariant"``) in the
port's supervisor and render harness, against the port's ``evaluate`` and
against the JAX package's ``render_episode``.

On the CPU at a small size (N=8, H=2 for the supervised runs; N=16, H=4 in
render). Tolerances: a supervised parity run equals ``evaluate`` of the
same controller bit for bit (the same runner on the same key chain, the
chunk's carry the key), and a crash-then-resume equals an uninterrupted
run bit for bit; render on keys follows JAX's ``render_episode`` within
1e-6 for Random (its actions do not feed back: what is left is float32
rounding of the same dynamics) and within 1e-3 over 12 steps for MPPI, as
tests/test_torch_parity_episode.py holds the closed loop; with
``reset_on_done`` the reference's key chain on done (new params, the
controller's reset) as JAX's (tests/test_harness.py::
test_render_reset_on_done).
"""

import numpy as np
import pytest

from covo_mpc_tpu.runtime.render import render_episode as j_render_episode
from covo_mpc_tpu.solvers import get_solver as j_get_solver
from covo_mpc_tpu_torch.runtime import evaluate, render_episode, run_supervised
from covo_mpc_tpu_torch.solvers import get_solver
from tests.test_torch_models import make_envs

SUP_PSTR = "N8_H2_lam0.01"
PSTR = "N16_H4_lam0.01"
RECORDED = ("pos", "vel", "quat", "omega", "action", "err_pos", "reward")


def _supervised(**kw):
    _, env = make_envs()
    solver, _ = get_solver(env, "mppi", SUP_PSTR)  # JAX's defaults: parity
    return env, solver, run_supervised(env, solver, total_steps=600, num_trajs=2, seed=3,
                                       chunk_episodes=1, **kw)


@pytest.fixture(scope="module")
def whole(tmp_path_factory):
    """An uninterrupted supervised run (two episodes in two chunks),
    checkpointed into a fresh directory: (env, solver, result, dir)."""
    ckpt = str(tmp_path_factory.mktemp("keyed_sup"))
    return (*_supervised(checkpoint_dir=ckpt), ckpt)


def test_supervised_parity_run_equals_evaluate(whole):
    """run_supervised of MPPI parity (two episodes in two chunks, the key
    carried and checkpointed between them) equals evaluate bit for bit; the
    checkpoint holds the key."""
    env, solver, sup, ckpt = whole
    ref = evaluate(env, solver, total_steps=600, num_trajs=2, seed=3)
    assert np.array_equal(sup.err_pos_ep.numpy(), ref.err_pos_ep.double().numpy())
    assert not sup.failed.any() and sup.mean == pytest.approx(ref.mean, rel=1e-6)
    with np.load(f"{ckpt}/state.npz") as data:
        assert data["carry_0"].shape == (2,) and data["carry_0"].dtype == np.int64


def test_supervised_parity_crash_then_resume(tmp_path, whole):
    """A run killed at chunk 1 resumes there from the checkpointed key, and
    equals an uninterrupted supervised run bit for bit."""
    ckpt = str(tmp_path / "ckpt")

    def hook(chunk, attempt):
        if chunk == 1:
            raise RuntimeError("persistent outage")

    with pytest.raises(RuntimeError, match="re-run the same command"):
        _supervised(checkpoint_dir=ckpt, max_retries=0, _fault_hook=hook)
    _, _, resumed = _supervised(checkpoint_dir=ckpt)
    assert resumed.resumed_at_chunk == 1
    assert np.array_equal(resumed.err_pos_ep.numpy(), whole[2].err_pos_ep.numpy())


@pytest.mark.parametrize("name, steps, atol", [("random", 40, 1e-6), ("mppi", 12, 1e-3)])
def test_render_on_keys_follows_jax(name, steps, atol):
    """render_episode of a parity controller under domain randomization:
    the params, reset and controller's reset from JAX's splits, then
    ``split(rng, 3)`` a step; every recorded channel as JAX's."""
    jenv, env = make_envs(enable_randomizer=True)
    jsolver, _ = j_get_solver(jenv, name, PSTR)
    solver, _ = get_solver(env, name, PSTR)
    ref = j_render_episode(jenv, jsolver, seed=3, steps=steps)
    ours = render_episode(env, solver, seed=3, steps=steps)
    for k in RECORDED:
        np.testing.assert_allclose(ours[k], ref[k], atol=atol, err_msg=k)
    assert np.array_equal(ours["done"], ref["done"])


def _short_renders(name, reset_on_done, pstr="N8_H3_lam0.01"):
    """Both packages' 25-step recordings on JAX's test's env (tracking, DR)
    with 10-step episodes, so a done lands inside the recording."""
    jenv, env = make_envs(task="tracking", enable_randomizer=True)
    jsolver, _ = j_get_solver(jenv, name, pstr)
    solver, _ = get_solver(env, name, pstr)
    kw = dict(seed=1, steps=25, reset_on_done=reset_on_done)
    ref = j_render_episode(jenv, jsolver,
                           env_params=jenv.default_params.replace(max_steps_in_episode=10),
                           **kw)
    ours = render_episode(env, solver,
                          env_params=env.default_params.replace(max_steps_in_episode=10),
                          **kw)
    return ours, ref


def test_render_reset_on_done_on_keys_follows_jax():
    """reset_on_done under the key schedule: Random parity's recording with
    the mid-recording resets (new params drawn from the key, the
    controller reset) equals JAX's within 1e-6, before and after the
    first done, and differs from the recording without them after it."""
    ours, ref = _short_renders("random", True)
    plain, _ = _short_renders("random", False)
    done_at = int(np.argmax(ours["done"]))
    assert ours["done"][done_at] and np.array_equal(ours["done"], ref["done"])
    for k in RECORDED:
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-6, err_msg=k)
    np.testing.assert_allclose(ours["pos"][:done_at + 1], plain["pos"][:done_at + 1])
    assert not np.allclose(ours["pos"][done_at + 2:], plain["pos"][done_at + 2:])


def test_render_reset_on_done_mppi_parity():
    """JAX's test on the port's MPPI parity: recordings with and without the
    resets agree through the first done and part after it (new params and
    the controller's reset from the key), and the first steps follow JAX's
    recording within 1e-3."""
    ours, ref = _short_renders("mppi", True)
    plain, _ = _short_renders("mppi", False)
    done_at = int(np.argmax(plain["done"]))
    assert plain["done"][done_at]
    np.testing.assert_allclose(ours["pos"][:done_at + 1], plain["pos"][:done_at + 1])
    np.testing.assert_allclose(ours["action"][:done_at + 1],
                               plain["action"][:done_at + 1])
    assert not np.allclose(ours["action"][done_at + 1:], plain["action"][done_at + 1:])
    assert np.isfinite(ours["pos"]).all()
    np.testing.assert_allclose(ours["action"][:done_at + 1], ref["action"][:done_at + 1],
                               atol=1e-3)
