"""The port's rotation helpers, PID controller and Random solver against
the JAX package on the same inputs.

Rotation helpers at atol 1e-6, the PID's stages and solves at 1e-5 (fp32
arithmetic in another order). The states come from JAX's reset and step,
carried across with ``state_from_numpy``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covo_mpc_tpu.models import rotation as jrot
from covo_mpc_tpu.solvers import pid as jpid
from covo_mpc_tpu_torch.models import rotation
from covo_mpc_tpu_torch.solvers import PIDParams, PIDSolver, RandomSolver, get_solver
from covo_mpc_tpu_torch.solvers import pid
from tests.test_torch_models import make_envs, t, to_torch_params, to_torch_state

ROT_ATOL = 1e-6
ATOL = 1e-5
GAINS = dict(Kp=10.0, Kd=5.0, Ki=0.5, Kp_att=10.0)


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    q[:, 3] = np.abs(q[:, 3]) + 0.5  # w bounded away from 0 (rotmat_to_quat)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def test_rotation_helpers_match():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)  # un-normalized, as noisy
    np.testing.assert_allclose(rotation.quat_to_rotmat(t(q)).numpy(),
                               np.asarray(jrot.quat_to_rotmat(q)), atol=ROT_ATOL)
    R = np.asarray(jrot.quat_to_rotmat(_unit_quats(rng, 64)))
    np.testing.assert_allclose(rotation.rotmat_to_quat(t(R)).numpy(),
                               np.asarray(jrot.rotmat_to_quat(R)), atol=ROT_ATOL)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(rotation.hat(t(v)).numpy(), np.asarray(jrot.hat(v)),
                               atol=ROT_ATOL)
    np.testing.assert_allclose(rotation.vee(rotation.hat(t(v))).numpy(), v, atol=0)
    S = rng.normal(size=(64, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(rotation.vee(t(S)).numpy(), np.asarray(jrot.vee(S)),
                               atol=ROT_ATOL)
    angle = rng.uniform(-3.0, 3.0, size=64).astype(np.float32)
    np.testing.assert_allclose(rotation.axis_angle_to_rotmat(t(v), t(angle)).numpy(),
                               np.asarray(jrot.axis_angle_to_rotmat(v, angle)),
                               atol=ROT_ATOL)
    # one matrix, a Python-float angle
    np.testing.assert_allclose(rotation.axis_angle_to_rotmat(t(v[0]), 0.7).numpy(),
                               np.asarray(jrot.axis_angle_to_rotmat(v[0], 0.7)),
                               atol=ROT_ATOL)


def test_pid_stages_match():
    """The three stages on a batch of 64 random inputs, and the small-angle
    quirk: a force along e_z (and one tilted by less than 1e-3) snaps to a
    5e-4 rotation about e_z."""
    jenv, env = make_envs()
    rng = np.random.default_rng(1)
    pos_err, vel_err, integral, acc = (rng.normal(size=(64, 3)).astype(np.float32)
                                       for _ in range(4))
    jg = jpid.PIDParams(**GAINS)
    g = PIDParams.default("cpu", **GAINS)
    f_ref = jpid.force_setpoint(jg, jenv.default_params, pos_err=pos_err,
                                vel_err=vel_err, integral=integral, acc_ff=acc)
    f = pid.force_setpoint(g, env.default_params, pos_err=t(pos_err),
                           vel_err=t(vel_err), integral=t(integral), acc_ff=t(acc))
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), atol=ATOL)
    forces = np.concatenate([np.asarray(f_ref),
                             [[0.0, 0.0, 0.3], [2e-4, -1e-4, 0.3]]]).astype(np.float32)
    Rd_ref = jpid.tilt_setpoint(forces)
    Rd = pid.tilt_setpoint(t(forces))
    np.testing.assert_allclose(Rd.numpy(), np.asarray(Rd_ref), atol=ATOL)
    snapped = jrot.axis_angle_to_rotmat(jnp.array([0.0, 0.0, 1.0]), 5e-4)
    np.testing.assert_allclose(Rd[-2:].numpy(), np.stack([snapped] * 2), atol=1e-7)
    R = np.asarray(jrot.quat_to_rotmat(_unit_quats(rng, forces.shape[0])))
    np.testing.assert_allclose(
        pid.so3_rate_command(Rd, t(R), 10.0).numpy(),
        np.asarray(jpid.so3_rate_command(Rd_ref, R, 10.0)), atol=ATOL)


@pytest.mark.parametrize("hover", [False, True], ids=["reset", "near_hover"])
def test_pid_solves_match_with_carry(hover):
    """Two chained solves on JAX's reset state and the state one step
    later, the carry (integral, quat_desired) threaded through. ``hover``
    puts the state on its target with zero feed-forward, so the force is
    along e_z and the small-angle quirk decides the attitude."""
    jenv, env = make_envs()
    jp = jenv.default_params
    _, _, s0 = jenv.reset_env(jax.random.PRNGKey(3), jp)
    if hover:
        s0 = s0.replace(pos=s0.pos_tar, vel=s0.vel_tar, acc_tar=jnp.zeros(3),
                        quat=jnp.array([0.0, 0.0, 0.0, 1.0]))
    jsolver = jpid.PIDSolver(jenv, jpid.PIDParams(**GAINS))
    solver = PIDSolver(env, PIDParams.default("cpu", **GAINS))
    jcp, cp = jsolver.init_control_params, solver.init_control_params
    p = to_torch_params(jp)
    state = s0
    for i in range(2):
        a_ref, jcp, _ = jsolver(None, state, jp, jax.random.PRNGKey(0), jcp, None)
        a, cp, info = solver(None, to_torch_state(state), p, cp)
        np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), atol=ATOL,
                                   err_msg=f"solve {i}")
        for name in ("integral", "quat_desired"):
            np.testing.assert_allclose(getattr(cp, name).numpy(),
                                       np.asarray(getattr(jcp, name)), atol=ATOL,
                                       err_msg=f"{name} {i}")
        assert info == {}
        if hover and i == 0:  # the snapped 5e-4 rotation about e_z
            np.testing.assert_allclose(cp.quat_desired.numpy(),
                                       [0.0, 0.0, np.sin(2.5e-4), np.cos(2.5e-4)],
                                       atol=1e-7)
        _, state, _, _, _ = jenv.step_env(jax.random.PRNGKey(i), state, a_ref, jp)


def test_pid_and_random_from_the_factory():
    """"pid" takes the JAX factory's gains; "random" draws N(0, 0.3^2)
    actions from its own seeded generator and carries no params."""
    _, env = make_envs()
    solver, cp = get_solver(env, "pid")
    assert (cp.Kp, cp.Kd, cp.Ki, cp.Kp_att) == (10.0, 5.0, 0.0, 10.0)
    assert isinstance(solver, PIDSolver) and cp.integral.device.type == "cpu"
    rnd, none = get_solver(env, "random", seed=3, rng_mode="fast")
    assert isinstance(rnd, RandomSolver) and none is None
    draws = torch.stack([rnd(None, None, None, None)[0] for _ in range(2000)])
    assert draws.shape == (2000, 4) and draws.device.type == "cpu"
    assert abs(float(draws.std()) - 0.3) <= 0.02 and abs(float(draws.mean())) <= 0.02
    rnd.seed(3)
    assert torch.equal(rnd(None, None, None, None)[0], draws[0])
