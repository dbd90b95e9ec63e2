"""The port's public surface against the JAX package's.

JAX's own surface tests (``tests/test_api_surface.py``: the reference's
controller names, ``get_package_path``, MIGRATION.md's symbol map) pointed
at ``covo_mpc_tpu_torch``; an AST check that every public top-level name of
every JAX module is in its counterpart (``*_pallas.py`` -> ``*_cuda.py``),
minus the names left out by design (:data:`NOT_PORTED`); and value checks
of the names that check added against their JAX twins on seeded inputs:
rotation (1e-6 on unit quaternions), the key-taking trajectory generators
(their uniforms bit for bit, the tables within 1e-5), the sample-first
reductions (1e-6), ``fold_in_batch`` (bit for bit).
"""

import ast
import dataclasses
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import covo_mpc_tpu_torch
from covo_mpc_tpu.models import rotation as jrot
from covo_mpc_tpu.models import trajectory as jtraj
from covo_mpc_tpu.ops import reductions as jred
from covo_mpc_tpu.utils import fold_in_batch as j_fold_in_batch
from covo_mpc_tpu_torch import models, ops, parallel, solvers, utils
from covo_mpc_tpu_torch.models import rotation, trajectory
from covo_mpc_tpu_torch.ops import reductions
from tests.test_torch_models import t, zigzag_draws_from_key

REPO = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = REPO / "covo_mpc_tpu", REPO / "covo_mpc_tpu_torch"

# JAX modules with no counterpart, by design
NO_COUNTERPART = {
    "utils/vma.py": "shard_map bookkeeping",
    "utils/cache.py": "JAX's compilation cache",
    "models/scalar_core.py": "the kernels' component form: csrc/quad_core.cuh",
}
# public names of a JAX module its counterpart leaves out, by design
NOT_PORTED = {
    # shard_map bookkeeping (utils/vma.py) and its re-exports
    "utils/__init__.py": {"match_vma", "pvary"},
    "ops/covariance.py": {"match_vma"},
    "ops/hessian.py": {"match_vma"},
    "ops/rollout.py": {"pvary"},
    "parallel/offline.py": {"pvary"},
    "parallel/pipeline.py": {"pvary"},
    "parallel/scenarios.py": {"pvary"},
    # the Pallas kernel factories, the kernels' packed-state slices and tables, the
    # TPU precision constant; counterparts: ops/rollout_cuda.py
    # (make_rollout_*, make_primal, build_kernel_disturb) and
    # ops/covariance_cuda.py::optimize_sigma_ns_cuda
    "ops/rollout_pallas.py": {
        "make_pallas_rollout", "make_pallas_rollout_sampling",
        "make_pallas_rollout_joint_sampling", "make_pallas_rollout_batched",
        "make_pallas_rollout_batched_sampling", "make_pallas_primal", "FDIST", "SUB",
        "build_disturb_table", "scalar_core"},
    "ops/covariance_pallas.py": {"optimize_sigma_ns_pallas", "HIGHEST"},
    # the Pallas kernel's per-shard sample tile (the CUDA kernels take
    # ragged N)
    "parallel/sharded.py": {"PALLAS_TILE", "pvary"},
}
# package-internal names a JAX module imports for its own use, not API (a
# package's __init__ re-exports, which are API, are not listed here)
IMPORTED_NOT_API = {
    "solvers/covo.py": {"make_rollout"},
    "solvers/mppi.py": {"make_rollout"},
    "solvers/pid.py": {"default_array"},
    "solvers/factory.py": {"BaseSolver"},
    "models/rewards.py": {"scalar_core"},
    "models/quad_env.py": {"Action3D"},
    "ops/hessian.py": {"rewards"},
    "parallel/scenarios.py": {"make_rollout"},
    "parallel/sharded.py": {"reductions"},
}


# --- JAX's tests/test_api_surface.py, pointed at the port -------------------------


def test_reference_controller_aliases():
    assert solvers.BaseController is solvers.BaseSolver
    assert solvers.RandomController is solvers.RandomSolver
    assert solvers.PIDController is solvers.PIDSolver
    assert solvers.MPPIController is solvers.MPPISolver
    assert solvers.CoVOController is solvers.CoVOSolver
    for name in ("MPPIParams", "CoVOParams", "PIDParams"):
        assert hasattr(solvers, name)
    for name in ("BaseController", "RandomController", "PIDController",
                 "MPPIController", "CoVOController"):
        assert name in solvers.__all__


def test_get_package_path():
    path = covo_mpc_tpu_torch.get_package_path()
    assert os.path.isdir(path)
    assert os.path.basename(path) == "covo_mpc_tpu_torch"
    assert covo_mpc_tpu_torch.utils is utils


def test_migration_symbol_map():
    """Each MIGRATION.md table section resolves to a symbol of the port."""
    for name in ("quat_conj", "quat_mul", "quat_integrate", "rotate_vec",
                 "hat", "vee", "quat_to_rotmat", "rotmat_to_quat",
                 "rp_to_quat", "quat_to_rp", "quat_to_rpy",
                 "axis_angle_to_rotmat"):
        assert hasattr(models.rotation, name), name
    for name in ("bodyrate_step", "get_disturb_fn", "derive_dynamics_keys",
                 "periodic_disturb", "sin_disturb", "drag_disturb",
                 "mixed_disturb", "gaussian_disturb", "none_disturb"):
        assert hasattr(models.dynamics, name), name
    for name in ("generate_fixed_traj", "generate_lissa_traj",
                 "generate_lissa_traj_slow", "generate_zigzag_traj"):
        assert hasattr(models.trajectory, name), name
    for name in ("hovering_reward_fn", "tracking_reward_fn",
                 "tracking_penyaw_reward_fn", "tracking_realworld_reward_fn"):
        assert hasattr(models.rewards, name), name
    for name in ("EnvState3D", "EnvParams3D", "Action3D", "default_array",
                 "pack_state", "unpack_state", "PACKED_STATE_DIM"):
        assert hasattr(models, name), name
    assert hasattr(ops.covariance, "optimize_sigma")
    assert hasattr(ops.covariance, "optimize_sigma_ns")
    assert hasattr(ops, "make_rollout") and hasattr(ops, "make_hessian_cost")
    for name in ("make_mesh", "make_sharded_mppi_solve",
                 "make_multichip_covo_step", "make_batched_covo_solve",
                 "initialize_distributed"):
        assert hasattr(parallel, name), name
    from covo_mpc_tpu_torch import runtime

    for name in ("evaluate", "render_episode", "save_trace", "load_trace",
                 "MetricsLogger", "RunConfig"):
        assert hasattr(runtime, name), name
    from covo_mpc_tpu_torch.runtime import checkpoint

    for name in ("save_solver_state", "load_solver_state",
                 "save_eval_result"):
        assert hasattr(checkpoint, name), name


# --- the whole surface, read from JAX's sources -----------------------------------


def public_names(path: Path) -> set:
    """A module's public top-level names: its functions, classes and
    assigned names, and the names it imports from its own package."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names |= {n.id for tgt in targets for n in ast.walk(tgt)
                      if isinstance(n, ast.Name)}
        elif isinstance(node, ast.ImportFrom) and (
                node.level or (node.module or "").split(".")[0].startswith("covo_mpc_tpu")):
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.startswith("_")}


def jax_modules() -> list:
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def counterpart(rel: str) -> Path:
    return PORT_PKG / rel.replace("_pallas.py", "_cuda.py")


def test_every_jax_module_has_a_counterpart():
    missing = [rel for rel in jax_modules()
               if not counterpart(rel).exists() and rel not in NO_COUNTERPART]
    assert not missing, f"JAX modules with no counterpart in the port: {missing}"
    assert all(not counterpart(rel).exists() for rel in NO_COUNTERPART)


@pytest.mark.parametrize("rel", [r for r in jax_modules() if r not in NO_COUNTERPART])
def test_every_public_jax_name_is_in_the_port(rel):
    """JAX's public top-level names of ``rel``, less :data:`NOT_PORTED` and
    :data:`IMPORTED_NOT_API`, are all in the port's module; every name left
    out is one JAX still has (the lists cannot go stale)."""
    ours, ref = public_names(counterpart(rel)), public_names(JAX_PKG / rel)
    left_out = NOT_PORTED.get(rel, set()) | IMPORTED_NOT_API.get(rel, set())
    assert left_out <= ref, f"{rel}: listed but not in JAX: {left_out - ref}"
    missing = sorted(ref - left_out - ours)
    assert not missing, f"{counterpart(rel).relative_to(REPO)} lacks {missing}"


# --- the added names against their JAX twins --------------------------------------


def unit_quats(rng, *shape) -> np.ndarray:
    q = rng.normal(size=(*shape, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("batch", [(), (7,), (3, 5)])
def test_rotation_matches_jax(batch):
    """quat_conj, quat_integrate and rotate_vec in JAX's (x, y, z, w)
    convention, on unit quaternions with and without batch axes, 1e-6."""
    rng = np.random.default_rng(len(batch))
    q, q2 = unit_quats(rng, *batch), unit_quats(rng, *batch)
    omega = rng.normal(size=(*batch, 3)).astype(np.float32) * 3.0
    v = rng.normal(size=(*batch, 3)).astype(np.float32)
    dt = 0.02
    pairs = {
        "quat_conj": (rotation.quat_conj(t(q)), jrot.quat_conj(q)),
        "quat_integrate": (rotation.quat_integrate(t(q), t(omega), dt),
                           jrot.quat_integrate(q, omega, dt)),
        "rotate_vec": (rotation.rotate_vec(t(v), t(q)), jrot.rotate_vec(v, q)),
        "conj of a product": (rotation.quat_conj(rotation.quat_mul(t(q), t(q2))),
                              jrot.quat_conj(jrot.quat_mul(q, q2))),
    }
    for name, (ours, ref) in pairs.items():
        assert ours.shape == ref.shape, name
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, err_msg=name)
    # rotate_vec is the rotation matrix's product, and keeps the norm
    R = rotation.quat_to_rotmat(t(q))
    np.testing.assert_allclose(rotation.rotate_vec(t(v), t(q)).numpy(),
                               (R @ t(v)[..., None])[..., 0].numpy(), atol=1e-6)
    np.testing.assert_allclose(
        torch.linalg.norm(rotation.quat_integrate(t(q), t(omega), dt), dim=-1).numpy(),
        1.0, atol=1e-6)


def words(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


MAX_STEPS, DT = 300, 0.02


@pytest.mark.parametrize("name", ["generate_fixed_traj", "generate_lissa_traj",
                                  "generate_lissa_traj_slow", "generate_zigzag_traj"])
@pytest.mark.parametrize("seed", [0, 5, 1234])
def test_trajectory_generators_match_jax(name, seed):
    """The key-taking generators on JAX's key: each table within 1e-5 of
    JAX's at max_steps = 300, the uniforms they draw bit for bit."""
    key = jax.random.PRNGKey(seed)
    ours = getattr(trajectory, name)(MAX_STEPS, DT, words(key))
    ref = getattr(jtraj, name)(MAX_STEPS, DT, key)
    for table, (o, r) in zip(("pos", "vel", "acc"), zip(ours, ref)):
        assert o.shape == r.shape and o.dtype == torch.float32, table
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5, err_msg=table)
    if "lissa" in name:
        draws = trajectory.draw_lissajous(words(key), MAX_STEPS, "cpu")
        k_amp, k_phase = jax.random.split(key, 2)
        assert np.array_equal(bits(draws.amp), bits(jax.random.uniform(
            k_amp, (3, 2), minval=-1.0, maxval=1.0)))
        assert np.array_equal(bits(draws.phase), bits(jax.random.uniform(
            k_phase, (3, 2), minval=-jnp.pi, maxval=jnp.pi)))
    elif "zigzag" in name:
        draws = trajectory.draw_zigzag(words(key), MAX_STEPS, "cpu")
        ref_draws = zigzag_draws_from_key(key, MAX_STEPS)
        assert np.array_equal(bits(draws.start), bits(ref_draws.start))
        assert np.array_equal(bits(draws.segs), bits(ref_draws.segs))


def weights_and_samples(seed: int, N: int = 37, H: int = 6, dA: int = 4):
    rng = np.random.default_rng(seed)
    costs = (rng.gamma(2.0, size=N) * 0.05).astype(np.float32)
    weight = np.asarray(jred.mppi_weights(costs, 0.01))
    a = rng.normal(size=(N, H, dA)).astype(np.float32) * 0.5
    a_mean = rng.normal(size=(H, dA)).astype(np.float32) * 0.2
    A = rng.normal(size=(H, dA, dA)) * 0.3
    a_cov = (A @ A.transpose(0, 2, 1) + 0.1 * np.eye(dA)).astype(np.float32)
    return costs, weight, a, a_mean, a_cov, np.linalg.cholesky(a_cov).astype(np.float32)


@pytest.mark.parametrize("gamma_sigma", [0.0, 0.3])
def test_sample_first_reductions_match_jax(gamma_sigma):
    """weights_from_stats, mean_update, cov_update and cov_factor_update on
    (N, H, dA) samples against JAX's (1e-6) and against the port's own
    sample-last twins on the transposed samples; gamma_sigma = 0 leaves the
    covariance and factor untouched."""
    costs, weight, a, a_mean, a_cov, a_chol = weights_and_samples(int(gamma_sigma * 10))
    unnorm, total = reductions.weights_from_stats(t(costs), t(costs.min()), 0.01)
    j_unnorm, j_total = jred.weights_from_stats(costs, costs.min(), 0.01)
    np.testing.assert_allclose(unnorm.numpy(), np.asarray(j_unnorm), rtol=1e-6)
    np.testing.assert_allclose(float(total), float(j_total), rtol=1e-6)
    np.testing.assert_allclose((unnorm / total).numpy(),
                               reductions.mppi_weights(t(costs), 0.01).numpy(), rtol=1e-6)

    mean = reductions.mean_update(t(weight), t(a), t(a_mean), 0.7)
    np.testing.assert_allclose(mean.numpy(), np.asarray(
        jred.mean_update(weight, a, a_mean, 0.7)), atol=1e-6)
    cov = reductions.cov_update(t(weight), t(a), mean, t(a_cov), gamma_sigma)
    j_mean = jred.mean_update(weight, a, a_mean, 0.7)
    np.testing.assert_allclose(cov.numpy(), np.asarray(
        jred.cov_update(weight, a, j_mean, a_cov, gamma_sigma)), atol=1e-6)
    cov_f, chol = reductions.cov_factor_update(t(weight), t(a), mean, t(a_cov), t(a_chol),
                                               gamma_sigma)
    j_cov_f, j_chol = jred.cov_factor_update(weight, a, j_mean, a_cov, a_chol, gamma_sigma)
    np.testing.assert_allclose(cov_f.numpy(), np.asarray(j_cov_f), atol=1e-6)
    np.testing.assert_allclose(chol.numpy(), np.asarray(j_chol), atol=1e-6)
    assert chol.is_contiguous()
    if gamma_sigma == 0.0:
        assert cov is not None and torch.equal(cov, t(a_cov)) and torch.equal(chol, t(a_chol))

    a_t = t(a).permute(1, 2, 0).contiguous()
    for ours, twin in ((mean, reductions.mean_update_t(t(weight), a_t, t(a_mean), 0.7)),
                       (cov, reductions.cov_update_t(t(weight), a_t, mean, t(a_cov),
                                                     gamma_sigma))):
        np.testing.assert_allclose(ours.numpy(), twin.numpy(), atol=1e-7)
    for ours, twin in zip((cov_f, chol), reductions.cov_factor_update_t(
            t(weight), a_t, mean, t(a_cov), t(a_chol), gamma_sigma)):
        np.testing.assert_allclose(ours.numpy(), twin.numpy(), atol=1e-7)


def test_reductions_take_a_leading_scenario_axis():
    """A (B, N) stack of costs and (B, N, H, dA) samples updates each
    scenario as it alone would."""
    stacks = [weights_and_samples(s) for s in (3, 4)]
    w, a, m = (t(np.stack([s[i] for s in stacks])) for i in (1, 2, 3))
    got = reductions.mean_update(w, a, m, 1.0)
    for b in range(2):
        assert torch.equal(got[b], reductions.mean_update(w[b], a[b], m[b], 1.0))
    unnorm, total = reductions.weights_from_stats(w, w.amin(-1, keepdim=True), 0.01)
    assert total.shape == (2,) and unnorm.shape == w.shape


def test_fold_in_batch_and_the_other_exports_match_jax():
    key = jax.random.PRNGKey(11)
    ids = np.arange(3, 40)
    assert torch.equal(utils.fold_in_batch(words(key), torch.from_numpy(ids)),
                       words(j_fold_in_batch(key, jnp.asarray(ids))))
    from covo_mpc_tpu_torch.ops.rollout import make_hessian_cost

    assert ops.make_hessian_cost is make_hessian_cost


def test_action3d_and_default_array():
    """Action3D has JAX's fields; a default_array field gives each instance
    its own float32 tensor of the values."""
    from covo_mpc_tpu.models import structs as jstructs

    assert ([f.name for f in dataclasses.fields(models.Action3D)]
            == [f.name for f in dataclasses.fields(jstructs.Action3D)])
    act = models.Action3D(thrust=0.3, torque=torch.zeros(3))
    assert act.thrust == 0.3 and act.torque.shape == (3,)

    @dataclasses.dataclass
    class Holder:
        d: torch.Tensor = models.default_array([0.0, 1.5, -2.0])

    first, second = Holder(), Holder()
    assert first.d.dtype == torch.float32 and first.d.tolist() == [0.0, 1.5, -2.0]
    first.d.add_(1.0)
    assert second.d.tolist() == [0.0, 1.5, -2.0]
