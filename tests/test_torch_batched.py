"""The port's batched protocol against the JAX package and against itself:
the vmapped env step, the controllers' batched twins, ``evaluate_batched``,
``run_supervised_batched`` and ``CellStore``.

At a small size (B <= 5 episodes; the sampling twins at N=64, H=4), on the
CPU, where every kernel wrapper takes its plain version. Tolerances: the
batched env against JAX's ``jax.vmap`` of ``step`` / ``reset`` on the same
keys at tests/test_torch_models.py's ATOL (1e-5); a batch against the same
episodes run one at a time through the batched runner bit for bit (each
episode draws from its own generators, so nothing depends on the batch);
the PID twin (a vmap of the solve) against the per-episode solve 1e-6 (the
solve's two 3x3 products run as one ``mm`` alone and one ``bmm`` under
vmap, which round apart by an ulp on the CPU) and bit for bit against
itself at B=1; ``run_supervised_batched`` against ``evaluate_batched``
rtol 1e-5, atol 1e-7 (JAX's own test's); a resumed run against an
uninterrupted one bit for bit; the sampling twins' first solve of episodes
2-3 at B=4 and at B=2 from offset 2 within 2e-4 (BASELINE.md's per-solve
contract); the plain K7's draws at an offset bit for bit, their costs atol
2e-4, rtol 1e-5. The card's cases (captured batched solves and episodes
against eager ones, K7's offset in the kernels) are in
tests/test_torch_graphs.py.
"""

import functools
import json
import tempfile

import jax
import numpy as np
import pytest
import torch

from covo_mpc_tpu.runtime.supervisor import CellStore as JCellStore
from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv
from covo_mpc_tpu_torch.models.batched import BatchedEnv
from covo_mpc_tpu_torch.models.structs import index, stack, tree_flatten
from covo_mpc_tpu_torch.ops import rollout_cuda
from covo_mpc_tpu_torch.parallel import batched_controller
from covo_mpc_tpu_torch.runtime import (
    CellStore,
    evaluate_batched,
    make_batched_episode_runner,
    run_supervised,
    run_supervised_batched,
)
from covo_mpc_tpu_torch.runtime.episode import eager_episode, episode_seeds
from covo_mpc_tpu_torch.solvers import FAST_PATH, get_solver
from tests.test_torch_models import (
    ATOL,
    ENV_KW,
    assert_states_close,
    make_envs,
    reset_draws_from_key,
    step_draws_from_key,
)

B = 3
PSTR = "N64_H4_lam0.01"


def cpu_env(**overrides):
    return QuadEnv(EnvConfig(**{**ENV_KW, **overrides}), device="cpu")


def _pid(env):
    return get_solver(env, "pid")[0]


@functools.lru_cache(maxsize=None)
def _eval_5():
    """evaluate_batched (PID, num_eps=5, seed=2), shared by the tests that
    read it."""
    env = cpu_env()
    return evaluate_batched(env, _pid(env), num_eps=5, seed=2)


@functools.lru_cache(maxsize=None)
def _supervised_5():
    """run_supervised_batched over _eval_5's protocol in chunks of 2 (the
    last one ragged), checkpointed into a fresh directory: (result, dir)."""
    env = cpu_env()
    ckpt = tempfile.mkdtemp(prefix="batched_ckpt_")
    return run_supervised_batched(env, _pid(env), num_eps=5, seed=2,
                                  checkpoint_dir=ckpt, chunk_episodes=2), ckpt


def _gens(seed, lo, hi, stream):
    """Episodes lo..hi-1's generators of one stream (0 reset, 1 step, 2
    solve), as the batched runner seeds them."""
    return [torch.Generator().manual_seed(episode_seeds(seed, e)[stream])
            for e in range(lo, hi)]


def _leaves_equal(a, b) -> bool:
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _max_diff(a, b) -> float:
    return max(float((x - y).abs().max())
               for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]))


@functools.lru_cache(maxsize=None)
def _j_reset_draws_fn(n_seg: int, scale: float):
    """reset_draws_from_key's draws for a batch of keys in one jitted vmap:
    (start, segs, f_disturb / scale, obs noise), each with a leading axis."""
    jnp = jax.numpy

    def one(key):
        traj_key, disturb_key, _ = jax.random.split(key, 3)
        seg_keys = jax.random.split(traj_key, n_seg)
        start = jax.random.uniform(seg_keys[0], (3,), minval=-1.0, maxval=1.0)
        segs = jax.vmap(lambda k: jnp.concatenate([
            jax.random.uniform(k, (2,), minval=-jnp.pi / 3, maxval=jnp.pi / 3),
            jax.random.uniform(k, minval=1.0, maxval=1.5)[None]]))(seg_keys)
        f = jax.random.uniform(disturb_key, (3,), minval=-scale, maxval=scale)
        info_key, _ = jax.random.split(key)
        k_pos, k_vel, k_quat, k_omega, _ = jax.random.split(info_key, 5)
        noise = jnp.concatenate([jax.random.normal(k_pos, (3,)),
                                 jax.random.normal(k_vel, (3,)),
                                 jax.random.normal(k_quat, (4,)),
                                 jax.random.normal(k_omega, (3,))])
        return start, segs, f / scale, noise

    return jax.jit(jax.vmap(one))


def _reset_draws(jenv, keys, jp):
    """The draws JAX's reset_env makes from each of ``keys``, stacked."""
    from covo_mpc_tpu_torch.models.quad_env import ResetDraws
    from covo_mpc_tpu_torch.models.trajectory import ZigzagDraws, num_segments

    start, segs, f, noise = (torch.from_numpy(np.array(x, np.float32)) for x in
                             _j_reset_draws_fn(num_segments(jenv._max_steps),
                                               float(jp.disturb_scale))(keys))
    return ResetDraws(traj=ZigzagDraws(start=start, segs=segs), f_disturb=f,
                      obs_noise=noise)


# --- the batched env ---------------------------------------------------------


def test_stack_and_index_invert_each_other():
    """stack / index over the env's states, draws and infos: index(stack(xs),
    b) is xs[b] bit for bit, non-tensor leaves (None, control_params) kept."""
    env = cpu_env()
    gens = [torch.Generator().manual_seed(s) for s in range(B)]
    resets = [env.reset(g) for g in gens]
    for trees in ([r[2] for r in resets], [r[1] for r in resets],
                  [env.draw_reset(g) for g in gens], [env.draw_step(g) for g in gens]):
        batched = stack(trees)
        assert tree_flatten(batched)[0][0].shape[0] == B
        assert all(_leaves_equal(index(batched, b), trees[b]) for b in range(B))
    with pytest.raises(ValueError):
        stack([resets[0][2], resets[1][2].replace(control_params=1.0)])


def test_batched_env_matches_jax_vmap():
    """BatchedEnv's reset and auto-resetting step against JAX's jax.vmap of
    reset and step on the same keys (the draws JAX makes from them handed
    to the port), B=3 episodes over 20 steps under the batched PID twin's
    actions, each package carrying its own states; episode 1 starts at
    t=290, so it hits the time limit and auto-resets mid-run."""
    jenv, env = make_envs()
    jp, p = jenv.default_params, env.default_params
    benv = BatchedEnv(env)
    rkeys = jax.random.split(jax.random.PRNGKey(3), B)
    _, _, jstate = jax.vmap(jenv.reset, in_axes=(0, None))(rkeys, jp)
    draws = _reset_draws(jenv, rkeys, jp)
    assert _leaves_equal(index(draws, 1), reset_draws_from_key(jenv, rkeys[1], jp))
    obs, info, state = benv.reset_from_draws(draws, p)
    assert_states_close(state, jstate, msg="reset")
    jstate = jstate.replace(time=jstate.time.at[1].set(290))
    time = state.time.clone()
    time[1] = 290
    state = state.replace(time=time)
    twin = batched_controller(_pid(env))
    carry = twin.reset(B)
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    jstep = jax.jit(jax.vmap(jenv.step, in_axes=(0, 0, 0, None)))
    dones = []
    for i in range(20):
        action, carry = twin(state, info, p, carry, None)
        split = [jax.random.split(k, 3) for k in keys]
        keys = [s[0] for s in split]
        step_keys = [s[1] for s in split]
        jobs, jstate, jrew, jdone, jinfo = jstep(
            jax.numpy.stack(step_keys), jstate, action.numpy(), jp)
        halves = [jax.random.split(k) for k in step_keys]
        obs, state, rew, done, info = benv.step_from_draws(
            stack([step_draws_from_key(h[0]) for h in halves]),
            _reset_draws(jenv, jax.numpy.stack([h[1] for h in halves]), jp),
            state, action, p)
        assert_states_close(state, jstate, msg=f"step {i}")
        assert_states_close(info["noisy_state"], jinfo["noisy_state"], msg=f"noisy {i}")
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=ATOL)
        np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=ATOL)
        np.testing.assert_allclose(info["err_pos"].numpy(), np.asarray(jinfo["err_pos"]),
                                   atol=ATOL)
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        dones.append(done)
    assert bool(torch.stack(dones)[:, 1].any()) and not bool(torch.stack(dones)[:, 0].any())


def test_batched_pid_twin_matches_the_per_episode_solve():
    """The PID twin (vmap of the solve) on 10 steps of B=3 episodes: each
    episode's action and carry within 1e-6 of the per-episode solve, and
    bit for bit what the twin gives that episode alone (B=1)."""
    env = cpu_env()
    p, pid = env.default_params, _pid(env)
    twin = batched_controller(pid)
    benv = BatchedEnv(env)
    obs, info, state = benv.reset(_gens(7, 0, B, 0), p)
    carry = twin.reset(B)
    step_gens = _gens(7, 0, B, 1)
    for _ in range(10):
        action, new = twin(state, info, p, carry, None)
        for b in range(B):
            a1, c1, _ = pid(None, index(state, b), p, index(carry, b))
            assert float((a1 - action[b]).abs().max()) <= 1e-6
            assert _max_diff(c1, index(new, b)) <= 1e-6
            alone, alone_c = twin(stack([index(state, b)]), None, p,
                                  stack([index(carry, b)]), None)
            assert torch.equal(alone[0], action[b]) and _leaves_equal(index(alone_c, 0),
                                                                      index(new, b))
        carry = new
        obs, state, _, _, info = benv.step(step_gens, state, action, p)


# --- evaluate_batched and the supervised batched protocol ---------------------


def test_evaluate_batched_equals_the_episodes_one_by_one():
    """evaluate_batched (PID, num_eps=5, seed=2) equals the same five
    episodes run one at a time (B=1) with each episode's streams, bit for
    bit, and the sequential runner's eager episodes on those streams (the
    first) within rtol 1e-6 (the PID's mm against bmm, above)."""
    env = cpu_env()
    res = _eval_5()
    assert res.err_pos_ep.shape == (5,) and np.isfinite(res.mean)
    assert res.std == pytest.approx(float(np.std(res.err_pos_ep.numpy())), rel=1e-5)
    run = make_batched_episode_runner(env, _pid(env))
    one = torch.stack([run(2, e, e + 1)[0].mean(dim=1)[0] for e in range(5)])
    assert torch.equal(one, res.err_pos_ep)
    seq = torch.stack([
        eager_episode(env, _pid(env), 300, _gens(2, e, e + 1, 0)[0],
                      _gens(2, e, e + 1, 1)[0])[0].mean() for e in range(1)])
    np.testing.assert_allclose(seq.numpy(), res.err_pos_ep[:1].numpy(), rtol=1e-6)


def test_batched_supervised_matches_evaluate_batched():
    """JAX's test: chunked batched supervision reproduces evaluate_batched's
    per-episode values (rtol 1e-5, atol 1e-7), a ragged tail chunk included;
    the manifest shows three chunks of the batched protocol."""
    sup, ckpt = _supervised_5()
    ref = _eval_5()
    np.testing.assert_allclose(sup.err_pos_ep.numpy(), ref.err_pos_ep.numpy(),
                               rtol=1e-5, atol=1e-7)
    assert not sup.failed.any()
    with open(f"{ckpt}/manifest.json") as fh:
        m = json.load(fh)
    assert m["completed"] == 3 and m["protocol"] == "batched"


def test_batched_crash_then_resume(tmp_path):
    """JAX's test: a run killed at chunk 2 (of 5 episodes in chunks of 2)
    resumes there, and its result equals an uninterrupted supervised run bit
    for bit."""
    env = cpu_env()
    ckpt = str(tmp_path / "ckpt")
    ref = _supervised_5()[0]

    def hook(chunk, attempt):
        if chunk == 2:
            raise RuntimeError("persistent outage")

    with pytest.raises(RuntimeError, match="re-run the same command"):
        run_supervised_batched(env, _pid(env), num_eps=5, seed=2, checkpoint_dir=ckpt,
                               chunk_episodes=2, max_retries=0, _fault_hook=hook)
    sup = run_supervised_batched(env, _pid(env), num_eps=5, seed=2, checkpoint_dir=ckpt,
                                 chunk_episodes=2)
    assert sup.resumed_at_chunk == 2
    np.testing.assert_array_equal(sup.err_pos_ep.numpy(), ref.err_pos_ep.numpy())


def test_batched_refuses_a_mismatched_checkpoint(tmp_path):
    env = cpu_env()
    ckpt = str(tmp_path / "ckpt")
    run_supervised_batched(env, _pid(env), num_eps=1, seed=1, checkpoint_dir=ckpt,
                           chunk_episodes=1, fingerprint="a")
    with pytest.raises(ValueError, match="different protocol"):
        run_supervised_batched(env, _pid(env), num_eps=1, seed=1, checkpoint_dir=ckpt,
                               chunk_episodes=1, fingerprint="b")


@pytest.mark.parametrize("name", ["covo_speculative", "covo_offline"])
def test_evaluate_batched_runs_speculative_and_offline(name):
    """The speculative and offline twins (main path's settings, N=8, H=2)
    run JAX's throughput protocol: two whole episodes, finite, one mean
    each."""
    env = cpu_env()
    solver, _ = get_solver(env, name, "N8_H2_lam0.01", **FAST_PATH)
    res = evaluate_batched(env, solver, num_eps=2)
    assert res.err_pos_ep.shape == (2,) and np.isfinite(res.err_pos_ep.numpy()).all()


# --- the sampling twins: chunk independence, K7's offset -----------------------


@pytest.mark.parametrize("name", ["covo_online", "mppi"])
def test_sampling_twin_first_solve_does_not_depend_on_its_chunk(name):
    """engine="torch" (fast rng: each episode's normals from its own
    generator): episodes 2-3's first solve in a batch of 4 equals their
    first solve in a batch of 2 from offset 2 within 2e-4."""
    env = cpu_env()
    p = env.default_params
    solver, _ = get_solver(env, name, PSTR, hessian_mode="adjoint", engine="torch",
                           rng_mode="fast", sigma_mode="ns", collect_debug=False)
    benv = BatchedEnv(env)

    def first(lo, hi):
        twin = batched_controller(solver)
        twin.seed(5)
        _, info, state = benv.reset(_gens(5, lo, hi, 0), p)
        action, carry = twin(state, info, p, twin.reset(hi - lo), _gens(5, lo, hi, 2), lo)
        return action, carry

    a4, c4 = first(0, 4)
    a2, c2 = first(2, 4)
    assert float((a4[2:] - a2).abs().max()) <= 2e-4
    for x4, x2 in zip(tree_flatten(c4)[0], tree_flatten(c2)[0]):
        assert float((x4[2:] - x2).abs().max()) <= 2e-4


@pytest.mark.parametrize("joint", [False, True], ids=["per_step", "joint"])
def test_plain_k7_draws_follow_the_episode_offset(joint):
    """The plain K7: scenario b at offset o draws what scenario o + b draws
    at offset 0 (bit for bit; costs atol 2e-4, rtol 1e-5), and scenario 0
    at offset 0 draws what the plain K1 / K5 draw from the same seed."""
    env = cpu_env()
    p = env.default_params
    gens = [torch.Generator().manual_seed(s) for s in range(4)]
    states = [env.reset(g)[1]["noisy_state"] for g in gens]
    from covo_mpc_tpu_torch.models import pack_state
    from covo_mpc_tpu_torch.models.structs import expand_params

    Hs, n = 4, 256
    args = (torch.stack([pack_state(s) for s in states]), torch.stack([s.time for s in states]),
            torch.stack([s.pos_traj for s in states]), torch.stack([s.vel_traj for s in states]))
    g = torch.Generator().manual_seed(1)
    means = torch.randn(4, Hs, 4, generator=g) * 0.2
    fac = (torch.randn(4, 4 * Hs, 4 * Hs, generator=g) * 0.1 if joint else
           (0.3 * torch.eye(4)).expand(4, Hs, 4, 4).contiguous())
    k7 = rollout_cuda.make_rollout_batched_sampling(env, joint=joint)
    c4, a4 = k7(*args, means, fac, expand_params(p, 4), 11, n, deterministic=True)
    c2, a2 = k7(*(x[2:] for x in args), means[2:], fac[2:], expand_params(p, 2), 11, n,
                deterministic=True, offset=torch.tensor(2, dtype=torch.int32))
    assert torch.equal(a2, a4[2:])
    np.testing.assert_allclose(c2.numpy(), c4[2:].numpy(), atol=2e-4, rtol=1e-5)
    single = (rollout_cuda.make_rollout_joint_sampling(env) if joint
              else rollout_cuda.make_rollout_sampling(env))
    _, a1 = single(*(x[0] for x in args), means[0], fac[0], p, 11, n, deterministic=True)
    assert torch.equal(a1, a4[0])
    assert not torch.equal(a4[0], a4[1])


# --- CellStore (mirrors of tests/test_supervisor.py) -----------------------------


def test_cell_store_resumes_matrix(tmp_path):
    """A sweep interrupted mid-matrix resumes without recomputing finished
    cells; a fingerprint change invalidates exactly that cell."""
    store = CellStore(str(tmp_path / "sweep"))
    calls = []

    def run_matrix(store, fail_at=None):
        out = {}
        for cell in ("a", "b", "c"):
            def fn(ckpt_dir, cell=cell):
                calls.append(cell)
                if cell == fail_at:
                    raise RuntimeError("outage")
                assert ckpt_dir.startswith(store.root)
                return {"mean": {"a": 1.0, "b": 2.0, "c": 3.0}[cell]}

            out[cell], _ = store.run_cell(cell, "fp1", fn)
        return out

    with pytest.raises(RuntimeError):
        run_matrix(store, fail_at="c")
    assert calls == ["a", "b", "c"]
    store2 = CellStore(str(tmp_path / "sweep"))
    out = run_matrix(store2)
    assert calls == ["a", "b", "c", "c"]
    assert out == {"a": {"mean": 1.0}, "b": {"mean": 2.0}, "c": {"mean": 3.0}}
    v, cached = store2.run_cell("b", "fp2", lambda d: {"mean": 9.0})
    assert v == {"mean": 9.0} and not cached
    assert store2.get("b", "fp1") is None
    assert CellStore(str(tmp_path / "sweep")).get("a", "fp1") == {"mean": 1.0}


def test_cell_store_clears_stale_checkpoint_on_fingerprint_change(tmp_path):
    """A fingerprint change with a stale per-cell checkpoint recomputes, and
    a refusal for a protocol field the fingerprint does not encode (the
    seed) clears the checkpoint and retries once; drop(clear_checkpoint=)
    removes a finished one."""
    env = cpu_env()
    store = CellStore(str(tmp_path / "sweep"))

    def cell(fp, seed=1):
        def fn(ckpt_dir):
            res = run_supervised(env, _pid(env), total_steps=300, seed=seed,
                                 checkpoint_dir=ckpt_dir, chunk_episodes=1,
                                 fingerprint=fp)
            return {"mean": float(res.mean)}
        return fn

    v1, cached1 = store.run_cell("x", "fpA", cell("fpA"))
    v2, cached2 = store.run_cell("x", "fpB", cell("fpB"))
    assert not cached1 and not cached2 and v2 == v1
    store.drop("x")  # memo miss, the fpB / seed 1 checkpoint left on disk
    v3, cached3 = store.run_cell("x", "fpB", cell("fpB", seed=2))
    assert not cached3 and np.isfinite(v3["mean"])
    store.drop("x", clear_checkpoint=True)
    assert not (tmp_path / "sweep" / CellStore._slug("x") / "manifest.json").exists()


def test_cell_store_files_load_both_ways(tmp_path):
    """cells.json written by JAX's CellStore reads in the port's and the
    reverse; both name a cell's directory alike, and keys whose readable
    prefixes collide ('covo N=8', 'covo_N.8') get distinct directories."""
    jstore = JCellStore(str(tmp_path / "sweep"))
    jstore.put("covo N=8", "fp", {"mean": 3.6, "std": 0.5})
    store = CellStore(str(tmp_path / "sweep"))
    assert store.get("covo N=8", "fp") == {"mean": 3.6, "std": 0.5}
    store.put("covo_N.8", "fp2", {"mean": 6.9})
    again = JCellStore(str(tmp_path / "sweep"))
    assert again.get("covo_N.8", "fp2") == {"mean": 6.9}
    assert again.get("covo N=8", "fp") == {"mean": 3.6, "std": 0.5}
    for key in ("covo N=8", "covo_N.8", "mppi/N=64 λ"):
        assert CellStore._slug(key) == JCellStore._slug(key)
        assert store.cell_dir(key) == jstore.cell_dir(key)
    assert CellStore._slug("covo N=8") != CellStore._slug("covo_N.8")
    assert CellStore._slug("covo N=8").startswith("covo_N_8-")
