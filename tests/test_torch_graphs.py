"""The port's captured solves and episode (``runtime/graphs.py``,
``runtime/episode.py``), the solvers' device seed stream
(``ops/sampling.py::SeedStream``) and the latency helpers
(``runtime/profiling.py``).

On the CPU: the seed stream against a numpy ``uint64`` splitmix64, the
solvers' per-solve keys (each solve its own; ``seed(s)`` replays the chain
bit for bit), the plain K1 and K5 fed a key as a tensor against their int
form, the pytree helpers the graphs stand on, the graphs' refusal of CPU
tensors, ``time_blocking``'s keys and percentiles on a stubbed clock, and the
CPU episode runner (the eager loop). On the card (marker ``cuda``, skipped
without one): captured solves against eager ones from the same seed (2e-4,
BASELINE.md's per-solve contract), fresh draws at each replay, replayed
launch counts, the first 10 steps of a captured episode against the eager
loop (2e-4; later steps diverge by chaos, BASELINE.md), the kernels' device
keys against a numpy Philox4x32-10 + Box-Muller, a capture that fails
raising, and the harness that rides on the captured runner: a captured
episode's solve metrics against the eager episode's (bit for bit over 300
steps), the command line's eval launching K1-K3 once a step, and a
captured render against the eager one (bit for bit, reset_on_done too);
the batched protocol: captured batched solves (CoVO and MPPI kernel rng,
MPPI fast) and the batched runner's captured episodes against eager ones
bit for bit, a replayed batched chunk with no host sync, and K7's episode
offset (scenario b at offset o draws what scenario o + b draws at 0).
``python -m pytest tests/test_torch_graphs.py -q`` runs either set where
it can.
"""

import dataclasses

import numpy as np
import pytest
import torch

from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv, pack_state
from covo_mpc_tpu_torch.models.structs import float_leaves
from covo_mpc_tpu_torch.ops import rollout_cuda, sampling
from covo_mpc_tpu_torch.runtime import graphs, profiling
from covo_mpc_tpu_torch.runtime.episode import (
    CapturedEpisode,
    eager_episode,
    make_episode_runner,
)
from covo_mpc_tpu_torch.solvers import get_solver
from covo_mpc_tpu_torch.solvers.covo import CoVOParams

ENV_KW = dict(task="tracking_zigzag", enable_randomizer=False,
              disturb_type="gaussian", disable_rollover_terminate=True,
              generate_noisy_state=True)
PSTR = "N64_H4_lam0.01"
M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def splitmix64_np(x: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer in numpy uint64 (products wrap mod 2^64)."""
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def stream_np(seed: int, counters: np.ndarray, n: int) -> np.ndarray:
    """The words ``SeedStream.next(n)`` gives at each counter, (C, n)."""
    j = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        state = (np.uint64(seed) + np.uint64(0x9E3779B97F4A7C15)
                 * (counters.astype(np.uint64)[:, None] * np.uint64(n) + j))
    return splitmix64_np(state)


def cpu_env():
    return QuadEnv(EnvConfig(**ENV_KW), device="cpu")


# --- the seed stream ---------------------------------------------------------


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 2), (2**64 - 3, 2), (123456789, 3)])
def test_seed_stream_matches_numpy_uint64(seed, n):
    """300 solves' words equal a numpy uint64 splitmix64 of seed + GOLDEN
    (n c + j), bit for bit; none repeats."""
    stream = sampling.SeedStream("cpu", seed)
    got = np.stack([stream.next(n).numpy().view(np.uint64) for _ in range(300)])
    ref = stream_np(seed, np.arange(1, 301), n)
    assert np.array_equal(got, ref)
    assert len(np.unique(got)) == got.size
    assert int(stream.counter) == 300


def test_splitmix64_is_the_reference_finalizer():
    """Known splitmix64 outputs: the first words of the generator seeded 0
    (Vigna's reference C code: state += GOLDEN, then the finalizer)."""
    x = torch.tensor([sampling.as_int64(0x9E3779B97F4A7C15 * k) for k in (1, 2, 3)])
    words = [int(w) & int(M64) for w in sampling.splitmix64(x)]
    assert words == [0xE220A8397B1DCDAF, 0x6E789E6AA1B965F4, 0x06C45D188009454F]


def _spy_keys(solver):
    """Record the Philox keys each solve hands the sampling kernel."""
    seen = []
    inner = solver.rollout_sampling

    def spy(*args, **kw):
        seen.append((rollout_cuda.seed_value(args[7]),
                     None if kw.get("disturb_seed") is None
                     else rollout_cuda.seed_value(kw["disturb_seed"])))
        return inner(*args, **kw)

    solver.rollout_sampling = spy
    return seen


@pytest.mark.parametrize("name", ["covo_online", "mppi"])
def test_consecutive_solves_take_different_seeds(name):
    """A CPU solver with kernel rng (the plain K1 / K5) keys each solve
    afresh from its stream: five solves, ten distinct words for MPPI (the
    actions' and the krng draw's); the words are the stream's."""
    env = cpu_env()
    solver, cp = get_solver(env, name, PSTR, rng_mode="kernel", engine="cuda", seed=4,
                            hessian_mode="gn", sigma_mode="ns", collect_debug=False)
    seen = _spy_keys(solver)
    obs, info, state = env.reset(torch.Generator().manual_seed(0))
    for _ in range(5):
        _, cp, _ = solver(obs, state, env.default_params, cp, info)
    n = 2 if name == "mppi" else 1
    words = [w for pair in seen for w in pair[:n]]
    assert len(set(words)) == 5 * n
    assert np.array_equal(np.array(words, dtype=np.uint64).reshape(5, n),
                          stream_np(4, np.arange(1, 6), n))


@pytest.mark.parametrize("name,rng_mode", [("covo_online", "kernel"), ("mppi", "kernel"),
                                           ("mppi", "fast"), ("covo_speculative", "kernel")])
def test_seed_replays_the_chain_of_solves(name, rng_mode):
    """``seed(s)`` twice gives the same chain of three solves bit for bit;
    another seed gives other actions."""
    env = cpu_env()
    solver, cp0 = get_solver(env, name, PSTR, rng_mode=rng_mode, engine="cuda",
                             hessian_mode="gn", sigma_mode="ns", collect_debug=False)
    obs, info, state = env.reset(torch.Generator().manual_seed(1))
    p = env.default_params
    cp0 = solver.reset(state, p, cp0)

    def chain(s):
        solver.seed(s)
        cp, out = cp0, []
        for _ in range(3):
            a, cp, _ = solver(obs, state, p, cp, info)
            out.append(torch.cat([a, cp.a_mean.flatten()]))
        return torch.stack(out)

    first, again, other = chain(7), chain(7), chain(8)
    assert torch.equal(first, again)
    assert not torch.equal(first, other)


def _rollout_args(env, seed=2):
    _, info, _ = env.reset(torch.Generator().manual_seed(seed))
    st = info["noisy_state"]
    return (pack_state(st), st.time, st.pos_traj, st.vel_traj)


def test_plain_k1_and_k5_take_a_seed_tensor():
    """The plain K1 and K5 (the wrappers on CPU tensors) keyed by a 0-d
    int64 word equal their int form, also for a key past 2^63 (a word's
    negative int64), and K5's krng draw likewise."""
    env = cpu_env()
    p = env.default_params
    roll = _rollout_args(env)
    g = torch.Generator().manual_seed(3)
    H, N = 4, 64
    a_mean = torch.randn(H, 4, generator=g) * 0.2
    factor = torch.randn(4 * H, 4 * H, generator=g) * 0.1
    k1 = rollout_cuda.make_rollout_joint_sampling(env)
    for key in (11, 2**64 - 5):
        word = torch.tensor(sampling.as_int64(key))
        c_i, a_i = k1(*roll, a_mean, factor, p, key, N, deterministic=True)
        c_t, a_t = k1(*roll, a_mean, factor, p, word, N, deterministic=True)
        assert torch.equal(c_i, c_t) and torch.equal(a_i, a_t)
    chol = torch.linalg.cholesky(0.1 * torch.eye(4).expand(H, 4, 4)).contiguous()
    k5 = rollout_cuda.make_rollout_sampling(env)
    out_i = k5(*roll, a_mean, chol, p, 21, N, disturb_seed=22)
    out_t = k5(*roll, a_mean, chol, p, torch.tensor(21), N,
               disturb_seed=torch.tensor(22))
    assert all(torch.equal(x, y) for x, y in zip(out_i, out_t))
    other = k5(*roll, a_mean, chol, p, torch.tensor(21), N, disturb_seed=torch.tensor(23))
    assert torch.equal(other[1], out_t[1]) and not torch.equal(other[0], out_t[0])


# --- the pytree helpers and the graphs' guards -----------------------------------


def _params():
    return CoVOParams(gamma_mean=1.0, gamma_sigma=0.0, discount=1.0, sample_sigma=0.5,
                      a_mean=torch.zeros(4, 4), a_cov=torch.eye(16))


def test_flatten_roundtrip_and_spec():
    """flatten / unflatten round-trip dataclasses, dicts, tuples, None and
    floats; the spec tells trees apart by a constant, a shape or a dtype."""
    env = cpu_env()
    obs, info, state = env.reset(torch.Generator().manual_seed(0))
    tree = (obs, state, _params(), info, None, 3)
    leaves, spec = graphs.flatten(tree)
    back = graphs.unflatten(spec, leaves)
    leaves2, spec2 = graphs.flatten(back)
    assert spec2 == spec and all(a is b for a, b in zip(leaves, leaves2))
    assert isinstance(back[1], type(state)) and back[3].keys() == info.keys()
    assert back[4] is None and back[5] == 3
    for changed in (_params().replace(gamma_mean=0.5),
                    _params().replace(a_mean=torch.zeros(5, 4)),
                    _params().replace(a_cov=torch.eye(16, dtype=torch.float64))):
        assert graphs.flatten(changed)[1] != graphs.flatten(_params())[1]


def test_copy_into_copies_in_place_and_guards_aliasing():
    """copy_into writes each source into its destination in place; a source
    that is another destination's memory is read before it is overwritten;
    trees of another spec raise."""
    a, b = torch.zeros(3), torch.ones(3)
    dst = {"x": a, "y": b}
    graphs.copy_into(dst, {"x": b, "y": a + 5})  # x <- old y, y <- 5
    assert dst["x"] is a and torch.equal(a, torch.ones(3))
    assert torch.equal(b, torch.full((3,), 5.0))
    swap = {"x": a, "y": b}
    graphs.copy_into(swap, {"x": b, "y": a})  # a swap through the clones
    assert torch.equal(a, torch.full((3,), 5.0)) and torch.equal(b, torch.ones(3))
    with pytest.raises(ValueError):
        graphs.copy_into({"x": a}, {"x": torch.zeros(4)})


def test_graphs_refuse_cpu_tensors():
    """A capture of CPU tensors raises before anything runs: the CPU path
    is the eager one, asked for by the caller."""
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    with pytest.raises(ValueError, match="CUDA tensors only"):
        graphs.capture(fn, torch.ones(3))
    env = cpu_env()
    solver, cp = get_solver(env, "mppi", PSTR, rng_mode="fast", collect_debug=False)
    obs, info, state = env.reset(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        graphs.capture_solver(solver, solver, obs, state, env.default_params, cp, info)
    assert calls == []


# --- the latency helpers -----------------------------------------------------------


def test_time_blocking_keys_and_percentiles(monkeypatch):
    """JAX's keys (p50, p90, p99, mean, iters), each equal to numpy's over
    the stubbed clock's intervals; the warm-up calls are not timed."""
    durations = [0.003, 0.001, 0.010, 0.002, 0.004, 0.007, 0.005]
    ticks, now = [], 100.0
    for d in durations:
        ticks += [now, now + d]
        now += 1.0
    clock = iter(ticks)
    monkeypatch.setattr(profiling, "_clock", lambda: next(clock))
    calls = []

    def fn():
        calls.append(1)
        return {"action": torch.ones(4)}

    stats = profiling.time_blocking(fn, len(durations), 2)
    assert set(stats) == {"p50", "p90", "p99", "mean", "iters"}
    assert stats["iters"] == len(durations) and len(calls) == len(durations) + 2
    for q in (50, 90, 99):
        assert stats[f"p{q}"] == pytest.approx(np.percentile(durations, q), rel=1e-12)
    assert stats["mean"] == pytest.approx(np.mean(durations), rel=1e-12)


def test_trace_is_a_no_op_without_a_directory(tmp_path):
    with profiling.trace(None) as prof:
        torch.ones(3).sum()
    assert prof is None
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(3).sum()
    assert prof is not None and list(tmp_path.glob("trace_*.json"))


def test_settle_waits_out_the_spell_after_the_last_capture(monkeypatch):
    """graphs.settle sleeps until SETTLE_S (or the seconds given) have
    passed since the last capture, and not at all once they have or when
    nothing was captured."""
    slept = []
    monkeypatch.setattr(graphs.time, "sleep", slept.append)
    monkeypatch.setattr(graphs.time, "monotonic", lambda: 100.0)
    monkeypatch.setattr(graphs, "_last_capture", [95.0])
    assert graphs.settle() == pytest.approx(graphs.SETTLE_S - 5.0)
    assert slept == [pytest.approx(graphs.SETTLE_S - 5.0)]
    assert graphs.settle(5.0) == 0.0 and len(slept) == 1
    monkeypatch.setattr(graphs, "_last_capture", [float("-inf")])
    assert graphs.settle() == 0.0 and len(slept) == 1


def test_settle_watches_a_probe_until_the_spell_ends(monkeypatch):
    """Given a probe, graphs.settle reads it after the wait until three
    readings in a row lie SETTLE_DROP below the median of those before
    (the spell's end), or for watch_s when none falls; a spike or a dip
    short of SETTLE_DROP does not end the watch, and a call with no
    capture since the last watch reads nothing."""
    clock = [100.0]
    monkeypatch.setattr(graphs.time, "monotonic", lambda: clock[0])
    monkeypatch.setattr(graphs.time, "sleep", lambda s: clock.__setitem__(0, clock[0] + s))
    monkeypatch.setattr(graphs, "_last_watch", [float("-inf")])
    monkeypatch.setattr(graphs, "_last_capture", [70.0])
    spell = iter([2.06, 2.52, 2.05, 2.00, 2.06, 2.07, 1.86, 1.85, 1.86, 1.85])
    monkeypatch.setattr(graphs, "_probe_ms", lambda probe: next(spell))
    seconds = graphs.settle(probe=object())
    assert [r for _, r in graphs.last_readings] == [2.06, 2.52, 2.05, 2.00, 2.06,
                                                    2.07, 1.86, 1.85, 1.86]
    assert seconds == pytest.approx(8 * graphs.PROBE_GAP_S)
    assert graphs.settle(probe=object()) == 0.0 and graphs.last_readings == []

    clock[0] += 1.0  # a capture after that watch
    graphs._last_capture[0] = clock[0]
    monkeypatch.setattr(graphs, "_probe_ms", lambda probe: 1.86)
    seconds = graphs.settle(probe=object(), watch_s=1.0)
    assert seconds == pytest.approx(graphs.SETTLE_S + 1.0)
    assert [t for t, _ in graphs.last_readings] == pytest.approx([0.0, 0.25, 0.5, 0.75, 1.0])


def test_time_chained_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: time_chained measures there")
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.time_chained(lambda c: c, torch.ones(1))


# --- the CPU episode runner --------------------------------------------------------


def test_cpu_runner_is_the_eager_loop():
    """On a CPU env the runner is the eager loop: the same err_pos as
    eager_episode on the same generators and seed, bit for bit."""
    env = cpu_env()
    solver, _ = get_solver(env, "mppi", PSTR, rng_mode="kernel", engine="cuda", collect_debug=False)
    run = make_episode_runner(env, solver, steps=12)
    assert not isinstance(run, CapturedEpisode)
    solver.seed(2)
    err, done, _ = run(torch.Generator().manual_seed(0), torch.Generator().manual_seed(1))
    solver.seed(2)
    err2, done2, _ = eager_episode(env, solver, 12, torch.Generator().manual_seed(0),
                                torch.Generator().manual_seed(1))
    assert torch.equal(err, err2) and torch.equal(done, done2)
    assert err.shape == (12,) and bool(torch.isfinite(err).all())


# --- on the card --------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph and a CUDA kernel have no CPU mode")
    return torch.device("cuda")


Nc, Hc = 1024, 8
CARD_CASES = [("covo_online", "kernel", "call"), ("covo_online", "fast", "call"),
              ("covo_speculative", "kernel", "act"), ("covo_speculative", "kernel", "prepare"),
              ("covo_offline", "kernel", "call"), ("mppi", "kernel", "call"),
              ("mppi", "fast", "call"), ("pid", "fast", "call"), ("random", "fast", "call")]


def _card_env(dev):
    return QuadEnv(EnvConfig(**ENV_KW), device=dev)


def _tensors(method, out):
    action, cp = (None, out) if method == "prepare" else out[:2]
    named = {} if action is None else {"action": action}
    if cp is not None:
        named.update({f.name: getattr(cp, f.name) for f in dataclasses.fields(cp)
                      if isinstance(getattr(cp, f.name), torch.Tensor)})
    return named


@pytest.mark.cuda
@pytest.mark.parametrize("name,rng_mode,method", CARD_CASES)
def test_captured_solve_matches_eager(dev, name, rng_mode, method):
    """Five chained replays equal five chained eager solves from the same
    seed and params within 2e-4 on every output; two replays on the same
    inputs draw afresh (all but PID and prepare, which draw nothing under
    the gaussian model); the replays launch what the eager solves launch."""
    from covo_mpc_tpu_torch.ops import covariance_cuda, hessian_cuda

    env = _card_env(dev)
    p = env.default_params
    obs, info, state = env.reset(torch.Generator(dev).manual_seed(5), p)
    solver, cp0 = get_solver(env, name, f"N{Nc}_H{Hc}_lam0.01", rng_mode=rng_mode,
                             sigma_mode="ns_pallas" if "spec" in name else "ns",
                             hessian_mode="gn", collect_debug=False)
    cp0 = solver.reset(state, p, cp0)
    if method == "prepare":
        fn, args = solver.prepare, lambda cp: (state, p, cp, info)
    else:
        fn = solver.act if method == "act" else solver
        args = lambda cp: (obs, state, p, cp, info)  # noqa: E731

    def carry(out):
        return out if method == "prepare" else out[1]

    kernel_list = [rollout_cuda.JOINT_KERNEL, rollout_cuda.PRIMAL_KERNEL,
                   rollout_cuda.ROLLOUT_KERNEL, rollout_cuda.SAMPLE_KERNEL,
                   hessian_cuda.CHAIN_KERNEL, covariance_cuda.SIGMA_KERNEL]

    def chain(f):
        solver.seed(3)
        for k in kernel_list:
            k.launches = 0
        cp, outs = cp0, []
        for _ in range(5):
            out = f(*args(cp))
            outs.append(_tensors(method, out))
            cp = carry(out)
        return outs, [k.launches for k in kernel_list]

    eager, eager_counts = chain(fn)
    solver.seed(3)
    cap = graphs.capture_solver(fn, solver, *args(cp0))
    replayed, replay_counts = chain(cap)
    for e, r in zip(eager, replayed):
        for key in e:
            torch.testing.assert_close(r[key], e[key], atol=2e-4, rtol=0)
    assert replay_counts == eager_counts
    first, second = _tensors(method, cap(*args(cp0))), _tensors(method, cap(*args(cp0)))
    key = next(iter(first))  # the action (a_mean for prepare)
    if name == "pid" or method == "prepare":
        assert torch.equal(first[key], second[key])
    else:
        assert not torch.equal(first[key], second[key])


@pytest.mark.cuda
@pytest.mark.parametrize("name,rng_mode", [("covo_online", "kernel"), ("mppi", "kernel"),
                                           ("covo_speculative", "kernel")])
def test_captured_episode_matches_eager_first_steps(dev, name, rng_mode):
    """The captured runner's first 10 steps of err_pos equal the eager
    loop's on the same generators and seed within 2e-4 (later steps part by
    chaos, BASELINE.md); the whole captured episode stays finite."""
    env = _card_env(dev)
    solver, _ = get_solver(env, name, f"N{Nc}_H{Hc}_lam0.01", rng_mode=rng_mode,
                           sigma_mode="ns_pallas" if "spec" in name else "ns",
                           hessian_mode="gn", collect_debug=False)
    T = 30
    solver.seed(1)
    ref, _, _ = eager_episode(env, solver, T, torch.Generator(dev).manual_seed(0),
                           torch.Generator(dev).manual_seed(1))
    run = make_episode_runner(env, solver, steps=T)
    assert isinstance(run, CapturedEpisode)
    solver.seed(1)
    err, dones, _ = run(torch.Generator(dev).manual_seed(0), torch.Generator(dev).manual_seed(1))
    torch.testing.assert_close(err[:10], ref[:10], atol=2e-4, rtol=0)
    assert bool(torch.isfinite(err).all()) and dones.shape == (T,)


def philox_normals_np(key: int, counters: np.ndarray) -> np.ndarray:
    """Four normals per counter (C, 4) uint32: Philox4x32-10 keyed by
    ``key`` (csrc/philox.cuh), then Box-Muller on its words, in float64."""
    M0, M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    W0, W1 = np.uint32(0x9E3779B9), np.uint32(0xBB67AE85)
    c = [counters[:, i].astype(np.uint32) for i in range(4)]
    k0, k1 = np.uint32(key & 0xFFFFFFFF), np.uint32(key >> 32)
    with np.errstate(over="ignore"):
        for r in range(10):
            if r:
                k0, k1 = k0 + W0, k1 + W1
            p0 = M0 * c[0].astype(np.uint64)
            p1 = M1 * c[2].astype(np.uint64)
            hi0, lo0 = (p0 >> np.uint64(32)).astype(np.uint32), p0.astype(np.uint32)
            hi1, lo1 = (p1 >> np.uint64(32)).astype(np.uint32), p1.astype(np.uint32)
            c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]

    def box_muller(a, b):
        u1 = ((a >> 8).astype(np.float64) + 1.0) / 16777216.0
        u2 = (b >> 8).astype(np.float64) / 16777216.0
        r = np.sqrt(-2.0 * np.log(u1))
        return r * np.cos(2 * np.pi * u2), r * np.sin(2 * np.pi * u2)

    (x, y), (z, w) = box_muller(c[0], c[1]), box_muller(c[2], c[3])
    return np.stack([x, y, z, w], axis=1)


@pytest.mark.cuda
def test_kernels_draw_philox_keyed_by_the_device_word(dev):
    """K1 and K5 with zero mean and identity factors write clip(z): their
    draws keyed by a seed stream's device word equal a numpy Philox4x32-10
    keyed by that word's value (4e-5, the card's logf / sincosf), at a key
    past 2^63 too; K5's krng draw likewise."""
    env = _card_env(dev)
    p = env.default_params
    _, info, _ = env.reset(torch.Generator(dev).manual_seed(2), p)
    st = info["noisy_state"]
    roll = (pack_state(st), st.time, st.pos_traj, st.vel_traj)
    Hs, Ns = 8, 256
    stream = sampling.SeedStream(dev, 2**64 - 9)
    key_dev = stream.next(2)
    k1_key, k5_key = (rollout_cuda.seed_value(k) for k in key_dev.cpu())
    _, a1 = rollout_cuda.make_rollout_joint_sampling(env)(
        *roll, torch.zeros(Hs, 4, device=dev), torch.eye(4 * Hs, device=dev), p,
        key_dev[0], Ns, deterministic=True)
    j, n = np.meshgrid(np.arange(Hs), np.arange(Ns), indexing="ij")
    ctr = np.stack([j.ravel(), n.ravel(), 0 * j.ravel(), 0 * j.ravel()], axis=1)
    ref = philox_normals_np(k1_key, ctr).reshape(Hs, Ns, 4).transpose(0, 2, 1)
    np.testing.assert_allclose(a1.cpu().numpy().reshape(Hs, 4, Ns), np.clip(ref, -1, 1),
                               atol=4e-5, rtol=0)
    chol = torch.eye(4, device=dev).expand(Hs, 4, 4).contiguous()
    draw_out = torch.zeros(3, device=dev)
    _, a5 = rollout_cuda.make_rollout_sampling(env)(
        *roll, torch.zeros(Hs, 4, device=dev), chol, p, key_dev[1], Ns,
        disturb_seed=key_dev[0], draw_out=draw_out)
    ref5 = philox_normals_np(k5_key, ctr).reshape(Hs, Ns, 4).transpose(0, 2, 1)
    np.testing.assert_allclose(a5.cpu().numpy().reshape(Hs, 4, Ns), np.clip(ref5, -1, 1),
                               atol=4e-5, rtol=0)
    krng = philox_normals_np(k1_key, np.array([[0, 0, 1, 0]]))[0, :3]
    np.testing.assert_allclose(draw_out.cpu().numpy(), krng, atol=4e-5, rtol=0)


@pytest.mark.cuda
def test_captured_call_inputs_and_outputs(dev):
    """A call copies in what changed (an input modified in place, any input
    of a buffer the graph writes, even the same unchanged tensor) and skips
    nothing else; its outputs are fresh (a later call leaves them as they
    were); other shapes raise."""
    x = torch.ones(4, device=dev)
    acc = torch.zeros(4, device=dev)

    def fn(x, acc):
        acc.add_(x)  # the graph writes this buffer
        return x * 2, acc.clone()

    cap = graphs.capture(fn, x, acc)
    z = torch.zeros(4, device=dev)
    y1, a1 = cap(x, z)
    _, a2 = cap(x, z)  # z unchanged, but its buffer was written: copied again
    assert torch.equal(y1, 2 * x) and torch.equal(a1, x) and torch.equal(a2, x)
    x.mul_(3)  # changed in place: copied again
    y3, _ = cap(x, z)
    assert torch.equal(y3, torch.full((4,), 6.0, device=dev))
    assert torch.equal(y1, torch.full((4,), 2.0, device=dev))  # fresh outputs
    with pytest.raises(ValueError):
        cap(torch.ones(5, device=dev), z)


@pytest.mark.cuda
def test_env_step_and_pid_never_sync(dev):
    """The auto-resetting env step (its reset's unit quaternion) and the
    PID solve (its e_z) make their constants with device fills: with host
    syncs turned into errors, both run (an item assignment of a host scalar
    synced, and could not be captured)."""
    env = _card_env(dev)
    p = env.default_params
    obs, info, state = env.reset(torch.Generator(dev).manual_seed(0), p)
    solver, cp = get_solver(env, "pid")
    gen = torch.Generator(dev).manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        action, cp, _ = solver(obs, state, p, cp, info)
        env.step(gen, state, action, p)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_a_capture_that_fails_raises(dev):
    """A callable that reads a device value on the host cannot be captured:
    the capture raises, and nothing is left capturing."""
    x = torch.ones(4, device=dev)

    def reads_host(t):
        return t * float(t.sum())

    with pytest.raises(RuntimeError):
        graphs.capture(reads_host, x)
    assert not torch.cuda.is_current_stream_capturing()
    assert float((x * 2).sum()) == 8.0


# --- the harness on the card: metrics, the command line, render -------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["covo_online", "mppi"])
def test_captured_episode_metrics_equal_eager(dev, name):
    """Over 300 steps, a captured episode's solve metrics (each scalar
    written by the graph, Sigma's eigensolved after the replays) equal the
    eager episode's bit for bit, as do its errors."""
    env = _card_env(dev)
    solver, _ = get_solver(env, name, f"N{Nc}_H{Hc}_lam0.01", rng_mode="kernel",
                           hessian_mode="gn",
                           sigma_mode="ns", collect_metrics=True, collect_debug=False)
    solver.seed(1)
    err_e, _, m_e = eager_episode(env, solver, 300, torch.Generator(dev).manual_seed(0),
                                  torch.Generator(dev).manual_seed(1))
    solver.seed(1)
    run = make_episode_runner(env, solver, steps=300)
    assert isinstance(run, CapturedEpisode)
    err_c, _, m_c = run(torch.Generator(dev).manual_seed(0),
                        torch.Generator(dev).manual_seed(1))
    assert set(m_c) == set(m_e) and "ess" in m_c
    assert ("sigma_cond" in m_c) == (name != "mppi")
    assert torch.equal(err_c, err_e)
    for k in m_e:
        assert m_c[k].shape == (300,) and torch.equal(m_c[k], m_e[k]), k


@pytest.mark.cuda
def test_cli_eval_launches_the_main_path_kernels_once_a_step(dev, tmp_path):
    """The command line's eval on the main path's settings (kernel rng, gn,
    ns, cuda) launches K1, K2 and K3 once a step: 300 replays and the
    capture's two warm-up calls."""
    from covo_mpc_tpu_torch import cli
    from covo_mpc_tpu_torch.ops import hessian_cuda, kernels

    ks = (rollout_cuda.JOINT_KERNEL, rollout_cuda.PRIMAL_KERNEL, hessian_cuda.CHAIN_KERNEL)
    kernels.library()
    for k in ks:
        k.launches = 0
    rc = cli.main(["--task", "tracking_zigzag", "--controller", "covo_online",
                   "--controller-params", f"N{Nc}_H{Hc}_lam0.01", "--mode", "eval",
                   "--noDR", "--rng-mode", "kernel", "--hessian-mode", "gn",
                   "--sigma-mode", "ns", "--engine", "cuda", "--total-steps", "300",
                   "--results-dir", str(tmp_path)])
    assert rc == 0
    assert [k.launches for k in ks] == [302] * 3


@pytest.mark.cuda
def test_captured_render_equals_eager(dev):
    """A captured recording equals the eager one (debug mode) bit for bit,
    with and without reset_on_done (320 steps: the episode's time limit
    ends it at step 300, inside the recording; domain randomization on,
    so the redraw changes the params)."""
    from covo_mpc_tpu_torch.runtime import debug, render

    env = QuadEnv(EnvConfig(**{**ENV_KW, "enable_randomizer": True}), device=dev)
    solver, _ = get_solver(env, "mppi", f"N{Nc}_H{Hc}_lam0.01", rng_mode="kernel",
                           collect_debug=False)
    for reset in (False, True):
        kw = dict(seed=1, steps=320, reset_on_done=reset)
        got = render.render_episode(env, solver, **kw)
        with debug.debug_mode(nans=False):
            ref = render.render_episode(env, solver, **kw)
        assert set(got) == set(ref) and got["done"][300]
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{k} reset={reset}")


# --- the batched protocol on the card: captured solves and episodes, K7's offset ----

Bc = 4


def _batched_inputs(env, B=Bc):
    """B episodes' solve inputs from the batched env's reset (their noisy
    states), one shared env_params expanded as the batched solves take it."""
    from covo_mpc_tpu_torch.models.batched import BatchedEnv
    from covo_mpc_tpu_torch.models.structs import expand_params
    from covo_mpc_tpu_torch.parallel.scenarios import _solve_inputs

    gens = [torch.Generator(env.device).manual_seed(10 + b) for b in range(B)]
    _, info, state = BatchedEnv(env).reset(gens, env.default_params)
    return _solve_inputs(state, info), expand_params(env.default_params, B)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,rng", [("covo", "kernel"), ("mppi", "kernel"), ("mppi", "fast")])
def test_captured_batched_solve_matches_eager(dev, kind, rng):
    """A batched solve (B=4) captured as a CUDA graph: five chained replays
    equal five chained eager solves from the same seed bit for bit, and
    launch what they launch; two replays on the same inputs draw afresh."""
    from covo_mpc_tpu_torch.parallel import make_batched_covo_solve, make_batched_mppi_solve
    from covo_mpc_tpu_torch.solvers.factory import hover_sequence

    env = _card_env(dev)
    args, pb = _batched_inputs(env)
    means = hover_sequence(env, Hc).expand(Bc, Hc, 4).contiguous()
    if kind == "covo":
        solve = make_batched_covo_solve(env, Nc, Hc, 0.01, rng=rng, hessian_mode="gn")
        carry0 = (means,)
    else:
        solve = make_batched_mppi_solve(env, Nc, Hc, 0.01, rng=rng)
        carry0 = (means, (0.25 * torch.eye(4, device=dev)).expand(Bc, Hc, 4, 4).contiguous())
    ks = [rollout_cuda.JOINT_BATCHED_KERNEL, rollout_cuda.SAMPLE_BATCHED_KERNEL,
          rollout_cuda.ROLLOUT_BATCHED_KERNEL]

    def chain(f):
        solve.seed(3)
        for k in ks:
            k.launches = 0
        carry, outs = carry0, []
        for _ in range(5):
            out = f(*args, *carry, pb)
            outs.append(out)
            carry = out[:len(carry0)]
        return outs, [k.launches for k in ks]

    eager, eager_counts = chain(solve)
    cap = graphs.capture_solver(solve, solve, *args, *carry0, pb)
    replayed, replay_counts = chain(cap)
    for e, r in zip(eager, replayed):
        assert all(torch.equal(x, y) for x, y in zip(e, r))
    assert replay_counts == eager_counts and sum(eager_counts) == 5
    first, second = cap(*args, *carry0, pb), cap(*args, *carry0, pb)
    assert not torch.equal(first[0], second[0])


@pytest.mark.cuda
@pytest.mark.parametrize("name,rng_mode", [("covo_online", "kernel"), ("mppi", "kernel"),
                                           ("mppi", "fast"), ("pid", "fast")])
def test_captured_batched_episode_matches_eager(dev, name, rng_mode):
    """The batched runner's captured control step (B=4 episodes, 50 steps)
    gives the eager batched loop's errors and dones bit for bit, and again
    for a second chunk [4, 8), which reuses the capture with K7 offset 4."""
    from covo_mpc_tpu_torch.runtime import debug, make_batched_episode_runner

    env = _card_env(dev)
    solver, _ = get_solver(env, name, f"N{Nc}_H{Hc}_lam0.01", rng_mode=rng_mode,
                           hessian_mode="gn", sigma_mode="ns", collect_debug=False)
    run = make_batched_episode_runner(env, solver, steps=50)
    for lo in (0, Bc):
        err_c, done_c = run(7, lo, lo + Bc)
        with debug.debug_mode(nans=False):
            err_e, done_e = run(7, lo, lo + Bc)
        assert err_c.shape == (Bc, 50) and bool(torch.isfinite(err_c).all())
        assert torch.equal(err_c, err_e) and torch.equal(done_c, done_e)
    assert len(run.captured) == 1


@pytest.mark.cuda
def test_replayed_batched_step_never_syncs(dev):
    """Once captured, a chunk of the batched protocol (the eager reset, the
    loads, 20 replays of the batched MPPI step, the fresh outputs) runs with
    host syncs turned into errors."""
    from covo_mpc_tpu_torch.runtime import make_batched_episode_runner

    env = _card_env(dev)
    solver, _ = get_solver(env, "mppi", f"N{Nc}_H{Hc}_lam0.01", rng_mode="kernel",
                           collect_debug=False)
    run = make_batched_episode_runner(env, solver, steps=20)
    first, _ = run(3, 0, Bc)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again, _ = run(3, 0, Bc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("joint", [False, True], ids=["per_step", "joint"])
def test_k7_offset_on_the_card(dev, joint):
    """K7's episode offset, a device word: scenario b at offset o draws what
    scenario o + b draws at offset 0, bit for bit (actions and costs), for
    both K7 kernels at the main path's H and N; an offset word of 0 is no
    offset."""
    env = _card_env(dev)
    Hm, Nm = 32, 8192
    args, pb = _batched_inputs(env)
    g = torch.Generator(dev).manual_seed(2)
    means = torch.randn(Bc, Hm, 4, generator=g, device=dev) * 0.2
    if joint:
        fac = torch.randn(Bc, 4 * Hm, 4 * Hm, generator=g, device=dev) * 0.05
    else:
        A = torch.randn(Bc, Hm, 4, 4, generator=g, device=dev) * 0.2
        fac = torch.linalg.cholesky(A @ A.mT + 0.05 * torch.eye(4, device=dev)).contiguous()
    k7 = rollout_cuda.make_rollout_batched_sampling(env, joint=joint)
    c4, a4 = k7(*args, means, fac, pb, 9, Nm, deterministic=True)
    c0, a0 = k7(*args, means, fac, pb, 9, Nm, deterministic=True,
                offset=torch.zeros((), dtype=torch.int32, device=dev))
    assert torch.equal(a0, a4) and torch.equal(c0, c4)
    word = torch.full((), 2, dtype=torch.int32, device=dev)
    c2, a2 = k7(*(x[2:] for x in args), means[2:], fac[2:],
                pb.replace(**{k: v[2:] for k, v in float_leaves(pb).items()}), 9, Nm,
                deterministic=True, offset=word)
    assert torch.equal(a2, a4[2:]) and torch.equal(c2, c4[2:])
    assert not torch.equal(a2[0], a4[0])



# --- captured solves below one block of samples ---------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["covo_online", "mppi"])
def test_captured_solve_below_one_block_equals_eager(dev, name):
    """The N-ablation's smallest cell, N=16 at H=32 (below one block of K1
    and K5): CoVO online (gn, ns, kernel rng: K1, K2, K3) and MPPI (kernel
    rng: K5) captured as CUDA graphs; five chained replays equal five
    chained eager solves from the same seed bit for bit, launch what they
    launch, and stay finite."""
    from covo_mpc_tpu_torch.ops import hessian_cuda

    env = _card_env(dev)
    p = env.default_params
    obs, info, state = env.reset(torch.Generator(dev).manual_seed(5), p)
    solver, cp0 = get_solver(env, name, "N16_H32_lam0.01", rng_mode="kernel",
                             hessian_mode="gn", sigma_mode="ns", engine="cuda", collect_debug=False)
    cp0 = solver.reset(state, p, cp0)
    kernel_list = ([rollout_cuda.JOINT_KERNEL, rollout_cuda.PRIMAL_KERNEL,
                    hessian_cuda.CHAIN_KERNEL] if name == "covo_online"
                   else [rollout_cuda.SAMPLE_KERNEL])

    def chain(f):
        solver.seed(3)
        for k in kernel_list:
            k.launches = 0
        cp, outs = cp0, []
        for _ in range(5):
            out = f(obs, state, p, cp, info)
            outs.append(_tensors("call", out))
            cp = out[1]
        return outs, [k.launches for k in kernel_list]

    eager, eager_counts = chain(solver)
    solver.seed(3)
    cap = graphs.capture_solver(solver, solver, obs, state, p, cp0, info)
    replayed, replay_counts = chain(cap)
    for e, r in zip(eager, replayed):
        assert r.keys() == e.keys()
        for key in e:
            assert torch.equal(r[key], e[key]), key
            assert bool(torch.isfinite(r[key]).all()), key
    assert replay_counts == eager_counts and all(c == 5 for c in eager_counts)
    assert eager[0]["a_mean"].shape == (32, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fwd_fwd", "sensitivity"])
def test_graphed_reference_hessian_equals_eager(dev, mode):
    """runtime/graphs.Graphed on a reference Hessian (H=8): its replays on
    two inputs equal eager calls bit for bit, and a CPU call runs eagerly."""
    from covo_mpc_tpu_torch.ops import covariance
    from covo_mpc_tpu_torch.ops.hessian import make_hessian_sensitivity
    from covo_mpc_tpu_torch.ops.rollout import make_hessian_cost
    from covo_mpc_tpu_torch.runtime.graphs import Graphed

    env = _card_env(dev)
    p = env.default_params
    hess = (make_hessian_sensitivity(env, Hc) if mode == "sensitivity" else
            covariance.make_hessian(make_hessian_cost(env, Hc), mode))
    graphed = Graphed(hess)
    g = torch.Generator(dev).manual_seed(3)
    for seed in (0, 1):
        _, info, _ = env.reset(torch.Generator(dev).manual_seed(seed), p)
        st = info["noisy_state"]
        a = torch.randn(4 * Hc, generator=g, device=dev) * 0.3
        args = (a, pack_state(st), st.time, st.pos_traj, st.vel_traj, p, None)
        assert torch.equal(graphed(*args), hess(*args))
    assert len(graphed._captured) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name,rng_mode", [("mppi", "parity"), ("covo_online", "invariant")])
def test_captured_key_schedule_episode_equals_eager(dev, name, rng_mode):
    """JAX's key schedule captured (the key a device buffer of the carry):
    30 steps' err_pos equal the eager loop's on the same keys (10 steps
    within 2e-4, chaos after), and both write the same last key back."""
    from covo_mpc_tpu_torch.utils import prng

    env = _card_env(dev)
    solver, _ = get_solver(env, name, f"N{Nc}_H{Hc}_lam0.01", rng_mode=rng_mode,
                           hessian_mode="gn", sigma_mode="ns", collect_debug=False)
    assert solver.draws_from_keys and solver.capturable
    T = 30
    k_eager, k_cap = prng.PRNGKey(1, dev), prng.PRNGKey(1, dev)
    ref, _, _ = eager_episode(env, solver, T, prng.PRNGKey(100, dev), k_eager)
    run = make_episode_runner(env, solver, steps=T)
    assert isinstance(run, CapturedEpisode)
    err, _, _ = run(prng.PRNGKey(100, dev), k_cap)
    torch.testing.assert_close(err[:10], ref[:10], atol=2e-4, rtol=0)
    assert torch.equal(k_cap, k_eager)
