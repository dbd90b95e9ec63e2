"""The CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA GPU and
``nvcc``; without them each skips. On a machine with a card:
``python -m pytest tests/test_torch_cuda.py -q``. ``chip_smoke.py`` checks
the kernels at the main path's shapes; these tests take the shapes it does
not: a ragged sample count (N not a multiple of the block), a short
horizon, both action layouts of K4, K5's in-kernel disturbance draw and
the moments of its Philox draws, the 16-dim sensitivity state of K3, the
exact-adjoint Hessian through K2 and K3, and the scenario-batched K6 and
K7 at a ragged N, at B=1 against K4, K5 and K1, with in-kernel draws that
do not depend on the scenario count (also at the main path's D=128), K7
joint's per-scenario moments and its repeatability at B=16, N=8192, H=32,
K1 at D = 32, 36 and 128, and the joint kernel's refusal of a block or a
width it does not take; K5 / K7 per-step bit for bit at every block size
it takes, in every mode and with its in-kernel disturbance draw, its
repeatability at B=16, N=8192, H=32, and its refusal of a block or an
actions pointer it does not take;
the Sigma-designer K8 at D = 32, 64, 100 (ragged cluster slabs) and 128
on a near-singular and on a badly scaled R, and its repeatability; every
disturbance mode (table, drag, mixed) of K1, K4-K7 at a
ragged N, K6/K7 at B=1 against B=16, and the Hessian through K2 (on a force
table) and K3 (at sd=16) in each mode; and the realworld reward of
tracking_slow in K1, K4-K7 the same way, in every disturbance mode; K3
at H = 8, 13 (a ragged last block) and 32, its repeatability and its exact
zero prefix, K2 on a sin table at H = 8, 13 and 32, and both bit for bit
against the designs they replaced (``covo_mpc_tpu_torch/tools/earlier``),
also on every input of one closed-loop episode of the main path; K4 and K6
repeatable over 10 launches and bit for bit equal to the kernel they
replaced in every mode and reward (K6 at B=1 also to K4), and K4 against
its plain version with rollover termination on, where samples terminate
mid-horizon; JAX's key tree (``utils/prng.py``) on the card equal to the
CPU's, and K4 fed the parity and invariant samplers' draws at N = 16 and
8192.
Tolerances are the ones ``chip_smoke.py`` states (the JAX kernel tests'
own).
"""

import math

import numpy as np
import pytest
import torch

from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv, pack_state
from covo_mpc_tpu_torch.models.structs import index_params, stack_params
from covo_mpc_tpu_torch.ops import hessian_cuda, kernels, rollout_cuda
from covo_mpc_tpu_torch.ops.hessian import make_hessian_adjoint
from covo_mpc_tpu_torch.tools import rollout_variants
from covo_mpc_tpu_torch.tools.joint_rollout_variants import CASES
from covo_mpc_tpu_torch.tools.primal_chain_variants import (
    build_earlier,
    chain_j,
    launcher,
    loop_bits,
    primal_operands,
)

N, H = 1000, 8  # N ragged for blocks of 64 and 128
D = 4 * H

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _env_state(dev):
    env = QuadEnv(EnvConfig(task="tracking_zigzag", enable_randomizer=False,
                            disturb_type="gaussian",
                            disable_rollover_terminate=True,
                            generate_noisy_state=True), device=dev)
    _, info, _ = env.reset(torch.Generator(dev).manual_seed(0))
    return env, env.default_params, info["noisy_state"]


@pytest.mark.parametrize("Hs", [8, 9, 32])
def test_joint_sample_rollout_matches_plain(dev, Hs):
    """K1 against its plain version at D = 32, 36 (rows a correlate tile of
    8 does not divide) and 128 (the main path's width), ragged N; blocks of
    64 and 128 samples agree bit for bit."""
    env, p, st = _env_state(dev)
    g = torch.Generator(dev).manual_seed(1)
    a_mean = torch.randn(Hs, 4, generator=g, device=dev) * 0.2
    factor = torch.randn(4 * Hs, 4 * Hs, generator=g, device=dev) * 0.1
    z = torch.randn(4 * Hs, N, generator=g, device=dev)
    args = (pack_state(st), st.time, st.pos_traj, st.vel_traj, a_mean, factor,
            p, 0, N)
    k1 = rollout_cuda.make_rollout_joint_sampling(env, block=128)
    c_k, a_k = k1(*args, deterministic=True, discount=0.98, z=z)
    c_p, a_p = k1.plain(*args, deterministic=True, discount=0.98, z=z)
    torch.testing.assert_close(a_k, a_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(c_k, c_p, atol=2e-4, rtol=1e-5)
    c_64, a_64 = rollout_cuda.make_rollout_joint_sampling(env, block=64)(
        *args, deterministic=True, discount=0.98, z=z)
    assert torch.equal(c_64, c_k) and torch.equal(a_64, a_k)
    # a stochastic gaussian rollout: the shared draw from step 1 on
    draw = torch.randn(3, generator=g, device=dev)
    c_k, _ = k1(*args, discount=0.98, draw=draw, z=z)
    c_p, _ = k1.plain(*args, discount=0.98, draw=draw, z=z)
    torch.testing.assert_close(c_k, c_p, atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize("layout", ["nhd", "hdn"])
def test_rollout_costs_matches_plain(dev, layout):
    env, p, st = _env_state(dev)
    g = torch.Generator(dev).manual_seed(5)
    shape = (N, H, 4) if layout == "nhd" else (H, 4, N)
    actions = torch.randn(*shape, generator=g, device=dev) * 0.5
    draw = torch.randn(3, generator=g, device=dev)
    args = (pack_state(st), st.time, st.pos_traj, st.vel_traj, actions, p)
    k4 = rollout_cuda.make_rollout_costs(env, block=128)
    for kw in (dict(deterministic=True), dict(draw=draw)):
        c_k = k4(*args, discount=0.98, layout=layout, **kw)
        c_p = k4.plain(*args, discount=0.98, layout=layout, **kw)
        torch.testing.assert_close(c_k, c_p, atol=2e-4, rtol=1e-5)
        c_64 = rollout_cuda.make_rollout_costs(env, block=64)(
            *args, discount=0.98, layout=layout, **kw)
        assert torch.equal(c_64, c_k)


def _per_step_inputs(dev, seed=6):
    g = torch.Generator(dev).manual_seed(seed)
    a_mean = torch.randn(H, 4, generator=g, device=dev) * 0.2
    A = torch.randn(H, 4, 4, generator=g, device=dev) * 0.2
    cov = A @ A.transpose(1, 2) + 0.05 * torch.eye(4, device=dev)
    return g, a_mean, torch.linalg.cholesky(cov).contiguous()


def test_sample_rollout_matches_plain(dev):
    env, p, st = _env_state(dev)
    g, a_mean, chol = _per_step_inputs(dev)
    z = torch.randn(H, 4, N, generator=g, device=dev)
    draw = torch.randn(3, generator=g, device=dev)
    args = (pack_state(st), st.time, st.pos_traj, st.vel_traj, a_mean, chol, p,
            0, N)
    k5 = rollout_cuda.make_rollout_sampling(env, block=128)
    for kw in (dict(deterministic=True), dict(draw=draw)):
        c_k, a_k = k5(*args, discount=0.98, z=z, **kw)
        c_p, a_p = k5.plain(*args, discount=0.98, z=z, **kw)
        torch.testing.assert_close(a_k, a_p, atol=1e-5, rtol=0)
        torch.testing.assert_close(c_k, c_p, atol=2e-4, rtol=1e-5)
    # in-kernel draws: the same for blocks of 64 and 128
    c_k, a_k = k5(*args[:7], 11, N, disturb_seed=12)
    c_64, a_64 = rollout_cuda.make_rollout_sampling(env, block=64)(
        *args[:7], 11, N, disturb_seed=12)
    assert torch.equal(c_64, c_k) and torch.equal(a_64, a_k)


def test_sample_rollout_krng_draw_feeds_plain(dev):
    """"krng": the kernel draws the shared disturbance itself; fed the
    normals it wrote to draw_out, the plain rollout gives the same costs on
    the kernel's own actions."""
    env, p, st = _env_state(dev)
    _, a_mean, chol = _per_step_inputs(dev)
    k5 = rollout_cuda.make_rollout_sampling(env)
    args = (pack_state(st), st.time, st.pos_traj, st.vel_traj, a_mean, chol, p,
            21, N)
    draw_out = torch.zeros(3, device=dev)
    c_k, a_k = k5(*args, discount=0.98, disturb_seed=22, draw_out=draw_out)
    ref = k5._rollout(pack_state(st), st.time, st.pos_traj, st.vel_traj, a_k, p,
                      draw_out.clone(), discount=0.98, layout="hdn")
    torch.testing.assert_close(c_k, ref, atol=2e-4, rtol=1e-5)
    assert float(draw_out.abs().sum()) > 0.0
    # the draw is shared: another disturb seed moves every cost
    c_k2, a_k2 = k5(*args, discount=0.98, disturb_seed=23)
    assert torch.equal(a_k2, a_k) and not torch.equal(c_k2, c_k)


def test_sample_rollout_philox_moments(dev):
    """K5's per-step draws at the main path's size (N=8192, H=32): mean 0,
    L = 0.1 I, so each action dimension is N(0, 0.01)."""
    env, p, st = _env_state(dev)
    Nm, Hm = 8192, 32
    k5 = rollout_cuda.make_rollout_sampling(env)
    zero = torch.zeros(Hm, 4, device=dev)
    eye = (0.1 * torch.eye(4, device=dev)).expand(Hm, 4, 4).contiguous()
    args = (pack_state(st), st.time, st.pos_traj, st.vel_traj, zero, eye, p)
    _, a1 = k5(*args, 1234, Nm, deterministic=True)
    _, a1b = k5(*args, 1234, Nm, deterministic=True)
    _, a2 = k5(*args, 1235, Nm, deterministic=True)
    mean_d = a1.mean(dim=1)
    var_d = a1.var(dim=1, correction=0)
    pooled = float(a1.pow(2).mean() - a1.mean().pow(2))
    assert float(mean_d.abs().max()) <= 5e-3
    assert float((var_d / 0.01 - 1).abs().max()) <= 0.10
    assert abs(pooled / 0.01 - 1) <= 0.01
    assert torch.equal(a1, a1b) and not torch.equal(a1, a2)


def test_sample_rollout_krng_draw_moments(dev):
    """The in-kernel shared disturbance draw over 2000 disturb seeds: 6000
    standard normals (limits about 4.5 standard errors)."""
    env, p, st = _env_state(dev)
    _, a_mean, chol = _per_step_inputs(dev)
    k5 = rollout_cuda.make_rollout_sampling(env)
    args = (pack_state(st), st.time, st.pos_traj, st.vel_traj, a_mean, chol, p,
            0, 32)
    draws = torch.zeros(2000, 3, device=dev)
    for i in range(2000):
        k5(*args, disturb_seed=i, draw_out=draws[i])
    assert float(draws.mean().abs()) <= 0.06
    assert float((draws.var(correction=0) - 1).abs()) <= 0.08
    assert float(draws.mean(dim=0).abs().max()) <= 0.1
    assert len({tuple(d) for d in draws.tolist()}) == 2000


def test_primal_matches_plain(dev):
    env, p, st = _env_state(dev)
    g = torch.Generator(dev).manual_seed(2)
    a_seq = torch.rand(H, 4, generator=g, device=dev) * 2.6 - 1.3  # raw
    dist = torch.randn(H, 3, generator=g, device=dev) * 0.05
    k2 = rollout_cuda.make_primal(env, H)
    x0 = pack_state(st)
    torch.testing.assert_close(k2(x0, a_seq, dist, p), k2.plain(x0, a_seq, dist, p),
                               atol=1e-5, rtol=0)


def _rel(got, ref) -> float:
    return float(torch.linalg.norm((got - ref).double())
                 / torch.linalg.norm(ref.double()))


@pytest.mark.parametrize("sd", [13, 16])
def test_sens_chain_matches_plain(dev, sd):
    g = torch.Generator(dev).manual_seed(3)
    J = torch.randn(H, sd, sd + 4, generator=g, device=dev) * 0.5
    M = torch.randn(H, sd + 4, sd + 4, generator=g, device=dev)
    M = (M + M.transpose(1, 2)) / 2
    T_k = hessian_cuda.sens_chain(J, 4)
    T_p = hessian_cuda.sens_chain_plain(J, 4)
    assert _rel(T_k, T_p) < 1e-5
    assert _rel(hessian_cuda.pullback(T_k, M), hessian_cuda.pullback(T_p, M)) < 1e-5


@pytest.mark.parametrize("sd", [13, 16])
@pytest.mark.parametrize("Hs", [8, 13, 32])
def test_sens_chain_matches_plain_at_horizons(dev, sd, Hs):
    """K3's blocks of 8 columns over D = 4H: H = 13 leaves a ragged last
    block; T and the pullback within the relative 1e-5 of the plain chain."""
    J = chain_j(sd, Hs, dev)
    M = torch.randn(Hs, sd + 4, sd + 4, generator=torch.Generator(dev).manual_seed(4),
                    device=dev)
    M = (M + M.transpose(1, 2)) / 2
    T_k = hessian_cuda.sens_chain(J, 4)
    T_p = hessian_cuda.sens_chain_plain(J, 4)
    assert _rel(T_k, T_p) < 1e-5
    assert _rel(hessian_cuda.pullback(T_k, M), hessian_cuda.pullback(T_p, M)) < 1e-5


@pytest.mark.parametrize("sd", [13, 16])
def test_sens_chain_repeats_bit_for_bit(dev, sd):
    J = chain_j(sd, 32, dev)
    T0 = hessian_cuda.sens_chain(J, 4)
    for _ in range(10):
        assert torch.equal(hessian_cuda.sens_chain(J, 4), T0)


@pytest.mark.parametrize("Hs", [13, 32])
def test_sens_chain_zero_prefix_is_exact(dev, Hs):
    """Column x of T is exactly 0 in its S1 rows at h <= x // 4 (the steps
    K3's blocks skip) and its E rows are exactly the identity pattern."""
    sd = 13
    T = hessian_cuda.sens_chain(chain_j(sd, Hs, dev), 4)
    h = torch.arange(Hs, device=dev)[:, None]
    x = torch.arange(4 * Hs, device=dev)[None, :]
    prefix = h <= x // 4  # (H, D)
    assert bool((T[:, :sd, :].abs().amax(1)[prefix] == 0).all())
    assert bool((T[:, :sd, :].abs().amax(1)[~prefix] > 0).all())
    E = (x[None] == 4 * h[:, :, None] + torch.arange(4, device=dev)[None, :, None]).float()
    assert torch.equal(T[:, sd:, :], E)


@pytest.mark.parametrize("Hs", [8, 13, 32])
def test_primal_matches_plain_on_a_sin_table(dev, Hs):
    env, p, x0, _, a, dist = primal_operands(Hs, dev, "sin")
    k2 = rollout_cuda.make_primal(env, Hs)
    torch.testing.assert_close(k2(x0, a, dist, p), k2.plain(x0, a, dist, p),
                               atol=1e-5, rtol=0)


def test_chain_kernels_equal_earlier_designs_bit_for_bit(dev):
    """K3 (sd 13 and 16) and K2 (zero and sin tables) at H = 32 against the
    designs they replaced (``tools/earlier``), built here."""
    earlier = build_earlier()
    lib = kernels.library()
    cases = [("sens_chain", (chain_j(sd, 32, dev),), torch.empty(32, sd + 4, 128, device=dev),
              sd) for sd in (13, 16)]
    for table in ("zero", "sin"):
        _, _, x0, scal, a, dist = primal_operands(32, dev, table)
        cases.append(("primal", (x0, scal, a.reshape(-1).contiguous(),
                                 dist.reshape(-1).contiguous()),
                      torch.empty(32, 13, device=dev), 13))
    for name, ops, out, sd in cases:
        old = torch.empty_like(out)
        launcher(earlier[name][1], name, ops, old, 32, sd)()
        launcher(lib, name, ops, out, 32, sd)()
        torch.cuda.synchronize()
        assert torch.equal(out, old), (name, sd, float((out - old).abs().max()))


def test_chain_kernels_equal_earlier_designs_in_the_closed_loop(dev):
    """K2 and K3 on every input of one episode of the main path's closed loop
    (CoVO online, gn, kernel rng, zigzag) against the earlier designs."""
    for name, (n, bad, diff) in loop_bits(build_earlier(), dev, 300).items():
        assert n == 300 and bad == 0, (name, bad, diff)


@pytest.mark.parametrize("second_order", [False, True], ids=["gn", "adjoint"])
def test_hessian_through_kernels_matches_plain(dev, second_order):
    """The whole Hessian with K2 and K3 against the plain primal and chain,
    on the same CUDA inputs."""
    env, p, st = _env_state(dev)
    a = torch.randn(H * 4, generator=torch.Generator(dev).manual_seed(4),
                    device=dev) * 0.3
    args = (a, pack_state(st), st.time, st.pos_traj, st.vel_traj, p)
    got = make_hessian_adjoint(env, H, primal="cuda", tail="cuda",
                               second_order=second_order)(*args)
    ref = make_hessian_adjoint(env, H, primal="torch", tail="torch",
                               second_order=second_order)(*args)
    assert _rel(got, ref) < 1e-5


# --- the scenario-batched kernels: K6 and K7 (per-step and joint) ----------

B = 3


def _scenarios(dev, n_scen=B):
    """``n_scen`` domain-randomized scenarios from one generator: the
    batched kernels' state inputs and their stacked params."""
    env = QuadEnv(EnvConfig(task="tracking_zigzag", enable_randomizer=True,
                            disturb_type="gaussian",
                            disable_rollover_terminate=True,
                            generate_noisy_state=True), device=dev)
    gen = torch.Generator(dev).manual_seed(7)
    params = [env.sample_params(gen) for _ in range(n_scen)]
    sts = [env.reset(gen, p)[1]["noisy_state"] for p in params]
    args = (torch.stack([pack_state(s) for s in sts]), torch.stack([s.time for s in sts]),
            torch.stack([s.pos_traj for s in sts]), torch.stack([s.vel_traj for s in sts]))
    return env, args, stack_params(params)


def _batched_inputs(dev, Hs, seed=8):
    g = torch.Generator(dev).manual_seed(seed)
    a_means = torch.randn(B, Hs, 4, generator=g, device=dev) * 0.2
    A = torch.randn(B, Hs, 4, 4, generator=g, device=dev) * 0.2
    chols = torch.linalg.cholesky(A @ A.mT + 0.05 * torch.eye(4, device=dev)).contiguous()
    factors = torch.randn(B, 4 * Hs, 4 * Hs, generator=g, device=dev) * 0.1
    draws = torch.randn(B, 3, generator=g, device=dev)
    return g, a_means, chols, factors, draws


@pytest.mark.parametrize("n", [5000, 6144])
def test_batched_kernels_match_plain(dev, n):
    """K6 (both layouts), K7 per-step and K7 joint with given normals,
    deterministic and under per-scenario shared draws, at a ragged N."""
    env, args, pb = _scenarios(dev)
    g, a_means, chols, factors, draws = _batched_inputs(dev, H)
    acts = torch.randn(B, H, 4, n, generator=g, device=dev) * 0.5
    k6 = rollout_cuda.make_rollout_batched_costs(env)
    for kw in (dict(deterministic=True), dict(draws=draws)):
        for layout, a in (("hdn", acts), ("nhd", acts.permute(0, 3, 1, 2).contiguous())):
            torch.testing.assert_close(k6(*args, a, pb, discount=0.98, layout=layout, **kw),
                                       k6.plain(*args, a, pb, discount=0.98, layout=layout,
                                                **kw), atol=2e-4, rtol=1e-5)
        for joint, fac, z in ((False, chols, torch.randn(B, H, 4, n, generator=g, device=dev)),
                              (True, factors, torch.randn(B, D, n, generator=g, device=dev))):
            k7 = rollout_cuda.make_rollout_batched_sampling(env, joint=joint)
            kargs = (*args, a_means, fac, pb, 0, n)
            c_k, a_k = k7(*kargs, discount=0.98, z=z, **kw)
            c_p, a_p = k7.plain(*kargs, discount=0.98, z=z, **kw)
            torch.testing.assert_close(a_k, a_p, atol=1e-5, rtol=0)
            torch.testing.assert_close(c_k, c_p, atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize("Hs", [8, 32])
def test_batched_kernels_at_one_scenario_match_single(dev, Hs):
    """B=1: K6 gives K4's costs; K7 per-step and K7 joint draw exactly what
    K5 and K1 draw for the same seed, and their costs agree (2e-6: one
    kernel body, so any difference is FMA contraction); at H=8 and at the
    main path's H=32 (D=128)."""
    env, args, pb = _scenarios(dev, 1)
    g, a_means, chols, factors, draws = _batched_inputs(dev, Hs)
    single = tuple(x[0] for x in args)
    p0 = index_params(pb, 0)
    acts = torch.randn(1, Hs, 4, N, generator=g, device=dev) * 0.5
    c6 = rollout_cuda.make_rollout_batched_costs(env)(*args, acts, pb, draws[:1])
    c4 = rollout_cuda.make_rollout_costs(env)(*single, acts[0], p0, draws[0], layout="hdn")
    torch.testing.assert_close(c6[0], c4, atol=2e-6, rtol=0)
    for joint, fac, k in ((False, chols, rollout_cuda.make_rollout_sampling(env)),
                          (True, factors, rollout_cuda.make_rollout_joint_sampling(env))):
        k7 = rollout_cuda.make_rollout_batched_sampling(env, joint=joint)
        c_b, a_b = k7(*args, a_means[:1], fac[:1], pb, 17, N, draws=draws[:1])
        c_s, a_s = k(*single, a_means[0], fac[0], p0, 17, N, draw=draws[0])
        assert torch.equal(a_b[0], a_s)
        torch.testing.assert_close(c_b[0], c_s, atol=2e-6, rtol=0)


@pytest.mark.parametrize("Hs", [8, 32])
@pytest.mark.parametrize("joint", [False, True], ids=["per_step", "joint"])
def test_batched_draws_scenario_count_invariant(dev, joint, Hs):
    """A scenario's in-kernel draws depend on its index only: scenario 1 of
    a 2-scenario launch equals scenario 1 of a 3-scenario one, blocks of 64
    and 128 agree, and the scenarios draw different streams; at H=8 and at
    the main path's H=32 (D=128)."""
    env, args, pb = _scenarios(dev)
    _, _, chols, factors, _ = _batched_inputs(dev, Hs)
    zero = torch.zeros(B, Hs, 4, device=dev)
    fac = factors if joint else chols
    k7 = rollout_cuda.make_rollout_batched_sampling(env, joint=joint, block=128)
    c3, a3 = k7(*args, zero, fac, pb, 5, N, deterministic=True)
    two = stack_params([index_params(pb, b) for b in range(2)])
    c2, a2 = k7(*(x[:2] for x in args), zero[:2], fac[:2], two, 5, N, deterministic=True)
    assert torch.equal(a2[1], a3[1]) and torch.equal(c2[1], c3[1])
    c64, a64 = rollout_cuda.make_rollout_batched_sampling(env, joint=joint, block=64)(
        *args, zero, fac, pb, 5, N, deterministic=True)
    assert torch.equal(a64, a3) and torch.equal(c64, c3)
    same = (0.1 * torch.eye(fac.shape[-1], device=dev)).expand_as(fac).contiguous()
    _, a_same = k7(*args, zero, same, pb, 5, N, deterministic=True)
    assert not torch.equal(a_same[0], a_same[1])


def test_joint_batched_repeats_bit_for_bit(dev):
    """Ten launches of K7 joint at the batched path's size (B=16, N=8192,
    H=32) give the same costs and actions bit for bit: every read of the
    block's shared memory waits for its writes."""
    env, args, pb = _scenarios(dev, 16)
    Hm, Nm = 32, 8192
    g = torch.Generator(dev).manual_seed(9)
    a_means = torch.randn(16, Hm, 4, generator=g, device=dev) * 0.2
    factors = torch.randn(16, 4 * Hm, 4 * Hm, generator=g, device=dev) * 0.05
    draws = torch.randn(16, 3, generator=g, device=dev)
    k7 = rollout_cuda.make_rollout_batched_sampling(env, joint=True)
    first = k7(*args, a_means, factors, pb, 3, Nm, draws=draws)
    for _ in range(9):
        again = k7(*args, a_means, factors, pb, 3, Nm, draws=draws)
        assert all(torch.equal(x, y) for x, y in zip(again, first))


def test_joint_rejects_unsupported_block_and_width(dev):
    """K1 / K7 joint take 64 or 128 samples a block and D = 4H up to 128:
    anything else raises before a launch, in the wrappers and in the C
    entry point (which launches nothing and returns an error)."""
    env, p, st = _env_state(dev)
    for block in (32, 96, 256):
        with pytest.raises(ValueError):
            rollout_cuda.make_rollout_joint_sampling(env, block=block)
        with pytest.raises(ValueError):
            rollout_cuda.make_rollout_batched_sampling(env, joint=True, block=block)
    k1 = rollout_cuda.make_rollout_joint_sampling(env)
    launches = rollout_cuda.JOINT_KERNEL.launches
    Hw = 33
    with pytest.raises(ValueError):
        k1(pack_state(st), st.time, st.pos_traj, st.vel_traj,
           torch.zeros(Hw, 4, device=dev), torch.zeros(4 * Hw, 4 * Hw, device=dev),
           p, 0, N, deterministic=True)
    ops = rollout_cuda._launch_operands(env, pack_state(st), st.time, st.pos_traj,
                                        st.vel_traj, p, None, True, 1.0, H)
    mean, factor = torch.zeros(D, device=dev), torch.zeros(D, D, device=dev)
    costs, acts = torch.empty(N, device=dev), torch.empty(D, N, device=dev)
    seed = rollout_cuda.seed_word(0, dev)
    for block, h in ((96, H), (64, Hw)):
        with pytest.raises(RuntimeError):
            rollout_cuda.JOINT_KERNEL.launch(
                *(t.data_ptr() for t in ops), mean.data_ptr(), factor.data_ptr(), None,
                seed.data_ptr(), costs.data_ptr(), acts.data_ptr(), N, h, 0, 0, 0, block)
    torch.cuda.synchronize()
    assert rollout_cuda.JOINT_KERNEL.launches == launches


def test_sample_rollout_repeats_bit_for_bit(dev):
    """Ten launches of K7 per-step at the batched path's size (B=16,
    N=8192, H=32) give the same costs and actions bit for bit: every read of
    the block's action tile waits for its writes."""
    env, args, pb = _scenarios(dev, 16)
    Hm, Nm = 32, 8192
    g = torch.Generator(dev).manual_seed(9)
    a_means = torch.randn(16, Hm, 4, generator=g, device=dev) * 0.2
    A = torch.randn(16, Hm, 4, 4, generator=g, device=dev) * 0.2
    chols = torch.linalg.cholesky(A @ A.mT + 0.05 * torch.eye(4, device=dev)).contiguous()
    draws = torch.randn(16, 3, generator=g, device=dev)
    k7 = rollout_cuda.make_rollout_batched_sampling(env)
    first = k7(*args, a_means, chols, pb, 3, Nm, draws=draws)
    for _ in range(9):
        again = k7(*args, a_means, chols, pb, 3, Nm, draws=draws)
        assert all(torch.equal(x, y) for x, y in zip(again, first))


def test_sample_rollout_rejects_unsupported_block(dev):
    """K5 / K7 per-step take 32, 64 or 128 samples a block and write their
    action tile in 16-byte stores: another block raises in the wrappers, and
    the C entry point launches nothing and returns an error for another
    block or an actions pointer that is not 16-byte aligned."""
    env, p, st = _env_state(dev)
    for block in (16, 96, 256):
        with pytest.raises(ValueError):
            rollout_cuda.make_rollout_sampling(env, block=block)
        with pytest.raises(ValueError):
            rollout_cuda.make_rollout_batched_sampling(env, block=block)
    ops = rollout_cuda._launch_operands(env, pack_state(st), st.time, st.pos_traj,
                                        st.vel_traj, p, None, True, 1.0, H)
    _, a_mean, chol = _per_step_inputs(dev)
    costs, acts = torch.empty(N, device=dev), torch.empty(D * N + 4, device=dev)
    launches = rollout_cuda.SAMPLE_KERNEL.launches
    seed = rollout_cuda.seed_word(0, dev)
    for block, out in ((96, acts.data_ptr()), (128, acts.data_ptr() + 4)):
        with pytest.raises(RuntimeError):
            rollout_cuda.SAMPLE_KERNEL.launch(
                *(t.data_ptr() for t in ops), a_mean.data_ptr(), chol.data_ptr(), None,
                seed.data_ptr(), None, 0, None, costs.data_ptr(), out, N, H, 0, 0, 0, block)
    torch.cuda.synchronize()
    assert rollout_cuda.SAMPLE_KERNEL.launches == launches


def test_joint_batched_philox_moments(dev):
    """K7 joint's per-scenario draws at the main path's size (N=8192, H=32):
    mean 0, F = 0.1 I, so each action dimension of every scenario is
    N(0, 0.01); the same limits as K1's."""
    env, args, pb = _scenarios(dev)
    Nm, Hm = 8192, 32
    k7 = rollout_cuda.make_rollout_batched_sampling(env, joint=True)
    zero = torch.zeros(B, Hm, 4, device=dev)
    eye = (0.1 * torch.eye(4 * Hm, device=dev)).expand(B, 4 * Hm, 4 * Hm).contiguous()
    _, a1 = k7(*args, zero, eye, pb, 1234, Nm, deterministic=True)
    _, a1b = k7(*args, zero, eye, pb, 1234, Nm, deterministic=True)
    _, a2 = k7(*args, zero, eye, pb, 1235, Nm, deterministic=True)
    for b in range(B):
        mean_d = a1[b].mean(dim=1)
        var_d = a1[b].var(dim=1, correction=0)
        pooled = float(a1[b].pow(2).mean() - a1[b].mean().pow(2))
        assert float(mean_d.abs().max()) <= 5e-3
        assert float((var_d / 0.01 - 1).abs().max()) <= 0.10
        assert abs(pooled / 0.01 - 1) <= 0.01
    assert torch.equal(a1, a1b) and not torch.equal(a1, a2)


# --- the fused Newton–Schulz Sigma-designer: K8 ----------------------------


def _near_singular(D, seed):
    """A PSD R with eigenvalues log-spaced from 1e-6 to 1."""
    g = torch.Generator().manual_seed(seed)
    Q, _ = torch.linalg.qr(torch.randn(D, D, generator=g, dtype=torch.float64))
    ev = torch.logspace(-6, 0, D, dtype=torch.float64)
    return ((Q * ev) @ Q.T).float()


def _badly_scaled(D, seed, scale=1e3):
    """The JAX kernel test's R = A A^T / D - 0.3 I, at ``scale``."""
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(D, D, generator=g, dtype=torch.float64)
    return ((A @ A.T / D - 0.3 * torch.eye(D, dtype=torch.float64)) * scale).float()


# 128 is the main path's width; 100 leaves the cluster's last CTAs ragged rows
# or none (slabs of 16 rows: six full, one of 4, one empty)
SIGMA_DS = [32, 64, 100, 128]


@pytest.mark.parametrize("D", SIGMA_DS)
def test_sigma_ns_matches_plain_near_singular(dev, D):
    """K8 against its plain version on a near-singular R (smallest
    eigenvalue 1e-6): relative Frobenius 1e-3 on a_cov and the factor (the
    JAX package's bar between its two designers), max abs 2e-4 on a_cov,
    and the factor a lower square root of a_cov."""
    from covo_mpc_tpu_torch.ops import covariance, covariance_cuda

    R = _near_singular(D, D).to(dev)
    c_k, f_k = covariance_cuda.optimize_sigma_ns_cuda(R, 0.5, D)
    c_p, f_p = covariance.optimize_sigma_ns(R, 0.5, D)
    assert _rel(c_k, c_p) <= 1e-3 and _rel(f_k, f_p) <= 1e-3
    assert float((c_k - c_p).abs().max()) <= 2e-4
    assert torch.equal(f_k, torch.tril(f_k))
    torch.testing.assert_close(f_k @ f_k.T, c_k, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("D", SIGMA_DS)
def test_sigma_ns_matches_plain_badly_scaled(dev, D):
    """K8 on R scaled by 1e3: both designers shift the spectrum's floor to
    an absolute 1e-2, so one fp32 ulp of lambda_min (~1e-4 at this scale)
    moves a_cov by up to ~1e-2 of its norm whichever designer runs; what
    stays exact is checked tightly: a finite lower square root of a_cov at
    log det a_cov = 2 D log sigma."""
    from covo_mpc_tpu_torch.ops import covariance, covariance_cuda

    R = _badly_scaled(D, D).to(dev)
    c_k, f_k = covariance_cuda.optimize_sigma_ns_cuda(R, 0.5, D)
    c_p, f_p = covariance.optimize_sigma_ns(R, 0.5, D)
    assert bool(torch.isfinite(c_k).all() and torch.isfinite(f_k).all())
    assert _rel(c_k, c_p) <= 1e-2 and _rel(f_k, f_p) <= 1e-2
    assert torch.equal(f_k, torch.tril(f_k))
    torch.testing.assert_close(f_k @ f_k.T, c_k, atol=2e-5, rtol=1e-5)
    logdet = float(torch.linalg.slogdet(c_k.double()).logabsdet)
    assert abs(logdet - 2 * D * math.log(0.5)) <= 1e-3


@pytest.mark.parametrize("D", [100, 128])
def test_sigma_ns_repeats_bit_for_bit(dev, D):
    """20 launches on one R give bit-identical a_cov and factor: every
    cluster reduction adds its partials in one order, and a missing cluster
    barrier would let a CTA read a peer's rows before or after they change."""
    from covo_mpc_tpu_torch.ops import covariance_cuda

    R = _badly_scaled(D, 3, scale=1.0).to(dev)
    c0, f0 = covariance_cuda.optimize_sigma_ns_cuda(R, 0.5, D)
    for _ in range(19):
        c, f = covariance_cuda.optimize_sigma_ns_cuda(R, 0.5, D)
        assert torch.equal(c, c0) and torch.equal(f, f0)


def test_sigma_ns_counts_and_rejects(dev):
    """One launch per call, counted; D above 128 or not a multiple of 4
    raises before any launch."""
    from covo_mpc_tpu_torch.ops import covariance_cuda

    k = covariance_cuda.SIGMA_KERNEL
    before = k.launches
    covariance_cuda.optimize_sigma_ns_cuda(_near_singular(32, 1).to(dev), 0.5, 32)
    assert k.launches == before + 1
    for D in (132, 30):
        with pytest.raises(ValueError):
            covariance_cuda.optimize_sigma_ns_cuda(torch.eye(D, device=dev), 0.5, D)
    assert k.launches == before + 1


# --- the disturbance modes: table (sin, periodic), drag, mixed -------------

KINDS = ["periodic", "sin", "drag", "mixed"]
T0 = 47  # a redraw (t % 50 == 0) inside the horizon


def _mode_env(dev, kind, randomize=False, task="tracking_zigzag"):
    """An env on ``task`` under ``kind`` with non-zero disturb_params (the
    wind and the sinusoid), its params, and a noisy reset state moved to T0
    with a non-zero start force."""
    env = QuadEnv(EnvConfig(task=task, enable_randomizer=randomize,
                            disturb_type=kind, disable_rollover_terminate=True,
                            generate_noisy_state=True), device=dev)
    g = torch.Generator(dev).manual_seed(9)
    p = env.default_params.replace(
        disturb_params=torch.rand(6, generator=g, device=dev) * 2.0 - 1.0)
    _, info, _ = env.reset(torch.Generator(dev).manual_seed(0), p)
    st = info["noisy_state"].replace(
        time=torch.tensor(T0, dtype=torch.int32, device=dev),
        f_disturb=torch.tensor([0.02, -0.01, 0.015], device=dev))
    return env, p, st


@pytest.mark.parametrize("kind", KINDS)
def test_rollout_kernels_in_each_mode_match_plain(dev, kind):
    """K1, K4 and K5 in the table / drag / mixed modes at a ragged N,
    against their plain versions on the same normals and uniform draw."""
    _single_kernels_match_plain(dev, kind, "tracking_zigzag")


def _single_kernels_match_plain(dev, kind, task):
    env, p, st = _mode_env(dev, kind, task=task)
    g = torch.Generator(dev).manual_seed(10)
    draw = env.draw_disturb(g)
    roll = (pack_state(st), st.time, st.pos_traj, st.vel_traj)
    a_mean = torch.randn(H, 4, generator=g, device=dev) * 0.2
    factor = torch.randn(D, D, generator=g, device=dev) * 0.1
    z = torch.randn(D, N, generator=g, device=dev)
    k1 = rollout_cuda.make_rollout_joint_sampling(env)
    for det in (True, False):
        kw = dict(deterministic=det, discount=0.98, draw=draw, z=z)
        c_k, a_k = k1(*roll, a_mean, factor, p, 0, N, **kw)
        c_p, a_p = k1.plain(*roll, a_mean, factor, p, 0, N, **kw)
        torch.testing.assert_close(a_k, a_p, atol=1e-5, rtol=0)
        torch.testing.assert_close(c_k, c_p, atol=2e-4, rtol=1e-5)
    acts = torch.randn(H, 4, N, generator=g, device=dev) * 0.5
    k4 = rollout_cuda.make_rollout_costs(env)
    torch.testing.assert_close(k4(*roll, acts, p, draw, layout="hdn"),
                               k4.plain(*roll, acts, p, draw, layout="hdn"),
                               atol=2e-4, rtol=1e-5)
    _, a_mean5, chol = _per_step_inputs(dev)
    z5 = torch.randn(H, 4, N, generator=g, device=dev)
    k5 = rollout_cuda.make_rollout_sampling(env)
    c_k, a_k = k5(*roll, a_mean5, chol, p, 0, N, draw=draw, z=z5)
    c_p, a_p = k5.plain(*roll, a_mean5, chol, p, 0, N, draw=draw, z=z5)
    torch.testing.assert_close(a_k, a_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(c_k, c_p, atol=2e-4, rtol=1e-5)
    # the mode changes the costs (the force matters)
    if kind != "sin":
        gauss = QuadEnv(EnvConfig(task=task, enable_randomizer=False,
                                  disturb_type="none", disable_rollover_terminate=True,
                                  generate_noisy_state=True), device=dev)
        c_none = rollout_cuda.make_rollout_costs(gauss)(*roll, acts, p, layout="hdn")
        assert not torch.allclose(c_none, k4(*roll, acts, p, draw, layout="hdn"))
    return env


@pytest.mark.parametrize("kind", KINDS)
def test_batched_kernels_in_each_mode_scenario_count_invariant(dev, kind):
    """K6, K7 per-step and K7 joint in each mode at B=16 against their plain
    versions (ragged N), and scenario 0 of the B=16 launch equal to the B=1
    launch of the same scenario: per-scenario dist tables and draws."""
    _batched_kernels_match_plain(dev, kind, "tracking_zigzag")


def _batched_kernels_match_plain(dev, kind, task):
    env, _, _ = _mode_env(dev, kind, randomize=True, task=task)
    gen = torch.Generator(dev).manual_seed(11)
    Bm = 16
    params = [env.sample_params(gen) for _ in range(Bm)]
    sts = [env.reset(gen, q)[1]["noisy_state"] for q in params]
    args = (torch.stack([pack_state(s) for s in sts]),
            torch.tensor([T0 + b % 4 for b in range(Bm)], dtype=torch.int32, device=dev),
            torch.stack([s.pos_traj for s in sts]), torch.stack([s.vel_traj for s in sts]))
    pb = stack_params(params)
    one = tuple(x[:1] for x in args)
    pb1 = stack_params(params[:1])
    draws = env.draw_disturb(gen, Bm)
    d1 = None if draws is None else draws[:1]
    acts = torch.randn(Bm, H, 4, N, generator=gen, device=dev) * 0.5
    k6 = rollout_cuda.make_rollout_batched_costs(env)
    c16 = k6(*args, acts, pb, draws, discount=0.98)
    torch.testing.assert_close(c16, k6.plain(*args, acts, pb, draws, discount=0.98),
                               atol=2e-4, rtol=1e-5)
    assert torch.equal(k6(*one, acts[:1], pb1, d1, discount=0.98)[0], c16[0])
    a_means = torch.randn(Bm, H, 4, generator=gen, device=dev) * 0.2
    A = torch.randn(Bm, H, 4, 4, generator=gen, device=dev) * 0.2
    chols = torch.linalg.cholesky(A @ A.mT + 0.05 * torch.eye(4, device=dev)).contiguous()
    factors = torch.randn(Bm, D, D, generator=gen, device=dev) * 0.1
    for joint, fac, z in ((False, chols, torch.randn(Bm, H, 4, N, generator=gen, device=dev)),
                          (True, factors, torch.randn(Bm, D, N, generator=gen, device=dev))):
        k7 = rollout_cuda.make_rollout_batched_sampling(env, joint=joint)
        kw = dict(deterministic=joint, discount=0.98, draws=draws, z=z)
        c_k, a_k = k7(*args, a_means, fac, pb, 0, N, **kw)
        c_p, a_p = k7.plain(*args, a_means, fac, pb, 0, N, **kw)
        torch.testing.assert_close(a_k, a_p, atol=1e-5, rtol=0)
        torch.testing.assert_close(c_k, c_p, atol=2e-4, rtol=1e-5)
        c1, a1 = k7(*one, a_means[:1], fac[:1], pb1, 0, N, deterministic=joint,
                    discount=0.98, draws=d1, z=z[:1])
        assert torch.equal(a1[0], a_k[0]) and torch.equal(c1[0], c_k[0])


@pytest.mark.parametrize("kind", ["gaussian"] + KINDS)
def test_sample_rollout_bits_equal_across_blocks(dev, kind):
    """K5 (B=1) and K7 per-step (B=16 domain-randomized scenarios) give the
    same costs and actions bit for bit at every block size they take, at a
    ragged N, with in-kernel draws and given normals, in each disturbance
    mode; under the gaussian model also K5's in-kernel disturbance draw
    ("krng") and its draw_out."""
    Bm = 16
    env, p, st = _mode_env(dev, kind)
    env_b, _, _ = _mode_env(dev, kind, randomize=True)
    g = torch.Generator(dev).manual_seed(13)
    params = [env_b.sample_params(g) for _ in range(Bm)]
    sts = [env_b.reset(g, q)[1]["noisy_state"] for q in params]
    args = (torch.stack([pack_state(s) for s in sts]),
            torch.tensor([T0 + b % 4 for b in range(Bm)], dtype=torch.int32, device=dev),
            torch.stack([s.pos_traj for s in sts]), torch.stack([s.vel_traj for s in sts]))
    pb = stack_params(params)
    draw = env.draw_disturb(g)
    draws = env_b.draw_disturb(g, Bm)
    roll = (pack_state(st), st.time, st.pos_traj, st.vel_traj)
    _, a_mean, chol = _per_step_inputs(dev)
    a_means = torch.randn(Bm, H, 4, generator=g, device=dev) * 0.2
    A = torch.randn(Bm, H, 4, 4, generator=g, device=dev) * 0.2
    chols = torch.linalg.cholesky(A @ A.mT + 0.05 * torch.eye(4, device=dev)).contiguous()
    z = torch.randn(H, 4, N, generator=g, device=dev)
    zb = torch.randn(Bm, H, 4, N, generator=g, device=dev)
    calls = [lambda k5, k7: k5(*roll, a_mean, chol, p, 11, N, draw=draw),
             lambda k5, k7: k5(*roll, a_mean, chol, p, 0, N, draw=draw, z=z),
             lambda k5, k7: k7(*args, a_means, chols, pb, 11, N, draws=draws),
             lambda k5, k7: k7(*args, a_means, chols, pb, 0, N, draws=draws, z=zb)]
    if kind == "gaussian":
        draw_out = torch.zeros(3, device=dev)

        def krng(k5, k7):
            draw_out.zero_()
            return (*k5(*roll, a_mean, chol, p, 11, N, disturb_seed=12,
                        draw_out=draw_out), draw_out.clone())
        calls.append(krng)
    ref = None
    for block in rollout_cuda.SAMPLE_BLOCKS:
        k5 = rollout_cuda.make_rollout_sampling(env, block=block)
        k7 = rollout_cuda.make_rollout_batched_sampling(env_b, block=block)
        got = [call(k5, k7) for call in calls]
        if ref is None:
            ref = got
        for x, y in zip(got, ref):
            assert all(torch.equal(u, v) for u, v in zip(x, y))


@pytest.mark.parametrize("second_order", [False, True], ids=["gn", "adjoint"])
@pytest.mark.parametrize("kind", KINDS)
def test_hessian_in_each_mode_through_kernels(dev, kind, second_order):
    """The Hessian through the kernels against the plain primal and chain:
    K2 on the force table (sin, periodic), K3 at sd=16 (drag, mixed) through
    make_hessian_adjoint, launched once each."""
    env, p, st = _mode_env(dev, kind)
    g = torch.Generator(dev).manual_seed(12)
    a = torch.randn(H * 4, generator=g, device=dev) * 0.3
    draws = env.draw_disturb(g, H, deterministic=True)
    args = (a, pack_state(st), st.time, st.pos_traj, st.vel_traj, p, draws)
    before = (rollout_cuda.PRIMAL_KERNEL.launches, hessian_cuda.CHAIN_KERNEL.launches)
    got = make_hessian_adjoint(env, H, primal="cuda", tail="cuda",
                               second_order=second_order)(*args)
    ref = make_hessian_adjoint(env, H, primal="torch", tail="torch",
                               second_order=second_order)(*args)
    assert _rel(got, ref) < 1e-5
    vel = kind in ("drag", "mixed")
    assert rollout_cuda.PRIMAL_KERNEL.launches == before[0] + (0 if vel else 1)
    assert hessian_cuda.CHAIN_KERNEL.launches == before[1] + 1


# --- the realworld reward (tracking_slow) ----------------------------------


@pytest.mark.parametrize("kind", ["gaussian"] + KINDS)
def test_realworld_rollout_kernels_match_plain(dev, kind):
    """The realworld branch of K1, K4 and K5 on tracking_slow in every
    disturbance mode at a ragged N, against their plain versions; under the
    gaussian model also K5's in-kernel draw ("krng") fed back to the plain
    rollout."""
    env = _single_kernels_match_plain(dev, kind, "tracking_slow")
    assert rollout_cuda.make_rollout_costs(env).reward == rollout_cuda.REWARDS["realworld"]
    if kind == "gaussian":
        _, p, st = _mode_env(dev, kind, task="tracking_slow")
        _, a_mean, chol = _per_step_inputs(dev)
        k5 = rollout_cuda.make_rollout_sampling(env)
        roll = (pack_state(st), st.time, st.pos_traj, st.vel_traj)
        draw_out = torch.zeros(3, device=dev)
        c_k, a_k = k5(*roll, a_mean, chol, p, 21, N, discount=0.98, disturb_seed=22,
                      draw_out=draw_out)
        ref = k5._rollout(*roll, a_k, p, draw_out.clone(), discount=0.98, layout="hdn")
        torch.testing.assert_close(c_k, ref, atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize("kind", ["gaussian"] + KINDS)
def test_realworld_batched_kernels_scenario_count_invariant(dev, kind):
    """The realworld branch of K6, K7 per-step and K7 joint on tracking_slow
    at B=16 against their plain versions (ragged N), and scenario 0 of the
    B=16 launch bit-equal to the B=1 launch of the same scenario."""
    _batched_kernels_match_plain(dev, kind, "tracking_slow")


# --- K4 / K6 beside the kernel they replaced (tools/earlier/rollout.cu) -----


@pytest.fixture(scope="module")
def earlier_rollout():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: a CUDA kernel has no CPU mode")
    return rollout_variants.build_earlier()[1]


def _rollout_inputs(dev, kind, task, Hs=32, n=8192, seed=3):
    """rollout_variants' operands of 16 scenarios (the even ones leave |p| < 3
    mid-horizon) and 0.8 N(0, 1) actions (16, Hs, 4, n)."""
    ops16, mode, reward = rollout_variants.operands(kind, task, 16, Hs, dev)
    g = torch.Generator(dev).manual_seed(seed)
    acts = 0.8 * torch.randn(16, Hs, 4, n, generator=g, device=dev)
    return ops16, acts, mode, reward


def _launch(cdll, ops16, acts, B, rollover, mode, reward, block=rollout_cuda.ROLLOUT_BLOCK,
            entry_b=None):
    """Costs (B, n) of scenarios 0 .. B-1 through ``cdll``'s K4 (B=1) or K6
    entry point (``entry_b``: the batched one at B=1 too)."""
    ops = [t[:B].contiguous() for t in ops16]
    a = acts[:B].contiguous()
    _, Hs, _, n = a.shape
    out = torch.full((B, n), float("nan"), device=a.device)
    if entry_b:
        ptrs = [t.data_ptr() for t in ops]
        err = cdll.rollout_costs_batched(*ptrs, a.data_ptr(), out.data_ptr(), B, n, Hs,
                                         rollover, mode, reward, block,
                                         torch.cuda.current_stream().cuda_stream)
        assert err == 0
    else:
        rollout_variants.launcher(cdll, ops, a, out, B, n, Hs, rollover, mode, reward,
                                  block)()
    torch.cuda.synchronize()
    return out


def test_rollout_costs_repeat_bit_for_bit(dev):
    """K4 (B=1) and K6 (B=16) at N=8192, H=32: 10 launches, the same bits."""
    ops16, acts, mode, reward = _rollout_inputs(dev, "gaussian", "tracking_zigzag")
    for B in (1, 16):
        first = _launch(kernels.library(), ops16, acts, B, 1, mode, reward)
        for _ in range(9):
            assert torch.equal(_launch(kernels.library(), ops16, acts, B, 1, mode, reward),
                               first)


@pytest.mark.parametrize("case", list(CASES), ids=["-".join(c) for c in CASES])
def test_rollout_costs_equal_earlier_kernel(dev, earlier_rollout, case):
    """K4 against the kernel it replaced, bit for bit, in every disturbance
    mode and reward, at N=1000 (ragged) and 8192, rollover check on and off."""
    for n in (1000, 8192):
        ops16, acts, mode, reward = _rollout_inputs(dev, *CASES[case], n=n)
        for rollover in (0, 1):
            got = _launch(kernels.library(), ops16, acts, 1, rollover, mode, reward)
            ref = _launch(earlier_rollout, ops16, acts, 1, rollover, mode, reward, block=128)
            assert torch.equal(got, ref), f"N={n} rollover={rollover}"


@pytest.mark.parametrize("case", list(CASES), ids=["-".join(c) for c in CASES])
def test_rollout_costs_batched_equal_earlier_kernel(dev, earlier_rollout, case):
    """K6 at B=1 and B=16 against the kernel it replaced, bit for bit, in
    every mode and reward (ragged N, rollover on); K6 at B=1 equals K4."""
    ops16, acts, mode, reward = _rollout_inputs(dev, *CASES[case], n=1000)
    lib = kernels.library()
    for B in (1, 16):
        got = _launch(lib, ops16, acts, B, 1, mode, reward, entry_b=True)
        ref = _launch(earlier_rollout, ops16, acts, B, 1, mode, reward, block=128,
                      entry_b=True)
        assert torch.equal(got, ref), f"B={B}"
    assert torch.equal(_launch(lib, ops16, acts, 1, 1, mode, reward, entry_b=True),
                       _launch(lib, ops16, acts, 1, 1, mode, reward))


def test_rollout_costs_with_terminations_match_plain(dev):
    """K4 with rollover termination on, from a state near |p| = 3 moving out,
    where some samples terminate mid-horizon (|p| > 3 or rollover) and some
    do not: the freeze, computed apart from the state chain, against the
    plain version."""
    from covo_mpc_tpu_torch.models import dynamics
    from covo_mpc_tpu_torch.models.structs import FDIST, VEL
    from covo_mpc_tpu_torch.ops import rollout as rollout_ops

    env = QuadEnv(EnvConfig(task="tracking_zigzag", enable_randomizer=False,
                            disturb_type="gaussian", disable_rollover_terminate=False,
                            generate_noisy_state=True), device=dev)
    _, info, _ = env.reset(torch.Generator(dev).manual_seed(0))
    st, p = info["noisy_state"], env.default_params
    x0 = pack_state(st).clone()
    x0[0], x0[7] = 2.9, 0.6
    g = torch.Generator(dev).manual_seed(4)
    n, Hs = 8192, 32
    acts = 0.8 * torch.randn(Hs, 4, n, generator=g, device=dev)
    draw = torch.randn(3, generator=g, device=dev)
    roll = (x0, st.time, st.pos_traj, st.vel_traj, acts, p, draw)
    k4 = rollout_cuda.make_rollout_costs(env)
    got = k4(*roll, discount=0.98, layout="hdn")
    ref = k4.plain(*roll, discount=0.98, layout="hdn")
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=1e-5)
    # which samples terminate, and when: the plain states step by step
    done_fn = rollout_ops._make_done(env)
    x = x0[:16].expand(n, 16)
    first = torch.full((n,), Hs, device=dev)
    for h in range(Hs):
        d = done_fn(x, st.time + h, p.max_steps_in_episode)
        first = torch.where(d & (first == Hs), torch.full_like(first, h), first)
        s_new = dynamics.core_step(x[:, :13], acts[h].T, x[:, 13:16], p, env._dt)
        f_new = env.disturb_fn(p, draw, st.time + h, x[..., VEL], x[..., FDIST])
        x = torch.cat([s_new, f_new.expand(n, 3)], dim=-1)
    mid = int(((first > 0) & (first < Hs)).sum())
    assert 0 < mid < n, f"{mid} of {n} samples terminate mid-horizon"


# --- small N: below one block of every size, and ragged over a few ----------

# N=16 and 32 fill less than one block of any size a kernel takes (32, 64,
# 128); N=64 fills one block of 64 exactly; N=100 is ragged over 4, 2 or 1
# blocks of 32, 64 or 128. H=32 (D=128), the N-ablation's width
# (scripts/n_ablation.py: N = 16 ... 1024).
SMALL_NS = [16, 32, 64, 100]
HS = 32


def _small_inputs(dev, n, seed=20):
    g = torch.Generator(dev).manual_seed(seed)
    a_mean = torch.randn(HS, 4, generator=g, device=dev) * 0.2
    factor = torch.randn(4 * HS, 4 * HS, generator=g, device=dev) * 0.1
    A = torch.randn(HS, 4, 4, generator=g, device=dev) * 0.2
    chol = torch.linalg.cholesky(A @ A.mT + 0.05 * torch.eye(4, device=dev)).contiguous()
    draw = torch.randn(3, generator=g, device=dev)
    return g, a_mean, factor, chol, draw


def _costs_and_actions_close(got, ref):
    torch.testing.assert_close(got[1], ref[1], atol=2e-4, rtol=0)
    torch.testing.assert_close(got[0], ref[0], atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize("n", SMALL_NS)
def test_joint_sample_rollout_at_small_n_matches_plain(dev, n):
    """K1 at H=32 with given normals against its plain version, deterministic
    and under the shared draw; blocks of 64 and 128 agree bit for bit; its
    in-kernel draws of the first n samples equal those of a launch at
    N=8192 (the idle lanes of the last block draw and write nothing)."""
    env, p, st = _env_state(dev)
    roll = (pack_state(st), st.time, st.pos_traj, st.vel_traj)
    g, a_mean, factor, _, draw = _small_inputs(dev, n)
    z = torch.randn(4 * HS, n, generator=g, device=dev)
    for kw in (dict(deterministic=True), dict(draw=draw)):
        outs = [rollout_cuda.make_rollout_joint_sampling(env, block=b)(
            *roll, a_mean, factor, p, 0, n, discount=0.98, z=z, **kw)
            for b in rollout_cuda.JOINT_BLOCKS]
        k1 = rollout_cuda.make_rollout_joint_sampling(env)
        ref = k1.plain(*roll, a_mean, factor, p, 0, n, discount=0.98, z=z, **kw)
        assert outs[0][0].shape == (n,) and outs[0][1].shape == (4 * HS, n)
        _costs_and_actions_close(outs[0], ref)
        assert all(torch.equal(x, y) for x, y in zip(outs[0], outs[1]))
    c_n, a_n = k1(*roll, a_mean, factor, p, 31, n, draw=draw)
    c_f, a_f = k1(*roll, a_mean, factor, p, 31, 8192, draw=draw)
    assert torch.equal(a_n, a_f[:, :n]) and torch.equal(c_n, c_f[:n])


@pytest.mark.parametrize("n", SMALL_NS)
def test_rollout_costs_at_small_n_match_plain(dev, n):
    """K4 at H=32 in both layouts against its plain version, deterministic
    and under the shared draw; blocks of 32, 64 and 128 (the split kernel at
    these grids) agree bit for bit."""
    env, p, st = _env_state(dev)
    roll = (pack_state(st), st.time, st.pos_traj, st.vel_traj)
    g, _, _, _, draw = _small_inputs(dev, n)
    acts = torch.randn(HS, 4, n, generator=g, device=dev) * 0.5
    for layout, a in (("hdn", acts), ("nhd", acts.permute(2, 0, 1).contiguous())):
        for kw in (dict(deterministic=True), dict(draw=draw)):
            outs = [rollout_cuda.make_rollout_costs(env, block=b)(
                *roll, a, p, discount=0.98, layout=layout, **kw)
                for b in rollout_cuda.ROLLOUT_BLOCKS]
            ref = rollout_cuda.make_rollout_costs(env).plain(
                *roll, a, p, discount=0.98, layout=layout, **kw)
            assert outs[0].shape == (n,)
            torch.testing.assert_close(outs[0], ref, atol=2e-4, rtol=1e-5)
            assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("n", SMALL_NS)
def test_sample_rollout_at_small_n_matches_plain(dev, n):
    """K5 at H=32 with given normals against its plain version, deterministic
    and under the shared draw; with in-kernel draws, blocks of 32, 64 and
    128 (the tile kernel at these grids) agree bit for bit, and the first n
    samples equal those of a launch at N=8192."""
    env, p, st = _env_state(dev)
    roll = (pack_state(st), st.time, st.pos_traj, st.vel_traj)
    g, a_mean, _, chol, draw = _small_inputs(dev, n)
    z = torch.randn(HS, 4, n, generator=g, device=dev)
    k5 = rollout_cuda.make_rollout_sampling(env)
    for kw in (dict(deterministic=True), dict(draw=draw)):
        got = k5(*roll, a_mean, chol, p, 0, n, discount=0.98, z=z, **kw)
        ref = k5.plain(*roll, a_mean, chol, p, 0, n, discount=0.98, z=z, **kw)
        assert got[0].shape == (n,) and got[1].shape == (4 * HS, n)
        _costs_and_actions_close(got, ref)
    outs = [rollout_cuda.make_rollout_sampling(env, block=b)(
        *roll, a_mean, chol, p, 41, n, draw=draw) for b in rollout_cuda.SAMPLE_BLOCKS]
    assert all(torch.equal(x, y) for o in outs[1:] for x, y in zip(outs[0], o))
    c_f, a_f = k5(*roll, a_mean, chol, p, 41, 8192, draw=draw)
    assert torch.equal(outs[0][1], a_f[..., :n]) and torch.equal(outs[0][0], c_f[:n])


def _small_scenarios(dev, n, Bs=4, seed=21):
    """Bs domain-randomized scenarios and per-scenario inputs at H=32."""
    env, args, pb = _scenarios(dev, Bs)
    g = torch.Generator(dev).manual_seed(seed)
    a_means = torch.randn(Bs, HS, 4, generator=g, device=dev) * 0.2
    A = torch.randn(Bs, HS, 4, 4, generator=g, device=dev) * 0.2
    chols = torch.linalg.cholesky(A @ A.mT + 0.05 * torch.eye(4, device=dev)).contiguous()
    factors = torch.randn(Bs, 4 * HS, 4 * HS, generator=g, device=dev) * 0.1
    draws = torch.randn(Bs, 3, generator=g, device=dev)
    return env, args, pb, g, a_means, chols, factors, draws


@pytest.mark.parametrize("n", SMALL_NS)
def test_batched_kernels_at_small_n_match_plain(dev, n):
    """K6 (both layouts), K7 per-step and K7 joint at B=4, H=32 with given
    normals against their plain versions, deterministic and under
    per-scenario shared draws; with in-kernel draws, scenario 0 of the B=4
    launch equals the B=1 launch of the same scenario bit for bit."""
    env, args, pb, g, a_means, chols, factors, draws = _small_scenarios(dev, n)
    Bs = a_means.shape[0]
    acts = torch.randn(Bs, HS, 4, n, generator=g, device=dev) * 0.5
    k6 = rollout_cuda.make_rollout_batched_costs(env)
    for kw in (dict(deterministic=True), dict(draws=draws)):
        for layout, a in (("hdn", acts), ("nhd", acts.permute(0, 3, 1, 2).contiguous())):
            got = k6(*args, a, pb, discount=0.98, layout=layout, **kw)
            assert got.shape == (Bs, n)
            torch.testing.assert_close(
                got, k6.plain(*args, a, pb, discount=0.98, layout=layout, **kw),
                atol=2e-4, rtol=1e-5)
    one = tuple(x[:1] for x in args)
    pb1 = stack_params([index_params(pb, 0)])
    for joint, fac, z in (
            (False, chols, torch.randn(Bs, HS, 4, n, generator=g, device=dev)),
            (True, factors, torch.randn(Bs, 4 * HS, n, generator=g, device=dev))):
        k7 = rollout_cuda.make_rollout_batched_sampling(env, joint=joint)
        kargs = (*args, a_means, fac, pb, 0, n)
        for kw in (dict(deterministic=True), dict(draws=draws)):
            got = k7(*kargs, discount=0.98, z=z, **kw)
            assert got[0].shape == (Bs, n)
            _costs_and_actions_close(got, k7.plain(*kargs, discount=0.98, z=z, **kw))
        c4, a4 = k7(*args, a_means, fac, pb, 51, n, draws=draws)
        c1, a1 = k7(*one, a_means[:1], fac[:1], pb1, 51, n, draws=draws[:1])
        assert torch.equal(a1[0], a4[0]) and torch.equal(c1[0], c4[0])


# --- the trace readers on the card (runtime/profiling.py) -----------------------


def _captured(dev, name, rng_mode):
    """A full-width solve (N=8192, H=32) captured as a CUDA graph, its
    graph's nodes and ``step(cp) -> cp`` through the captured call."""
    from covo_mpc_tpu_torch.runtime import graphs, profiling
    from covo_mpc_tpu_torch.solvers import get_solver

    env = QuadEnv(EnvConfig(task="tracking_zigzag", enable_randomizer=False,
                            disturb_type="gaussian", disable_rollover_terminate=True,
                            generate_noisy_state=True), device=dev)
    obs, info, state = env.reset(torch.Generator(dev).manual_seed(0))
    p = env.default_params
    solver, cp = get_solver(env, name, "N8192_H32_lam0.01", rng_mode=rng_mode,
                            hessian_mode="gn", sigma_mode="ns", engine="cuda", collect_debug=False)
    cap = graphs.capture_solver(solver, solver, obs, state, p, cp, info)
    return cap, profiling.graph_nodes(cap), (lambda c: cap(obs, state, p, c, info)[1]), cp


def _chain(step, cp, length):
    def run(i):
        c = cp
        for _ in range(length):
            c = step(c)
        return c
    return run


def _complete_chains(run, iters, nodes, trace_dir, sessions=3, **kw):
    """The chains of the first of ``sessions`` profiler sessions that lost
    no event (a session can lose events on the H100; none complete fails)."""
    from covo_mpc_tpu_torch.runtime import profiling

    lost = []
    for _ in range(sessions):
        try:
            return profiling.trace_chains(run, iters, nodes, trace_dir, **kw)
        except profiling.LostEvents as e:
            lost.append(str(e))
    pytest.fail(f"no complete profiler session of {sessions}: {lost}")


def test_time_trace_reads_the_traced_chains(dev, tmp_path):
    """time_trace on a captured MPPI solve (kernel rng) reads the device
    wall of the chains it traced: within 10% of the host's wall of the same
    chains (each ends in a sync). A session slows the replays (the graph
    launch is instrumented on the host), so both lie above time_chained's
    CUDA-event time of the untraced chains, printed beside."""
    import time

    from covo_mpc_tpu_torch.runtime import profiling

    cap, nodes, step, cp = _captured(dev, "mppi", "kernel")
    host = []

    def make_run(length):
        def run(i):
            t0 = time.perf_counter()
            out = profiling._sync(_chain(step, cp, length)(i))
            host.append((time.perf_counter() - t0) / length)
            return out
        return run

    per = profiling.time_trace(make_run, chain=64, iters=4, trace_dir=str(tmp_path),
                               nodes=nodes)
    traced_host = float(sum(host[1:]) / len(host[1:]))  # host[0] is the warm-up
    ev = profiling.time_chained(step, cp, iters=8, k=64)["p50"]
    print(f"time_trace {per * 1e3:.4f} ms, host {traced_host * 1e3:.4f} ms a replay "
          f"under the profiler; CUDA events {ev * 1e3:.4f} ms untraced")
    assert abs(per - traced_host) <= 0.1 * traced_host, (per, traced_host, ev)
    assert per >= 0.9 * ev


@pytest.mark.parametrize("name, rng_mode, marker", [
    ("covo_online", "kernel", "joint_sample_rollout_kernel"),  # the main path: K1
    ("mppi", "kernel", "sample_rollout_tile_kernel"),  # K5
])
def test_auto_marker_on_the_card(dev, tmp_path, name, rng_mode, marker):
    """per_solve_distribution's auto marker is the largest of the repo's
    kernels that fires once a solve: K1 on the main path (beside K2 and
    K3), K5's tile kernel on MPPI with kernel rng."""
    from covo_mpc_tpu_torch.runtime import profiling

    cap, nodes, step, cp = _captured(dev, name, rng_mode)
    run = _chain(step, cp, 16)
    run(0)
    chains = _complete_chains(run, 2, nodes, str(tmp_path), gap_s=0.025)
    events = [r for c in chains for r in c]
    dist = profiling.per_solve_distribution(events, 32)
    assert kernels.device_kernel(dist["marker"]) == marker
    assert dist["n"] == 30 and 0 < dist["p50"] <= dist["p99"] <= dist["max"]


def test_complete_session_holds_replays_times_nodes(dev, tmp_path):
    """A complete session of 20 replays of a captured MPPI solve: inside
    the chain's range the graph launched 20 times, and its device ops are
    20 x the graph's nodes plus the host's enqueue calls (the copies in and
    out around each replay)."""
    from covo_mpc_tpu_torch.runtime import profiling

    cap, nodes, step, cp = _captured(dev, "mppi", "fast")
    run = _chain(step, cp, 20)
    run(0)
    chains = _complete_chains(run, 1, nodes, str(tmp_path))
    _, host = profiling.load_device_trace(str(tmp_path))
    (a, b), = profiling.chain_windows(host)
    calls = [r for r in host if r["category"] != "user_annotation" and a <= r["ts_us"] <= b]
    assert sum(r["name"].startswith("cudaGraphLaunch") for r in calls) == 20
    enqueued = sum(r["name"].startswith(profiling.ENQUEUE_CALLS) for r in calls)
    assert len(chains[0]) == 20 * nodes + enqueued
    assert sum(kernels.device_kernel(r["name"]) == "rollout_split_kernel"
               for r in chains[0]) == 20


# --- JAX's key tree on the card (utils/prng.py) -------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_prng_on_the_card_equals_the_cpu(dev, seed):
    """Keys, splits, fold_ins, bits and uniforms on the card equal the
    CPU's bit for bit (integer ops, one float64 product and sum rounded
    once); normals within 2 ulp of max(|x|, 1) (the device's log1p)."""
    from covo_mpc_tpu_torch.utils import prng

    cpu, gpu = prng.PRNGKey(seed), prng.PRNGKey(seed, dev)
    assert torch.equal(gpu.cpu(), cpu)
    kc, kg = prng.split(cpu, 1000), prng.split(gpu, 1000)
    assert torch.equal(kg.cpu(), kc)
    assert torch.equal(prng.fold_in(gpu, 7919).cpu(), prng.fold_in(cpu, 7919))
    ids = torch.arange(1000)
    assert torch.equal(prng.fold_in(gpu, ids.to(dev)).cpu(), prng.fold_in(cpu, ids))
    assert torch.equal(prng.random_bits(kg, (5, 3)).cpu(), prng.random_bits(kc, (5, 3)))
    for lo, hi in ((-1.0, 1.0), (-0.2, 0.2), (1.0, 1.5)):
        assert torch.equal(prng.uniform(kg, (33,), lo, hi).cpu(),
                           prng.uniform(kc, (33,), lo, hi))
    zg, zc = prng.normal(kg, (128,)).cpu().double(), prng.normal(kc, (128,)).double()
    ulp = torch.from_numpy(np.spacing(zc.abs().clamp_min(1.0).numpy().astype(np.float32)))
    assert float(((zg - zc).abs() / ulp).max()) <= 2.0


@pytest.mark.parametrize("n", [16, 8192])
@pytest.mark.parametrize("mode", ["parity", "invariant"])
def test_k4_on_key_drawn_samples_matches_plain(dev, n, mode):
    """K4 fed the parity sampler's (N, H, 4) draws (layout nhd) or the
    invariant sampler's (H*4, N) ones (hdn), under a disturbance drawn
    through the reference's key chain, against its plain version: N = 16
    (below one block) and 8192 (the main path's), H=32."""
    from covo_mpc_tpu_torch.ops import sampling
    from covo_mpc_tpu_torch.utils import prng

    Hs = 32
    env, p, st = _env_state(dev)
    g = torch.Generator(dev).manual_seed(9)
    mean = torch.randn(4 * Hs, generator=g, device=dev) * 0.2
    A = torch.randn(4 * Hs, 4 * Hs, generator=g, device=dev) * 0.05
    L = torch.linalg.cholesky(A @ A.T + 0.1 * torch.eye(4 * Hs, device=dev)).contiguous()
    key = prng.PRNGKey(11, dev)
    act_key, step_key = prng.split(key)
    if mode == "parity":
        acts = torch.clamp(sampling.sample_joint(act_key, mean, L, n), -1.0, 1.0)
        acts, layout = acts.reshape(n, Hs, 4), "nhd"
    else:
        acts = torch.clamp(sampling.sample_joint_t(act_key, mean, L, n, mode=mode),
                           -1.0, 1.0)
        layout = "hdn"
    draw = env.disturb_from_key(step_key, fast=mode != "parity")
    args = (pack_state(st), st.time, st.pos_traj, st.vel_traj, acts, p, draw)
    k4 = rollout_cuda.make_rollout_costs(env)
    before = rollout_cuda.ROLLOUT_KERNEL.launches
    c_k = k4(*args, discount=1.0, layout=layout)
    assert rollout_cuda.ROLLOUT_KERNEL.launches == before + 1
    c_p = k4.plain(*args, discount=1.0, layout=layout)
    torch.testing.assert_close(c_k, c_p, atol=2e-4, rtol=1e-5)


# --- the batched twins' kernel paths (K6 on key-drawn samples, K7 joint on the
# offline schedule's gathered factors) and the statistical pin of K1 -------------


@pytest.mark.parametrize("n", [16, 8192])
@pytest.mark.parametrize("mode", ["parity", "invariant"])
def test_k6_on_key_drawn_batched_samples_matches_plain(dev, n, mode):
    """K6 fed the batched parity samples (B, N, H, 4) of each scenario's key
    (layout nhd, as the parity twins lay them out) or the invariant ones (B,
    4H, N) (hdn), each scenario's stochastic draw from its step key through
    the reference's chain, against its plain version: B=4, H=32; one launch."""
    from covo_mpc_tpu_torch.parallel.scenarios import _act_keys
    from covo_mpc_tpu_torch.ops import sampling
    from covo_mpc_tpu_torch.utils import prng

    env, args, pb, g, a_means, _, factors, _ = _small_scenarios(dev, n)
    Bs, D = a_means.shape[0], 4 * HS
    act_key, step_key = _act_keys(prng.split(prng.PRNGKey(13, dev), Bs))
    if mode == "parity":
        z = prng.normal(prng.split(act_key, n), (D,))
        acts = torch.clamp(a_means.reshape(Bs, 1, D) + z @ factors.mT, -1.0, 1.0)
        acts, layout = acts.reshape(Bs, n, HS, 4), "nhd"
    else:
        z = sampling.std_normal_invariant(act_key, n, (D,))
        acts = torch.clamp(sampling.sample_joint_t(None, a_means.reshape(Bs, D), factors,
                                                   n, z=z), -1.0, 1.0)
        layout = "hdn"
    draws = env.disturb_from_key(step_key, fast=mode != "parity")
    k6 = rollout_cuda.make_rollout_batched_costs(env)
    before = rollout_cuda.ROLLOUT_BATCHED_KERNEL.launches
    got = k6(*args, acts, pb, draws, discount=1.0, layout=layout)
    assert rollout_cuda.ROLLOUT_BATCHED_KERNEL.launches == before + 1
    assert got.shape == (Bs, n)
    torch.testing.assert_close(got, k6.plain(*args, acts, pb, draws, discount=1.0,
                                             layout=layout), atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize("n", [100, 8192])
def test_k7_joint_on_the_offline_gather_matches_plain(dev, n):
    """K7 joint on the factors the offline twin gathers, each scenario's
    ``a_factor_offline[time]`` from a (B, T, D, D) schedule at its own time,
    with given normals against its plain version; with in-kernel draws its
    launch equals one on the same factors copied out scenario by scenario,
    bit for bit (the gather hands the kernel row-major factors)."""
    env, args, pb, g, a_means, _, _, draws = _small_scenarios(dev, n)
    Bs, D, T = a_means.shape[0], 4 * HS, 7
    table = torch.randn(Bs, T, D, D, generator=g, device=dev) * 0.1
    times = torch.tensor([0, 6, 3, 3], device=dev)[:Bs]
    fac = table[torch.arange(Bs, device=dev), times]
    k7 = rollout_cuda.make_rollout_batched_sampling(env, joint=True)
    z = torch.randn(Bs, D, n, generator=g, device=dev)
    for kw in (dict(deterministic=True), dict(draws=draws)):
        got = k7(*args, a_means, fac, pb, 0, n, discount=1.0, z=z, **kw)
        _costs_and_actions_close(got, k7.plain(*args, a_means, fac, pb, 0, n,
                                               discount=1.0, z=z, **kw))
    copied = torch.stack([table[b, int(times[b])].clone() for b in range(Bs)])
    c1, a1 = k7(*args, a_means, fac, pb, 17, n, deterministic=True)
    c2, a2 = k7(*args, a_means, copied, pb, 17, n, deterministic=True)
    assert torch.equal(c1, c2) and torch.equal(a1, a2)


def test_k1_solve_agrees_with_the_fast_sampler_statistically(dev):
    """CoVO online with in-kernel draws (K1, Philox) cannot reproduce the
    fast sampler's torch.randn stream, so its solve is pinned against the
    fast one (K4) statistically (``utils/stats.py``, JAX's
    tests/test_sharding.py:776-782): the mean of S=6 K1 solves' new means,
    each from its own seed, within z=5 of their own spread of one fast
    solve at the same state (N=8192, H=8, gn, ns)."""
    from covo_mpc_tpu_torch.solvers import get_solver
    from covo_mpc_tpu_torch.utils.stats import assert_sampled_mean_agreement

    env, p, st = _env_state(dev)
    kw = dict(hessian_mode="gn", sigma_mode="ns", engine="cuda", collect_debug=False)
    fast, cp = get_solver(env, "covo_online", "N8192_H8_lam0.01", rng_mode="fast", seed=3,
                          **kw)
    ref = fast(None, st, p, cp, None)[1].a_mean
    samples = []
    for seed in range(6):
        k1, cp = get_solver(env, "covo_online", "N8192_H8_lam0.01", rng_mode="kernel",
                            seed=seed, **kw)
        before = rollout_cuda.JOINT_KERNEL.launches
        samples.append(k1(None, st, p, cp, None)[1].a_mean.cpu())
        assert rollout_cuda.JOINT_KERNEL.launches == before + 1
    assert_sampled_mean_agreement(samples, ref.cpu(), what="K1 against the fast sampler")


# --- the parallel layer: the kernels at one rank's share of N, one NCCL rank ----

SHARD_NS = [8192 // 2, 8192 // 4]  # n_local of the main path's N over 2 and 4 ranks


@pytest.mark.parametrize("n", SHARD_NS)
def test_per_shard_kernels_match_plain(dev, n):
    """What each rank of a sharded solve launches at its share of N=8192
    (H=32): K1, K4 and K5 with given normals against their plain versions,
    K6 and both K7 forms at B=4 the same way, deterministic and under the
    shared draw; with in-kernel draws each at n_local equals the first
    n_local samples of a launch at N (the sample index is in the Philox
    counter)."""
    env, p, st = _env_state(dev)
    roll = (pack_state(st), st.time, st.pos_traj, st.vel_traj)
    g, a_mean, factor, chol, draw = _small_inputs(dev, n)
    k1, k4 = rollout_cuda.make_rollout_joint_sampling(env), rollout_cuda.make_rollout_costs(env)
    k5 = rollout_cuda.make_rollout_sampling(env)
    acts = torch.randn(HS, 4, n, generator=g, device=dev) * 0.5
    for kw in (dict(deterministic=True), dict(draw=draw)):
        z = torch.randn(4 * HS, n, generator=g, device=dev)
        _costs_and_actions_close(k1(*roll, a_mean, factor, p, 0, n, z=z, **kw),
                                 k1.plain(*roll, a_mean, factor, p, 0, n, z=z, **kw))
        torch.testing.assert_close(k4(*roll, acts, p, layout="hdn", **kw),
                                   k4.plain(*roll, acts, p, layout="hdn", **kw),
                                   atol=2e-4, rtol=1e-5)
        z = torch.randn(HS, 4, n, generator=g, device=dev)
        _costs_and_actions_close(k5(*roll, a_mean, chol, p, 0, n, z=z, **kw),
                                 k5.plain(*roll, a_mean, chol, p, 0, n, z=z, **kw))
    for k, fac in ((k1, factor), (k5, chol)):
        c_n, a_n = k(*roll, a_mean, fac, p, 77, n, draw=draw)
        c_f, a_f = k(*roll, a_mean, fac, p, 77, 8192, draw=draw)
        assert torch.equal(a_n, a_f[:, :n]) and torch.equal(c_n, c_f[:n])
    env_b, args, pb, g, a_means, chols, factors, draws = _small_scenarios(dev, n)
    Bs = a_means.shape[0]
    k6 = rollout_cuda.make_rollout_batched_costs(env_b)
    acts = torch.randn(Bs, HS, 4, n, generator=g, device=dev) * 0.5
    torch.testing.assert_close(k6(*args, acts, pb, draws), k6.plain(*args, acts, pb, draws),
                               atol=2e-4, rtol=1e-5)
    for joint, fac, shape in ((False, chols, (Bs, HS, 4, n)), (True, factors, (Bs, 4 * HS, n))):
        k7 = rollout_cuda.make_rollout_batched_sampling(env_b, joint=joint)
        z = torch.randn(*shape, generator=g, device=dev)
        kargs = (*args, a_means, fac, pb, 0, n)
        _costs_and_actions_close(k7(*kargs, draws=draws, z=z),
                                 k7.plain(*kargs, draws=draws, z=z))
        c_n, a_n = k7(*args, a_means, fac, pb, 61, n, draws=draws, offset=2)
        c_f, a_f = k7(*args, a_means, fac, pb, 61, 8192, draws=draws, offset=2)
        assert torch.equal(a_n, a_f[..., :n]) and torch.equal(c_n, c_f[:, :n])


@pytest.fixture
def nccl_rank(dev):
    """A process group of one rank under NCCL on the card (torn down after)."""
    import torch.distributed as dist

    from covo_mpc_tpu_torch.parallel.distributed import free_port

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    yield dev
    dist.destroy_process_group()


@pytest.mark.parametrize("rng", ["invariant", "kernel"])
def test_one_rank_nccl_sharded_solves_match_single_eager_and_captured(nccl_rank, rng):
    """On a one-rank NCCL mesh (its collectives real all-reduces) the
    distributed CoVO solve (gn) and the sharded MPPI solve at N=8192, H=8
    equal the single-device solvers on the same key or seed (1e-5 under
    invariant rng, 2e-4 under kernel rng), and a captured replay equals
    the eager solve bit for bit."""
    from covo_mpc_tpu_torch.parallel import (
        make_distributed_covo_solve,
        make_mesh,
        make_sharded_mppi_solve,
    )
    from covo_mpc_tpu_torch.parallel.sharded import act_step_keys
    from covo_mpc_tpu_torch.solvers import get_solver
    from covo_mpc_tpu_torch.utils import prng

    dev = nccl_rank
    env, p, st = _env_state(dev)
    mesh = make_mesh(1, device=dev)
    assert mesh.backend == "nccl"
    x = (pack_state(st), st.time, st.pos_traj, st.vel_traj)
    key = prng.PRNGKey(21, device=dev)
    tol = 1e-5 if rng == "invariant" else 2e-4
    kw = dict(hessian_mode="gn", sigma_mode="ns", engine="cuda", collect_debug=False)
    covo, cp = get_solver(env, "covo_online", "N8192_H8_lam0.01", rng_mode=rng, seed=4, **kw)
    ref = covo(None, st, p, cp, None, **({"key": key} if rng == "invariant" else {}))[1]
    outs = [make_distributed_covo_solve(env, mesh, 8192, 8, 0.01, sample_sigma=cp.sample_sigma,
                                        rng=rng, hessian_mode="gn", seed=4, capture=c)(
        *x, cp.a_mean, p, key) for c in (False, True)]
    torch.testing.assert_close(outs[0][0], ref.a_mean, atol=tol, rtol=0)
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    mppi, mp = get_solver(env, "mppi", "N8192_H8_lam0.01", rng_mode=rng, seed=4,
                          engine="cuda", collect_debug=False)
    act_key, step_key = act_step_keys(key)
    draw = env.disturb_from_key(step_key, fast=True)
    ref = mppi(None, st, p, mp, None, **({"key": key} if rng == "invariant"
                                          else {"draw": draw}))[1]
    outs = [make_sharded_mppi_solve(env, mesh, 8192, 8, 0.01, rng=rng, seed=4, capture=c)(
        *x, mp.a_mean, mp.a_cov, mp.gamma_mean, mp.gamma_sigma, mp.discount, p, act_key,
        step_key) for c in (False, True)]
    torch.testing.assert_close(outs[0][0], ref.a_mean, atol=tol, rtol=0)
    assert all(torch.equal(a, b) for a, b in zip(*outs))
