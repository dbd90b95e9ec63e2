"""The port's two-stage speculative pipeline (``parallel/pipeline.py``)
against the JAX package and a stage-sequential oracle.

Two steps of the pipeline over pipe=2 ranks and over (pipe=2, samples=2)
ranks (processes on the CPU under gloo, ``parallel.run_ranks``), each
started from ``make_init_factor``'s cold-start factor, against JAX's
pipeline on two of its virtual devices (compiled once; the invariant
sampler makes the (2, 2) mesh's result the two-rank one, as JAX's own test
holds), and against an oracle that runs the act and design stages one
after the other from the port's building blocks. Sizes are JAX's tests'
(N=64, H=4, the ``tracking`` env, randomizer off), the Gauss–Newton
Hessian. Tolerances 1e-5 on the mean and the min cost, 1e-4 on the factor
(JAX's own).
"""

import numpy as np
import pytest
import torch

from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv
from covo_mpc_tpu_torch.models.structs import pack_state, params_from_numpy, state_from_numpy
from covo_mpc_tpu_torch.ops import covariance, reductions, sampling
from covo_mpc_tpu_torch.ops.hessian import make_hessian_adjoint
from covo_mpc_tpu_torch.ops.rollout import hessian_draws_from_key, make_rollout
from covo_mpc_tpu_torch.parallel import (
    PIPE_AXIS,
    Mesh,
    make_init_factor,
    make_pipeline_mesh,
    make_pipeline_step,
    run_ranks,
)
from covo_mpc_tpu_torch.parallel.pipeline import predict_next_state
from covo_mpc_tpu_torch.utils import prng

N, H, LAM, SIGMA = 64, 4, 0.01, 0.5
STEPS = 2
MODE = "gn"
ENV_KW = dict(task="tracking", enable_randomizer=False, disturb_type="gaussian",
              disable_rollover_terminate=True, generate_noisy_state=True)


def _env() -> QuadEnv:
    return QuadEnv(EnvConfig(**ENV_KW), device="cpu")


def _jax_side():
    """JAX's inputs as numpy, and its pipeline's STEPS steps from the cold
    start on two devices (one compile)."""
    import dataclasses

    import jax

    from covo_mpc_tpu.models import EnvConfig as JEnvConfig
    from covo_mpc_tpu.models import QuadEnv as JQuadEnv
    from covo_mpc_tpu.models import pack_state as jpack
    from covo_mpc_tpu.parallel import make_init_factor as j_init
    from covo_mpc_tpu.parallel import make_pipeline_mesh as j_mesh
    from covo_mpc_tpu.parallel import make_pipeline_step as j_step
    from covo_mpc_tpu.solvers import hover_sequence as j_hover

    env = JQuadEnv(JEnvConfig(**ENV_KW))
    p = env.default_params
    s = jax.jit(lambda k: env.reset_env(k, p)[2])(jax.random.PRNGKey(0))
    args = (jpack(s), s.time, s.pos_traj, s.vel_traj)
    key0, key1 = jax.random.split(jax.random.PRNGKey(3))
    keys = [jax.random.fold_in(key1, t) for t in range(STEPS)]
    factor = j_init(env, H, SIGMA, hessian_mode=MODE)(*args, j_hover(env, H), p, key0)
    step = jax.jit(j_step(env, j_mesh(jax.devices()[:2]), N=N, H=H, lam=LAM,
                          sample_sigma=SIGMA, hessian_mode=MODE))
    a, f, outs = j_hover(env, H), factor, []
    for t in range(STEPS):
        a, f, mc = step(*args, a, f, p, keys[t])
        outs.append((np.asarray(a), np.asarray(f), np.asarray(mc)))

    def tree(x):
        return {fl.name: np.asarray(getattr(x, fl.name)) for fl in dataclasses.fields(x)
                if getattr(x, fl.name) is not None}

    def words(k):
        return np.asarray(k).astype(np.int64)

    inp = dict(state=tree(s), params=tree(p), a_mean=np.asarray(j_hover(env, H)),
               key0=words(key0), keys=[words(k) for k in keys])
    return inp, dict(factor0=np.asarray(factor), steps=outs)


def _inputs(inp):
    s = state_from_numpy(inp["state"], device="cpu")
    return ((pack_state(s), s.time, s.pos_traj, s.vel_traj),
            params_from_numpy(inp["params"], device="cpu"), torch.from_numpy(inp["a_mean"]))


def _cold_start(inp):
    args, p, a_mean = _inputs(inp)
    return make_init_factor(_env(), H, SIGMA, hessian_mode=MODE)(
        *args, a_mean, p, torch.from_numpy(inp["key0"]))


def _run(rank: int, samples: int, inp: dict):
    """STEPS pipeline steps on this rank of the (pipe=2, samples) mesh;
    and, on the (2, 2) mesh, the indivisible-N error."""
    env, (args, p, a) = _env(), _inputs(inp)
    mesh = make_pipeline_mesh(samples=samples)
    step = make_pipeline_step(env, mesh, N, H, LAM, sample_sigma=SIGMA, hessian_mode=MODE)
    f, outs = _cold_start(inp), []
    for t in range(STEPS):
        a, f, mc = step(*args, a, f, p, torch.from_numpy(inp["keys"][t]))
        outs.append((a.numpy(), f.numpy(), mc.numpy()))
    err = None
    if samples == 2:
        with pytest.raises(ValueError, match="not divisible") as e:
            make_pipeline_step(env, mesh, N - 1, H, LAM)
        err = str(e.value)
    return dict(coords=mesh.coords, steps=outs, error=err)


def _oracle_step(env, args, p, a_mean, factor, key):
    """The pipeline step's semantics with the stages one after the other,
    from the port's building blocks: act with LAST step's factor; design at
    the state one deterministic model step along the PRE-update shifted
    mean."""
    x0, t0, pos_traj, vel_traj = args
    mean = torch.cat([a_mean[1:], a_mean[-1:]])
    k_act, k_step, k_prep = prng.split(key, 3).unbind(-2)
    a = torch.clamp(sampling.sample_joint(k_act, mean.reshape(-1), factor, N,
                                          mode=sampling.INVARIANT), -1.0, 1.0)
    costs = make_rollout(env)(x0, t0, pos_traj, vel_traj, a.reshape(N, H, 4), p,
                              env.disturb_from_key(k_step, deterministic=True, fast=True),
                              deterministic=True)
    w = reductions.mppi_weights(costs, LAM)
    a_new = torch.einsum("n,nhd->hd", w, a.reshape(N, H, 4))
    x1 = predict_next_state(env, x0, t0, mean, p, k_prep)
    nominal = torch.cat([mean[1:], mean[-1:]])
    R = make_hessian_adjoint(env, H, second_order=MODE == "adjoint")(
        nominal.reshape(-1), x1, t0 + 1, pos_traj, vel_traj, p,
        hessian_draws_from_key(env, k_prep, H))
    return a_new, covariance.optimize_sigma_ns(R, SIGMA, 4 * H)[1], costs.min()


@pytest.fixture(scope="module")
def runs():
    import concurrent.futures

    inp, ref = _jax_side()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        launches = pool.submit(lambda: {k: run_ranks(_run, 2 * k, k, inp, timeout_s=240)
                                        for k in (1, 2)})
        env, (args, p, a) = _env(), _inputs(inp)
        f, oracle = _cold_start(inp), []
        for t in range(STEPS):
            a, f, mc = _oracle_step(env, args, p, a, f, torch.from_numpy(inp["keys"][t]))
            oracle.append((a.numpy(), f.numpy(), mc.numpy()))
        return dict(ref=ref, oracle=oracle, factor0=_cold_start(inp).numpy(),
                    ranks=launches.result())


def _close_steps(got, ref, what):
    for t, ((a, f, mc), (ra, rf, rmc)) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(a, ra, rtol=0, atol=1e-5, err_msg=f"{what} step {t} mean")
        np.testing.assert_allclose(mc, rmc, rtol=0, atol=1e-5, err_msg=f"{what} min cost")
        np.testing.assert_allclose(f, rf, rtol=0, atol=1e-4, err_msg=f"{what} factor")


def test_init_factor_matches_jax(runs):
    np.testing.assert_allclose(runs["factor0"], runs["ref"]["factor0"], atol=1e-5)


@pytest.mark.parametrize("samples", [1, 2])
def test_pipeline_step_matches_jax_on_every_rank(runs, samples):
    """Two steps over (pipe=2[, samples=2]) ranks, the cold start from
    make_init_factor: every rank returns JAX's two-device pipeline's mean,
    factor and min cost; rank r sits at row r // samples."""
    for rank, out in enumerate(runs["ranks"][samples]):
        want = {PIPE_AXIS: rank // samples}
        if samples > 1:
            want["samples"] = rank % samples
        assert out["coords"] == want
        _close_steps(out["steps"], runs["ref"]["steps"], f"samples={samples} rank {rank}")


def test_pipeline_step_matches_the_stage_sequential_oracle(runs):
    _close_steps(runs["ranks"][1][0]["steps"], runs["oracle"], "oracle")
    _close_steps(runs["oracle"], runs["ref"]["steps"], "oracle vs JAX")


def test_pipeline_rejects_a_pipe_axis_of_other_than_two_and_indivisible_n(runs):
    env = _env()
    with pytest.raises(ValueError, match="two stages"):
        make_pipeline_step(env, Mesh((PIPE_AXIS,), (1,)), N, H, LAM)
    with pytest.raises(ValueError, match="two stages"):
        make_pipeline_step(env, Mesh(("samples",), (1,)), N, H, LAM)
    with pytest.raises(ValueError, match="initialize a process group"):
        make_pipeline_mesh()
    for out in runs["ranks"][2]:
        assert out["error"] == f"N={N - 1} not divisible by 2 shards"
