"""Multi-process runs of the port through the launcher contract
(``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``,
``parallel.initialize_distributed``), mirroring ``tests/test_multiprocess.py``.

2 and 4 real processes on localhost under gloo, rendezvous at a TCP port
the OS handed out just before the launch. Each runs (a) one distributed
CoVO solve with the sample axis across the processes and (b) one
multichip CoVO step on a (samples=2, scenarios=k/2) mesh with B=8
scenarios, the scenario axis across processes in the 4-process layout.
The invariant sampler makes both the one-process result exactly up to the
summation order of the collectives, so every process's result is held to
this process's own run with no process group (1e-5), and every process to
the others bit for bit. One process is a no-op returning 0.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from covo_mpc_tpu_torch.models import EnvConfig, QuadEnv
from covo_mpc_tpu_torch.models.structs import pack_state, stack, stack_params
from covo_mpc_tpu_torch.parallel import (
    SCENARIO_AXIS,
    device_topology,
    initialize_distributed,
    make_distributed_covo_solve,
    make_mesh,
    make_multichip_covo_step,
    run_ranks,
)
from covo_mpc_tpu_torch.parallel.distributed import free_port
from covo_mpc_tpu_torch.utils import prng

N, H, LAM = 64, 4, 0.01
B, NS = 8, 16


def _env(randomize: bool) -> QuadEnv:
    return QuadEnv(EnvConfig(task="tracking", enable_randomizer=randomize,
                             disturb_type="gaussian", disable_rollover_terminate=True,
                             generate_noisy_state=True), device="cpu")


def _programs(samples: int, scenarios: int) -> dict:
    """The two programs of JAX's multi-process test on this rank: the
    distributed solve from the noisy reset state on key 42's reset, and a
    multichip CoVO step of B randomized scenarios (each reset and params
    from its own key), gathered over the scenario axis."""
    env = _env(False)
    _, info, _ = env.reset(prng.PRNGKey(42))
    noisy = info["noisy_state"]
    solve = make_distributed_covo_solve(env, make_mesh(samples=samples * scenarios), N, H,
                                        LAM, hessian_mode="gn")
    a_new, min_cost = solve(pack_state(noisy), noisy.time, noisy.pos_traj, noisy.vel_traj,
                            torch.zeros(H, 4), env.default_params, prng.PRNGKey(3))
    env_dr = _env(True)
    keys = prng.split(prng.PRNGKey(7), B)
    params = [env_dr.sample_params(keys[b]) for b in range(B)]
    params_b = stack_params(params)
    states = stack([env_dr.reset(keys[b], params[b])[2] for b in range(B)])
    mesh = make_mesh(samples=samples, scenarios=scenarios)
    step = make_multichip_covo_step(env_dr, mesh, NS, H, LAM, hessian_mode="gn")
    _, a_means, rewards, _ = step(mesh.shard(states, SCENARIO_AXIS),
                                  mesh.shard(params_b, SCENARIO_AXIS),
                                  torch.zeros(B // scenarios, H, 4),
                                  mesh.shard(keys, SCENARIO_AXIS))
    out = mesh.gather(dict(a_means=a_means, rewards=rewards), SCENARIO_AXIS)
    return dict(a_mean=a_new.numpy(), min_cost=float(min_cost),
                scenario_a_means=out["a_means"].numpy(), rewards=out["rewards"].numpy())


def _worker(rank: int, world: int) -> dict:
    """A process of the job: the contract's variables, the topology, and
    both programs on the (samples=2, scenarios=world/2) layout."""
    rec = {k: os.environ[k] for k in ("NUM_PROCESSES", "PROCESS_ID")}
    rec.update(device_topology())
    rec["rank"] = dist.get_rank()
    rec.update(_programs(2, world // 2))
    return rec


@pytest.fixture(scope="module")
def single():
    """Both programs in this process, with no process group."""
    return _programs(1, 1)


@pytest.mark.parametrize("n_procs", [2, 4])
def test_multiprocess_runs_match_the_single_process(single, n_procs):
    outs = run_ranks(_worker, n_procs, n_procs, timeout_s=240,
                     address=f"127.0.0.1:{free_port()}")
    assert [o["rank"] for o in outs] == list(range(n_procs))
    for rank, rec in enumerate(outs):
        assert rec["NUM_PROCESSES"] == str(n_procs) and rec["PROCESS_ID"] == str(rank)
        assert rec["process_index"] == rank and rec["process_count"] == n_procs
        assert rec["global_devices"] == n_procs and rec["local_devices"] == 1
        assert rec["backend"] == "gloo" and rec["device_kind"] == "cpu"
        for k in ("a_mean", "scenario_a_means", "rewards"):
            np.testing.assert_allclose(rec[k], single[k], rtol=0, atol=1e-5,
                                       err_msg=f"{n_procs} processes, rank {rank}: {k}")
            np.testing.assert_array_equal(rec[k], outs[0][k])
        assert rec["min_cost"] == pytest.approx(single["min_cost"], abs=1e-5)
    assert np.abs(single["scenario_a_means"]).max() > 0.0


def test_one_process_is_a_no_op(monkeypatch):
    monkeypatch.delenv("NUM_PROCESSES", raising=False)
    assert initialize_distributed() == 0
    assert initialize_distributed(num_processes=1) == 0
    assert not dist.is_initialized()
    topo = device_topology()
    assert topo["process_count"] == 1 and topo["global_devices"] == 1
    assert topo["process_index"] == 0 and topo["backend"] is None


def test_initialize_requires_an_explicit_backend():
    with pytest.raises(ValueError, match="backend must be one of"):
        initialize_distributed("127.0.0.1:1", num_processes=2, process_id=0)
