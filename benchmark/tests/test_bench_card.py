"""On the card, at a size a test run holds (N = 1024, fleets of 8): each
cell's run, past the harness's look for a chip, is judged correct, its
control (the reference one precision down in the program's place) is not,
and nor is the run with the timed path broken underneath it: a step that
returns its state unchanged, half the samples left out of the weighted
mean, an answer altered where it is made, an episode that does not
restart at its end."""

import contextlib
import gc

import pytest
import torch

from benchmark import check, harness, system, window

CELLS = ["covo.vehicle", "mppi.fleet", "covo.fleet"]
SEED = 2147483777
ALTERED = 0.5


def _small(cell):
    spec = harness.cell_spec(cell)
    cfg = dict(spec["config"], controller=dict(spec["config"]["controller"], N=1024))
    traffic = dict(spec["traffic"], vehicles=min(int(spec["traffic"]["vehicles"]), 8),
                   check_within=6, check_steps=2, warmup_steps=2)
    return cfg, traffic, spec["limits"]


def _records(cfg, traffic):
    sut = system.build(cfg, traffic, SEED)
    for _ in range(int(traffic["warmup_steps"])):
        sut.step()
    w = window.run(sut, 0.2, harness.check_steps(SEED, traffic, sut.to_restart()))
    window.catch_up(sut, w)
    del sut
    gc.collect()
    return w["records"]


@contextlib.contextmanager
def _fault(kind):
    from covo_mpc_tpu_torch.models import batched, quad_env
    from covo_mpc_tpu_torch.models.batched import BatchedEnv
    from covo_mpc_tpu_torch.models.quad_env import QuadEnv
    from covo_mpc_tpu_torch.ops import reductions

    saved = []

    def patch(obj, name, new):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    if kind == "state_unchanged":
        for cls in (QuadEnv, BatchedEnv):
            def step(self, src, state, action, params=None, _orig=cls.step):
                obs, _, reward, done, info = _orig(self, src, state, action, params)
                return obs, state, reward, done, info
            patch(cls, "step", step)
    elif kind == "half_the_samples":
        orig = reductions.mppi_weights

        def weights(costs, lam, axis=None):
            w = orig(costs[..., :costs.shape[-1] // 2], lam, axis)
            return torch.cat([w, torch.zeros_like(w)], -1)
        patch(reductions, "mppi_weights", weights)
    elif kind == "answer_altered":
        # a quarter of the action range: 2.5 times the least that the CoVO
        # fleet's mean_gap can see (its limit of 2,000 in units of its 1e-4
        # floor); sound runs of the program's float32 design have moved a
        # fleet's mean by up to 1.8e-2, so a smaller alteration can read as
        # a sound run
        orig = reductions.mean_update_t
        patch(reductions, "mean_update_t", lambda *a, **k: orig(*a, **k) + ALTERED)
    elif kind == "restart_skipped":
        # the auto-reset select keeps the stepped state past the episode's end
        for mod in (quad_env, batched):
            patch(mod, "tree_select", lambda cond, a, b: b)
    try:
        yield
    finally:
        for obj, name, old in reversed(saved):
            setattr(obj, name, old)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_control_fails(dev, cell):
    cfg, traffic, limits = _small(cell)
    records = _records(cfg, traffic)
    good = check.judge(cfg, records, limits)
    assert good["correct"], good
    control = check.judge(cfg, records, limits, control=True)
    assert not control["correct"], control


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["state_unchanged", "half_the_samples", "answer_altered",
                                  "restart_skipped"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_step_is_not_correct(dev, cell, kind):
    cfg, traffic, limits = _small(cell)
    with _fault(kind):
        records = _records(cfg, traffic)
    verdict = check.judge(cfg, records, limits)
    assert not verdict["correct"], verdict
