"""Wrappers of the rollout kernels: joint sample + rollout (K1), primal
(K2), rollout costs of given actions (K4), per-step sample + rollout (K5),
and the scenario-batched rollout costs (K6) and sample + rollout (K7,
per-step and joint).

Counterpart of :mod:`covo_mpc_tpu.ops.rollout_pallas`: the host-side
packing (:func:`build_kernel_disturb`, :func:`_pack_kernel_inputs`, for
one scenario or B at once) as torch ops, and one wrapper per kernel with
its plain PyTorch version beside it.

A wrapper takes the plain version only when its tensors lie on the CPU
(as JAX's ``interpret`` mode does off-TPU); on CUDA tensors it launches
the kernel (``csrc/joint_sample_rollout.cu``, ``csrc/primal.cu``,
``csrc/rollout.cu``, ``csrc/sample_rollout.cu``; K6 and K7 are the batched
entry points of the K4, K5 and K1 sources) or raises.

K1 and K7 joint are one kernel (``csrc/joint_sample_rollout.cu``) in three
phases: a block of S samples (``block``, one of :data:`JOINT_BLOCKS`, 64
by default) draws its z with all its threads into shared memory, runs the
correlate a = clip(mean + F z) as a register-tiled fp32 product (each
action one FMA chain over d in order, so its bits do not depend on S), and
then one thread a sample runs the rollout. It takes D = 4H up to
:data:`JOINT_MAX_D`; the wrappers raise on anything else before a launch.
``covo_mpc_tpu_torch/tools/joint_rollout_variants.py`` times its variants
and ablations on the card.

K5 and K7 per-step are one source (``csrc/sample_rollout.cu``) whose launch
picks one of two kernels by the grid, with the same results bit for bit
and S samples a block (``block``, one of :data:`SAMPLE_BLOCKS`,
:data:`SAMPLE_BLOCK` by default). When the grid has no more blocks than
the card has SMs (K5 at N = 8192), the tile kernel: 512 threads a block
draw the whole horizon's z and form a_h = clip(mean_h + L_h z_h) into an
action tile in shared memory, then S threads roll out while the others
store the tile. Otherwise (K7 at B >= 2) the step kernel: one thread a
sample draws (one step ahead), stores and rolls out step by step.
``covo_mpc_tpu_torch/tools/sample_rollout_variants.py`` times their
variants and ablations on the card.

K4 and K6 are one source (``csrc/rollout.cu``) whose launch picks one of
two kernels by the grid, with the same results bit for bit and S samples a
block (``block``, one of :data:`ROLLOUT_BLOCKS`, :data:`ROLLOUT_BLOCK` by
default). When the grid has no more blocks than the card has SMs (K4 at
N = 8192), the split kernel: each 32 samples' step is spread over four
warps (attitude, translation, two for the reward and the cost) that pass
the states through a ring in shared memory. Otherwise (K6 at B >= 2) the
step kernel: one thread a sample. Both pin every operation of the step to
the one-thread kernel they replaced, so its costs are kept bit for bit.
``covo_mpc_tpu_torch/tools/rollout_variants.py`` times their variants and
ablations on the card beside that kernel (``tools/earlier/rollout.cu``).

Every rollout kernel runs the four disturbance modes of JAX's
``_disturb_mode``, a launch argument: "shared" (gaussian / none: x0's own
force at step 0, the one shared force after), "table" (sin / periodic: the
force of each step read from the (3H) ``dist`` operand), "drag" and "mixed"
(the force carried per sample and updated in-kernel from the pre-step
velocity; "mixed" reads the sin values from ``dist`` and its periodic draw
from the scalar pack). K5 alone also draws the shared gaussian force itself
("krng"). The reward is a second launch argument, the env's ``reward_name``
(:data:`REWARDS`): penyaw (the zigzag, Lissajous and hover tasks) or
realworld (``tracking_slow``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from covo_mpc_tpu_torch.models import dynamics
from covo_mpc_tpu_torch.models.quad_env import QuadEnv
from covo_mpc_tpu_torch.ops import kernels, sampling
from covo_mpc_tpu_torch.ops.rollout import (
    check_draw,
    disturb_table,
    make_rollout,
    make_rollout_batched,
    sin_table,
    target_window,
)

JOINT_KERNEL = kernels.Kernel(
    "joint_sample_rollout", "covo_mpc_tpu_torch/csrc/joint_sample_rollout.cu",
    replaces="covo_mpc_tpu/ops/rollout_pallas.py:801",
)
PRIMAL_KERNEL = kernels.Kernel(
    "primal", "covo_mpc_tpu_torch/csrc/primal.cu",
    replaces="covo_mpc_tpu/ops/rollout_pallas.py:1161",
)
ROLLOUT_KERNEL = kernels.Kernel(
    "rollout_costs", "covo_mpc_tpu_torch/csrc/rollout.cu",
    replaces="covo_mpc_tpu/ops/rollout_pallas.py:587",
)
SAMPLE_KERNEL = kernels.Kernel(
    "sample_rollout", "covo_mpc_tpu_torch/csrc/sample_rollout.cu",
    replaces="covo_mpc_tpu/ops/rollout_pallas.py:686",
)
ROLLOUT_BATCHED_KERNEL = kernels.Kernel(
    "rollout_costs_batched", "covo_mpc_tpu_torch/csrc/rollout.cu",
    replaces="covo_mpc_tpu/ops/rollout_pallas.py:903",
)
SAMPLE_BATCHED_KERNEL = kernels.Kernel(
    "sample_rollout_batched", "covo_mpc_tpu_torch/csrc/sample_rollout.cu",
    replaces="covo_mpc_tpu/ops/rollout_pallas.py:1005",
)
JOINT_BATCHED_KERNEL = kernels.Kernel(
    "joint_sample_rollout_batched",
    "covo_mpc_tpu_torch/csrc/joint_sample_rollout.cu",
    replaces="covo_mpc_tpu/ops/rollout_pallas.py:1005",
)

# samples of a block of the joint sample + rollout kernel (K1, K7 joint):
# the sizes it takes, and the default (tools/joint_rollout_variants.py);
# it takes D = 4H up to JOINT_MAX_D
JOINT_BLOCKS = (64, 128)
JOINT_BLOCK = 64
JOINT_MAX_D = 128
# samples of a block of the per-step sample + rollout kernel (K5, K7
# per-step): the sizes it takes, and the default
# (tools/sample_rollout_variants.py)
SAMPLE_BLOCKS = (32, 64, 128)
SAMPLE_BLOCK = 64
# samples of a block of the rollout-costs kernels (K4, K6): the sizes they
# take, and the default (tools/rollout_variants.py)
ROLLOUT_BLOCKS = (32, 64, 128)
ROLLOUT_BLOCK = 64

NSCAL = 17  # scalar pack, layout quad::Scal in csrc/quad_core.cuh
NINT = 3  # [t0, max_steps, disturb_period]
# the disturbance modes' launch argument (quad::Mode in csrc/quad_core.cuh);
# "krng" is the shared mode with K5's in-kernel draw
MODES = {"shared": 0, "krng": 0, "table": 1, "drag": 2, "mixed": 3}
# the rewards' launch argument (quad::Reward in csrc/quad_core.cuh)
REWARDS = {"penyaw": 0, "realworld": 1}


def _full(value, device) -> torch.Tensor:
    # a fill kernel, not a host-to-device copy (which would sync)
    return torch.full((), value, dtype=torch.float32, device=device)


Seed = Union[int, torch.Tensor]


def seed_word(seed: Seed, device) -> torch.Tensor:
    """The Philox key a sampling kernel reads, as a 0-d int64 device word:
    a solver's word (:class:`~covo_mpc_tpu_torch.ops.sampling.SeedStream`)
    as it is, an int by a fill kernel (no host-to-device copy)."""
    if isinstance(seed, torch.Tensor):
        kernels.check_cuda("seed", seed, (), torch.int64, device=device)
        return seed
    return torch.full((), sampling.as_int64(seed), dtype=torch.int64, device=device)


def seed_value(seed: Seed) -> int:
    """The key as the uint64 that seeds a plain version's generator (a CPU
    word is read on the host)."""
    return int(seed) & ((1 << 64) - 1)


def _seed_generator(seed: Seed, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_value(seed))


Offset = Union[int, torch.Tensor, None]


def offset_word(offset: Offset, device) -> Optional[torch.Tensor]:
    """K7's episode offset as the 0-d int32 device word its kernels read
    (None: no word, the kernels take 0): a caller's word as it is (a CUDA
    graph's buffer, rewritten for each chunk), an int by a fill kernel."""
    if offset is None or isinstance(offset, torch.Tensor):
        if offset is not None:
            kernels.check_cuda("offset", offset, (), torch.int32, device=device)
        return offset
    return torch.full((), int(offset), dtype=torch.int32, device=device)


def _scenario_normals(seed: Seed, offset: Offset, shape, B: int, device) -> torch.Tensor:
    """The plain K7 versions' normals (B, *shape): scenario b from its own
    generator, seeded with the key plus (offset + b) times splitmix64's
    increment (mod 2^64), so scenario 0 at offset 0 draws what the plain K1
    / K5 draw from ``seed``, and scenario b at offset o what scenario o + b
    draws at offset 0 (an offset word on the CPU is read on the host)."""
    o = 0 if offset is None else int(offset)
    key = seed_value(seed)
    return torch.stack([
        torch.randn(*shape, device=device, generator=_seed_generator(
            (key + (o + b) * sampling.GOLDEN) & ((1 << 64) - 1), device))
        for b in range(B)])


def _dyn_scalars(env: QuadEnv, params, device):
    """The first nine scalar-pack entries: the physics constants."""
    return [params.m, params.g, _full(env._dt, device), params.alpha_bodyrate,
            params.action_scale, params.max_thrust, params.max_omega[..., 0],
            params.max_omega[..., 1], params.max_omega[..., 2]]


def disturb_mode(env: QuadEnv, kernel_draw: bool = False) -> str:
    """The kernels' disturbance mode for ``env`` (JAX: _disturb_mode)."""
    kind = env.config.disturb_type
    if kind in dynamics.VEL_COUPLED:
        return kind
    if kind in ("gaussian", "none"):
        return "krng" if kernel_draw else "shared"
    return "table"


def _kernel_draws(env: QuadEnv, draw, deterministic) -> bool:
    """Whether K5 draws the shared gaussian disturbance itself ("krng"): a
    stochastic gaussian rollout that was handed no draw."""
    return (draw is None and not deterministic
            and env.config.disturb_type == "gaussian")


def build_kernel_disturb(env: QuadEnv, x0, t0, params, draw, deterministic,
                         H: int, kernel_draw: bool = False):
    """The kernels' disturbance inputs ``(dist (..., 3H), draw (..., 3))``
    (JAX: rollout_pallas.build_kernel_disturb), a leading scenario axis on
    x0, t0, the params and ``draw`` carrying through:

    - "shared": zeros, and the force every sample uses from step 1 on;
    - "krng" (``kernel_draw``): zeros, and [effective noise scale, 0, 0]:
      the kernel draws the normals;
    - "table": x0's force at step 0, then the model at t0 + h - 1, chained
      (periodic takes ``draw``); zeros;
    - "drag": zeros, and ``draw`` (zeros without one; drag reads none);
    - "mixed": the sin values at t0 + h (not t0 + h - 1: the step's update
      reads them), and the uniform ``draw``.
    """
    batch = x0.shape[:-1]
    dev = x0.device
    mode = disturb_mode(env, kernel_draw)
    zeros = torch.zeros(*batch, 3 * H, device=dev)
    if mode == "krng":
        scale = params.dyn_noise_scale
        zero = torch.zeros_like(scale)
        return zeros, torch.stack([scale, zero, zero], dim=-1).expand(*batch, 3)
    check_draw(env, draw, deterministic)
    if mode == "shared":
        if deterministic or env.config.disturb_type == "none":
            return zeros, torch.zeros(*batch, 3, device=dev)
        return zeros, env.disturb_fn(params, draw).expand(*batch, 3)
    if mode == "table":
        dist = disturb_table(env, params, x0[..., 13:16], t0, draw, H)
        return dist.reshape(*batch, 3 * H), torch.zeros(*batch, 3, device=dev)
    draw = torch.zeros(*batch, 3, device=dev) if draw is None else draw.expand(*batch, 3)
    if mode == "drag":
        return zeros, draw
    return sin_table(params, t0, H, dev).reshape(*batch, 3 * H), draw


def _pack_kernel_inputs(env: QuadEnv, x0, t0, pos_traj, vel_traj, params,
                        draw, deterministic, discount, H: int,
                        kernel_draw: bool = False):
    """Flat kernel operands: (ptar (H*3,), vtar (H*3,), dist (H*3,), scal
    (NSCAL,), ints (NINT,) int32), all built on x0's device.

    With a leading scenario axis on x0 (B, 16), t0 (B,), the trajectories
    (B, T, 3), the params' tensor leaves and the draw (B, 3), every operand
    gets it too: the scenario-strided tables of K6/K7, (B, H*3), (B, NSCAL),
    (B, NINT). The number of ops is the same for every B (JAX vmaps its
    twin over the scenarios)."""
    dev = x0.device
    batch = x0.shape[:-1]
    ptar, vtar = target_window(t0, pos_traj, vel_traj, H)
    dist, kdraw = build_kernel_disturb(env, x0, t0, params, draw, deterministic,
                                       H, kernel_draw)
    dp = params.disturb_params
    scalars = _dyn_scalars(env, params, dev) + [
        _full(discount, dev), params.disturb_scale, dp[..., 0], dp[..., 1],
        dp[..., 2],
    ]
    scal = torch.cat([torch.stack([v.expand(batch) for v in scalars], dim=-1),
                      kdraw], dim=-1)

    def int32(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=dev, dtype=torch.int32).reshape(batch)
        return torch.full(batch, v, dtype=torch.int32, device=dev)

    ints = torch.stack([int32(t0), int32(params.max_steps_in_episode),
                        int32(params.disturb_period)], dim=-1)
    return (ptar.reshape(*batch, -1), vtar.reshape(*batch, -1), dist, scal,
            ints)


def _launch_operands(env: QuadEnv, x0, t0, pos_traj, vel_traj, params, draw,
                     deterministic, discount, H: int, kernel_draw: bool = False):
    """The operands every rollout kernel takes first, in its argument order
    (x0 (16,), scal, ints, ptar, vtar, dist; each with the leading scenario
    axis of a batched x0), packed and checked for the launch. The caller
    keeps the tensors alive until the launch is enqueued."""
    dev = x0.device
    batch = tuple(x0.shape[:-1])
    ptar, vtar, dist, scal, ints = _pack_kernel_inputs(
        env, x0, t0, pos_traj, vel_traj, params, draw, deterministic, discount,
        H, kernel_draw,
    )
    x0 = x0[..., :16].contiguous()
    scal, dist = scal.contiguous(), dist.contiguous()
    for name, t, shape in (("x0", x0, (16,)), ("scal", scal, (NSCAL,)),
                           ("ptar", ptar, (3 * H,)), ("vtar", vtar, (3 * H,)),
                           ("dist", dist, (3 * H,))):
        kernels.check_cuda(name, t, batch + shape, device=dev)
    kernels.check_cuda("ints", ints, batch + (NINT,), torch.int32, device=dev)
    return x0, scal, ints, ptar, vtar, dist


class _RolloutKernelWrapper:
    """What the rollout kernels' wrappers share: the disturbance mode's and
    the reward's launch arguments, the block size (one of ``blocks`` where
    the kernel takes only those: anything else raises here, before any
    launch), the plain rollout (over B scenarios for the batched wrappers,
    with the same reward) and the rollover flag."""

    batched = False
    blocks: Optional[tuple] = None

    def __init__(self, env: QuadEnv, block: int = 128):
        if self.blocks is not None and block not in self.blocks:
            raise ValueError(f"{type(self).__name__}: block {block} not in {self.blocks}")
        self.env = env
        self.mode = MODES[disturb_mode(env)]
        self.reward = REWARDS[env.reward_name]
        self.block = block
        self._rollout = (make_rollout_batched if self.batched else make_rollout)(env)
        self._check_rollover = int(not env.config.disable_rollover_terminate)


def _check_joint_width(D: int) -> None:
    if D > JOINT_MAX_D:
        raise ValueError(f"joint sample + rollout: D = {D} > {JOINT_MAX_D} (H > 32)")


def _geometry(symbol: str, block: int, H: int, *args) -> dict:
    """A tiled kernel's launch geometry at ``block`` samples a block and
    horizon ``H`` (and the info entry point's further ``args``), read from
    the built library through its info entry point ``symbol``: threads and
    shared memory (bytes) of a block, and for each reward's
    instantiation the blocks an SM holds, registers and local memory (bytes)
    of a thread."""
    out = (ctypes.c_int * 8)()
    err = getattr(kernels.library(), symbol)(block, H, *args, out)
    if err != 0:
        raise RuntimeError(f"{symbol}: cudaError {err}")
    info = dict(samples=block, threads=out[0], smem=out[1])
    for k, reward in enumerate(REWARDS):
        info[reward] = dict(zip(("blocks_per_sm", "registers", "local_bytes"),
                                out[2 + 3 * k:5 + 3 * k]))
    return info


def joint_info(block: int = JOINT_BLOCK, H: int = 32) -> dict:
    """K1 / K7 joint's launch geometry (:func:`_geometry`)."""
    return _geometry("joint_sample_rollout_info", block, H)


def rollout_info(block: int = ROLLOUT_BLOCK, H: int = 32) -> dict:
    """K4 / K6's two kernels' launch geometry (:func:`_geometry`; shared
    memory static and dynamic in one): "split" (launched when the grid has
    no more blocks than the card has SMs) and "step" (otherwise)."""
    return {name: _geometry("rollout_costs_info", block, H, split)
            for name, split in (("split", 1), ("step", 0))}


def sample_info(block: int = SAMPLE_BLOCK, H: int = 32) -> dict:
    """K5 / K7 per-step's two kernels' launch geometry (:func:`_geometry`
    each): "tile" (launched when the grid has no more blocks than the card
    has SMs) and "step" (otherwise)."""
    return {name: _geometry("sample_rollout_info", block, H, tile)
            for name, tile in (("tile", 1), ("step", 0))}


class JointSampleRollout(_RolloutKernelWrapper):
    """K1: per sample, a = clip(mean + F z) and the H-step rollout cost.

    ``__call__(x0, t0, pos_traj, vel_traj, a_mean (H, 4), factor (D, D),
    params, seed, N, deterministic=False, discount=1.0, draw=None, z=None)
    -> (costs (N,), a_t (D, N))``. ``z`` (D, N) feeds given normals (the
    "input_z" mode); without it the kernel draws Philox normals keyed by
    ``seed``, an int or a 0-d int64 word on the tensors' device (a solver's
    :class:`~covo_mpc_tpu_torch.ops.sampling.SeedStream` word, which the
    kernel reads on the device), and the plain version draws from a
    generator seeded with its value. ``draw`` (3,) is the disturbance
    model's draw the rollout shares (``QuadEnv.draw_disturb``).
    """

    blocks = JOINT_BLOCKS

    def plain(self, x0, t0, pos_traj, vel_traj, a_mean, factor, params,
              seed: Seed, N: int, deterministic: bool = False, discount=1.0,
              draw: Optional[torch.Tensor] = None,
              z: Optional[torch.Tensor] = None):
        D = a_mean.numel()
        if z is None:
            z = torch.randn(D, N, generator=_seed_generator(seed, x0.device),
                            device=x0.device)
        a_t = torch.clamp(a_mean.reshape(D, 1) + factor @ z, -1.0, 1.0)
        costs = self._rollout(x0, t0, pos_traj, vel_traj, a_t, params, draw,
                              deterministic, discount, layout="hdn")
        return costs, a_t

    def __call__(self, x0, t0, pos_traj, vel_traj, a_mean, factor, params,
                 seed: Seed, N: int, deterministic: bool = False, discount=1.0,
                 draw: Optional[torch.Tensor] = None,
                 z: Optional[torch.Tensor] = None):
        if kernels.route(x0, a_mean, factor) == "plain":
            return self.plain(x0, t0, pos_traj, vel_traj, a_mean, factor,
                              params, seed, N, deterministic, discount, draw, z)
        H, dA = a_mean.shape
        if dA != 4:
            raise ValueError(f"action_dim must be 4, got {dA}")
        D = H * dA
        _check_joint_width(D)
        dev = x0.device
        ops = _launch_operands(self.env, x0, t0, pos_traj, vel_traj, params,
                               draw, deterministic, discount, H)
        mean = a_mean.reshape(D).contiguous()
        kernels.check_cuda("mean", mean, (D,), device=dev)
        kernels.check_cuda("factor", factor, (D, D), device=dev)
        if z is not None:
            kernels.check_cuda("z", z, (D, N), device=dev)
        key = None if z is not None else seed_word(seed, dev)
        costs = torch.empty(N, device=dev)
        a_t = torch.empty(D, N, device=dev)
        JOINT_KERNEL.launch(
            *(t.data_ptr() for t in ops), mean.data_ptr(), factor.data_ptr(),
            None if z is None else z.data_ptr(),
            None if key is None else key.data_ptr(),
            costs.data_ptr(), a_t.data_ptr(), N, H, self._check_rollover,
            self.mode, self.reward, self.block,
        )
        return costs, a_t


def make_rollout_joint_sampling(env: QuadEnv, block: int = JOINT_BLOCK):
    """The K1 wrapper (JAX: make_pallas_rollout_joint_sampling)."""
    return JointSampleRollout(env, block)


class RolloutCosts(_RolloutKernelWrapper):
    """K4: the H-step rollout cost of each of N given action sequences.

    ``__call__(x0, t0, pos_traj, vel_traj, actions, params, draw=None,
    deterministic=False, discount=1.0, layout="nhd") -> costs (N,)``, the
    contract of :func:`covo_mpc_tpu_torch.ops.rollout.make_rollout` (its
    plain version): ``actions`` (N, H, 4) for ``layout="nhd"``, (H, 4, N)
    or (H*4, N) for ``"hdn"``. The kernel's results do not depend on
    ``block`` (samples a block, one of :data:`ROLLOUT_BLOCKS`).
    """

    blocks = ROLLOUT_BLOCKS

    def __init__(self, env: QuadEnv, block: int = ROLLOUT_BLOCK):
        super().__init__(env, block)
        self.plain = self._rollout

    def __call__(self, x0, t0, pos_traj, vel_traj, actions, params,
                 draw: Optional[torch.Tensor] = None,
                 deterministic: bool = False, discount=1.0,
                 layout: str = "nhd"):
        if kernels.route(x0, actions) == "plain":
            return self.plain(x0, t0, pos_traj, vel_traj, actions, params,
                              draw, deterministic, discount, layout)
        if layout == "nhd":
            # the kernel reads sample-last (H, 4, N): one transpose here, as
            # the JAX wrapper transposes outside its kernel
            acts = actions.permute(1, 2, 0)
        elif layout == "hdn":
            acts = actions.reshape(-1, 4, actions.shape[-1])
        else:
            raise ValueError(f"unknown layout {layout!r}")
        acts = acts.contiguous()
        H, dA, N = acts.shape
        if dA != 4:
            raise ValueError(f"action_dim must be 4, got {dA}")
        dev = x0.device
        ops = _launch_operands(self.env, x0, t0, pos_traj, vel_traj, params,
                               draw, deterministic, discount, H)
        kernels.check_cuda("actions", acts, (H, 4, N), device=dev)
        costs = torch.empty(N, device=dev)
        ROLLOUT_KERNEL.launch(
            *(t.data_ptr() for t in ops), acts.data_ptr(), costs.data_ptr(),
            N, H, self._check_rollover, self.mode, self.reward, self.block,
        )
        return costs


def make_rollout_costs(env: QuadEnv, block: int = ROLLOUT_BLOCK):
    """The K4 wrapper (JAX: make_pallas_rollout)."""
    return RolloutCosts(env, block)


class SampleRollout(_RolloutKernelWrapper):
    """K5: per sample and step, a_h = clip(mean_h + L_h z_h) and the H-step
    rollout cost.

    ``__call__(x0, t0, pos_traj, vel_traj, a_mean (H, 4), chol (H, 4, 4),
    params, seed, N, deterministic=False, discount=1.0, draw=None, z=None,
    disturb_seed=None, draw_out=None) -> (costs (N,), a_t (4H, N))``.
    ``chol`` holds each step's lower Cholesky factor, row-major. ``z``
    (H, 4, N) feeds given normals (the "input_z" mode); without it the
    kernel draws Philox normals keyed by ``seed`` (an int or a 0-d int64
    device word, as :class:`JointSampleRollout`'s) and the plain version
    draws from a generator seeded with its value. The kernel's results do
    not depend on ``block``. ``draw`` (3,) is the disturbance model's draw
    the rollout shares; without one a stochastic gaussian rollout draws its
    normals from ``disturb_seed`` (the same kinds; "krng": in-kernel
    Philox; the plain version a seeded generator, both gaussian only, as
    JAX's kernel_draw), and ``draw_out`` (3,), when given, receives them.
    """

    blocks = SAMPLE_BLOCKS

    def plain(self, x0, t0, pos_traj, vel_traj, a_mean, chol, params,
              seed: Seed, N: int, deterministic: bool = False, discount=1.0,
              draw: Optional[torch.Tensor] = None,
              z: Optional[torch.Tensor] = None,
              disturb_seed: Optional[Seed] = None,
              draw_out: Optional[torch.Tensor] = None):
        dev = x0.device
        H = a_mean.shape[0]
        if z is None:
            z = torch.randn(H, 4, N, generator=_seed_generator(seed, dev), device=dev)
        if _kernel_draws(self.env, draw, deterministic):
            draw = torch.randn(3, generator=_seed_generator(disturb_seed, dev),
                               device=dev)
            if draw_out is not None:
                draw_out.copy_(draw)
        a_t = torch.clamp(a_mean[..., None] + torch.einsum("hij,hjn->hin", chol, z),
                          -1.0, 1.0).reshape(4 * H, N)
        costs = self._rollout(x0, t0, pos_traj, vel_traj, a_t, params, draw,
                              deterministic, discount, layout="hdn")
        return costs, a_t

    def __call__(self, x0, t0, pos_traj, vel_traj, a_mean, chol, params,
                 seed: Seed, N: int, deterministic: bool = False, discount=1.0,
                 draw: Optional[torch.Tensor] = None,
                 z: Optional[torch.Tensor] = None,
                 disturb_seed: Optional[Seed] = None,
                 draw_out: Optional[torch.Tensor] = None):
        krng = _kernel_draws(self.env, draw, deterministic)
        if krng and disturb_seed is None:
            raise ValueError("a stochastic gaussian rollout needs its draw "
                             "or a disturb_seed")
        if kernels.route(x0, a_mean, chol) == "plain":
            return self.plain(x0, t0, pos_traj, vel_traj, a_mean, chol, params,
                              seed, N, deterministic, discount, draw, z,
                              disturb_seed, draw_out)
        H, dA = a_mean.shape
        if dA != 4:
            raise ValueError(f"action_dim must be 4, got {dA}")
        dev = x0.device
        ops = _launch_operands(self.env, x0, t0, pos_traj, vel_traj, params,
                               draw, deterministic, discount, H, kernel_draw=krng)
        mean = a_mean.reshape(4 * H).contiguous()
        kernels.check_cuda("mean", mean, (4 * H,), device=dev)
        kernels.check_cuda("chol", chol, (H, 4, 4), device=dev)
        if z is not None:
            kernels.check_cuda("z", z, (H, 4, N), device=dev)
        if draw_out is not None:
            kernels.check_cuda("draw_out", draw_out, (3,), device=dev)
        key = None if z is not None else seed_word(seed, dev)
        dkey = seed_word(disturb_seed, dev) if krng else None
        costs = torch.empty(N, device=dev)
        a_t = torch.empty(4 * H, N, device=dev)
        SAMPLE_KERNEL.launch(
            *(t.data_ptr() for t in ops), mean.data_ptr(), chol.data_ptr(),
            None if z is None else z.data_ptr(),
            None if key is None else key.data_ptr(),
            None if dkey is None else dkey.data_ptr(), int(krng),
            None if draw_out is None else draw_out.data_ptr(),
            costs.data_ptr(), a_t.data_ptr(), N, H, self._check_rollover,
            self.mode, self.reward, self.block,
        )
        return costs, a_t


def make_rollout_sampling(env: QuadEnv, block: int = SAMPLE_BLOCK):
    """The K5 wrapper (JAX: make_pallas_rollout_sampling)."""
    return SampleRollout(env, block)


# --- the scenario-batched kernels (K6, K7): B scenarios in one launch ------
#
# Every operand carries a leading scenario axis: x0s (B, 16), t0s (B,), the
# trajectories (B, T, 3), params_b (EnvParams3D with (B, ...) tensor leaves,
# ``stack_params``) and draws (B, 3), each scenario's disturbance draw. The
# disturbance modes are the single-scenario kernels' with a scenario-strided
# (B, 3H) dist table; the draw is handed in (JAX's batched builders never
# take "krng"). K7's ``offset`` shifts the scenarios' Philox slots, so a
# chunk of a batched protocol draws as its episodes do in one launch.


class RolloutCostsBatched(_RolloutKernelWrapper):
    """K6: K4 for B scenarios in one launch.

    ``__call__(x0s, t0s, pos_trajs, vel_trajs, actions, params_b,
    draws=None, deterministic=False, discount=1.0, layout="hdn") -> costs
    (B, N)``, the contract of :func:`~covo_mpc_tpu_torch.ops.rollout.
    make_rollout_batched` (its plain version): ``actions`` (B, N, H, 4) for
    ``layout="nhd"``, (B, H, 4, N) or (B, H*4, N) for ``"hdn"``; ``block``
    as :class:`RolloutCosts`'.
    """

    batched = True
    blocks = ROLLOUT_BLOCKS

    def __init__(self, env: QuadEnv, block: int = ROLLOUT_BLOCK):
        super().__init__(env, block)
        self.plain = self._rollout

    def __call__(self, x0s, t0s, pos_trajs, vel_trajs, actions, params_b,
                 draws: Optional[torch.Tensor] = None,
                 deterministic: bool = False, discount=1.0,
                 layout: str = "hdn"):
        if kernels.route(x0s, actions) == "plain":
            return self.plain(x0s, t0s, pos_trajs, vel_trajs, actions,
                              params_b, draws, deterministic, discount, layout)
        B = x0s.shape[0]
        if layout == "nhd":
            acts = actions.permute(0, 2, 3, 1)
        elif layout == "hdn":
            acts = actions.reshape(B, -1, 4, actions.shape[-1])
        else:
            raise ValueError(f"unknown layout {layout!r}")
        acts = acts.contiguous()
        _, H, dA, N = acts.shape
        dev = x0s.device
        ops = _launch_operands(self.env, x0s, t0s, pos_trajs, vel_trajs,
                               params_b, draws, deterministic, discount, H)
        kernels.check_cuda("actions", acts, (B, H, 4, N), device=dev)
        costs = torch.empty(B, N, device=dev)
        ROLLOUT_BATCHED_KERNEL.launch(
            *(t.data_ptr() for t in ops), acts.data_ptr(), costs.data_ptr(),
            B, N, H, self._check_rollover, self.mode, self.reward, self.block,
        )
        return costs


def make_rollout_batched_costs(env: QuadEnv, block: int = ROLLOUT_BLOCK):
    """The K6 wrapper (JAX: make_pallas_rollout_batched)."""
    return RolloutCostsBatched(env, block)


class SampleRolloutBatched(_RolloutKernelWrapper):
    """K7, per-step: K5 for B scenarios in one launch, a_h = clip(mean_h +
    L_h z_h) per scenario, sample and step.

    ``__call__(x0s, t0s, pos_trajs, vel_trajs, a_means (B, H, 4), chols
    (B, H, 4, 4), params_b, seed, N, deterministic=False, discount=1.0,
    draws=None, z=None) -> (costs (B, N), a_t (B, 4H, N))``. ``chols`` are
    the per-step lower Cholesky factors, row-major. ``z`` (B, H, 4, N) feeds
    given normals; without it the kernel draws Philox normals keyed by
    ``seed`` (an int or a 0-d int64 device word) with the scenario's slot
    in the counter, and the plain version draws each scenario from a
    generator seeded from its value and the slot (:func:`_scenario_normals`).
    The slot of scenario b is ``offset`` + b (``offset`` an int, a 0-d int32
    device word, or None for 0; :func:`offset_word`): scenario 0 at offset 0
    draws what K5 draws, and scenario b at offset o what scenario o + b draws
    at offset 0, whatever B.
    """

    blocks = SAMPLE_BLOCKS
    batched = True

    def plain(self, x0s, t0s, pos_trajs, vel_trajs, a_means, chols, params_b,
              seed: Seed, N: int, deterministic: bool = False, discount=1.0,
              draws: Optional[torch.Tensor] = None,
              z: Optional[torch.Tensor] = None, offset: Offset = None):
        B, H, dA = a_means.shape
        if z is None:
            z = _scenario_normals(seed, offset, (H, dA, N), B, x0s.device)
        a_t = torch.clamp(
            a_means[..., None] + torch.einsum("bhij,bhjn->bhin", chols, z),
            -1.0, 1.0).reshape(B, H * dA, N)
        costs = self._rollout(x0s, t0s, pos_trajs, vel_trajs, a_t, params_b,
                                draws, deterministic, discount, layout="hdn")
        return costs, a_t

    def __call__(self, x0s, t0s, pos_trajs, vel_trajs, a_means, chols,
                 params_b, seed: Seed, N: int, deterministic: bool = False,
                 discount=1.0, draws: Optional[torch.Tensor] = None,
                 z: Optional[torch.Tensor] = None, offset: Offset = None):
        if kernels.route(x0s, a_means, chols) == "plain":
            return self.plain(x0s, t0s, pos_trajs, vel_trajs, a_means, chols,
                              params_b, seed, N, deterministic, discount,
                              draws, z, offset)
        B, H, dA = a_means.shape
        if dA != 4:
            raise ValueError(f"action_dim must be 4, got {dA}")
        dev = x0s.device
        ops = _launch_operands(self.env, x0s, t0s, pos_trajs, vel_trajs,
                               params_b, draws, deterministic, discount, H)
        mean = a_means.contiguous()
        kernels.check_cuda("a_means", mean, (B, H, 4), device=dev)
        kernels.check_cuda("chols", chols, (B, H, 4, 4), device=dev)
        if z is not None:
            kernels.check_cuda("z", z, (B, H, 4, N), device=dev)
        key = None if z is not None else seed_word(seed, dev)
        off = offset_word(offset, dev)
        costs = torch.empty(B, N, device=dev)
        a_t = torch.empty(B, 4 * H, N, device=dev)
        SAMPLE_BATCHED_KERNEL.launch(
            *(t.data_ptr() for t in ops), mean.data_ptr(), chols.data_ptr(),
            None if z is None else z.data_ptr(),
            None if key is None else key.data_ptr(),
            None if off is None else off.data_ptr(),
            costs.data_ptr(), a_t.data_ptr(), B, N, H, self._check_rollover,
            self.mode, self.reward, self.block,
        )
        return costs, a_t


class JointSampleRolloutBatched(_RolloutKernelWrapper):
    """K7, joint: K1 for B scenarios in one launch, a = clip(mean_b + F_b z)
    per scenario and sample.

    ``__call__(x0s, t0s, pos_trajs, vel_trajs, a_means (B, H, 4), factors
    (B, D, D), params_b, seed, N, deterministic=False, discount=1.0,
    draws=None, z=None) -> (costs (B, N), a_t (B, D, N))``. ``z`` (B, D, N)
    feeds given normals; without it the kernel draws Philox normals keyed by
    ``seed`` (an int or a 0-d int64 device word) with the scenario's slot
    in the counter, ``offset`` + b, as :class:`SampleRolloutBatched`'s
    (scenario 0 at offset 0 draws what K1 draws), and the plain version
    draws each scenario from its own generator (:func:`_scenario_normals`).
    """

    blocks = JOINT_BLOCKS
    batched = True

    def plain(self, x0s, t0s, pos_trajs, vel_trajs, a_means, factors,
              params_b, seed: Seed, N: int, deterministic: bool = False,
              discount=1.0, draws: Optional[torch.Tensor] = None,
              z: Optional[torch.Tensor] = None, offset: Offset = None):
        B = a_means.shape[0]
        D = a_means[0].numel()
        if z is None:
            z = _scenario_normals(seed, offset, (D, N), B, x0s.device)
        a_t = torch.clamp(a_means.reshape(B, D, 1) + factors @ z, -1.0, 1.0)
        costs = self._rollout(x0s, t0s, pos_trajs, vel_trajs, a_t, params_b,
                                draws, deterministic, discount, layout="hdn")
        return costs, a_t

    def __call__(self, x0s, t0s, pos_trajs, vel_trajs, a_means, factors,
                 params_b, seed: Seed, N: int, deterministic: bool = False,
                 discount=1.0, draws: Optional[torch.Tensor] = None,
                 z: Optional[torch.Tensor] = None, offset: Offset = None):
        if kernels.route(x0s, a_means, factors) == "plain":
            return self.plain(x0s, t0s, pos_trajs, vel_trajs, a_means,
                              factors, params_b, seed, N, deterministic,
                              discount, draws, z, offset)
        B, H, dA = a_means.shape
        if dA != 4:
            raise ValueError(f"action_dim must be 4, got {dA}")
        D = H * dA
        _check_joint_width(D)
        dev = x0s.device
        ops = _launch_operands(self.env, x0s, t0s, pos_trajs, vel_trajs,
                               params_b, draws, deterministic, discount, H)
        mean = a_means.reshape(B, D).contiguous()
        kernels.check_cuda("a_means", mean, (B, D), device=dev)
        kernels.check_cuda("factors", factors, (B, D, D), device=dev)
        if z is not None:
            kernels.check_cuda("z", z, (B, D, N), device=dev)
        key = None if z is not None else seed_word(seed, dev)
        off = offset_word(offset, dev)
        costs = torch.empty(B, N, device=dev)
        a_t = torch.empty(B, D, N, device=dev)
        JOINT_BATCHED_KERNEL.launch(
            *(t.data_ptr() for t in ops), mean.data_ptr(), factors.data_ptr(),
            None if z is None else z.data_ptr(),
            None if key is None else key.data_ptr(),
            None if off is None else off.data_ptr(),
            costs.data_ptr(), a_t.data_ptr(), B, N, H, self._check_rollover,
            self.mode, self.reward, self.block,
        )
        return costs, a_t


def make_rollout_batched_sampling(env: QuadEnv, joint: bool = False,
                                  block: Optional[int] = None):
    """The K7 wrappers (JAX: make_pallas_rollout_batched_sampling):
    per-step Cholesky factors (``joint=False``, MPPI; SAMPLE_BLOCK samples
    a block by default) or full factors (``joint=True``, CoVO; JOINT_BLOCK)."""
    if block is None:
        block = JOINT_BLOCK if joint else SAMPLE_BLOCK
    return (JointSampleRolloutBatched if joint else SampleRolloutBatched)(env, block)


class Primal:
    """K2: the Hessian's nominal rollout, z_h = (s_h, a_h).

    ``__call__(x0 (16,), a_seq (H, 4), dist (H, 3), params) -> (H, 17)``
    with s_h the PRE-step state of step h and a_h the raw (unclipped)
    action; the step clips internally.
    """

    def __init__(self, env: QuadEnv, H: int):
        self.env = env
        self.H = H

    def plain(self, x0, a_seq, dist, params):
        s = x0[:13]
        states = []
        for h in range(self.H):
            states.append(s)
            s = dynamics.core_step(s, a_seq[h], dist[h], params, self.env._dt)
        return torch.cat([torch.stack(states), a_seq], dim=1)

    def __call__(self, x0, a_seq, dist, params):
        if kernels.route(x0, a_seq, dist) == "plain":
            return self.plain(x0, a_seq, dist, params)
        H, dev = self.H, x0.device
        x0c = x0[:16].contiguous()
        scal = torch.stack(_dyn_scalars(self.env, params, dev) + [_full(1.0, dev)])
        a_flat = a_seq.reshape(-1).contiguous()
        d_flat = dist.reshape(-1).contiguous()
        for name, t, shape in (("x0", x0c, (16,)), ("scal", scal, (10,)),
                               ("a_seq", a_flat, (4 * H,)),
                               ("dist", d_flat, (3 * H,))):
            kernels.check_cuda(name, t, shape, device=dev)
        states = torch.empty(H, 13, device=dev)
        PRIMAL_KERNEL.launch(x0c.data_ptr(), scal.data_ptr(), a_flat.data_ptr(),
                             d_flat.data_ptr(), states.data_ptr(), H)
        return torch.cat([states, a_seq], dim=1)


def make_primal(env: QuadEnv, H: int):
    """The K2 wrapper (JAX: make_pallas_primal)."""
    return Primal(env, H)
