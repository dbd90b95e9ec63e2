"""State / parameter structs for the quadrotor model, as dataclasses of tensors.

Counterpart of :mod:`covo_mpc_tpu.models.structs`: the same fields and the
same packed ``(..., 16)`` rollout layout. Float parameters live as 0-d
float32 tensors on the env's device (vectors as 1-d tensors), so that every
per-solve pack of them is a device op and never a host-to-device copy; the
integer episode constants stay Python ints. ``params_from_numpy`` and
``state_from_numpy`` carry the JAX structs' leaves across, so that both
packages compute on the same inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch


def default_array(values):
    """A dataclass field whose default is a float32 tensor of ``values``,
    made anew for each instance (JAX: a flax struct field with a jnp-array
    default)."""
    return dataclasses.field(
        default_factory=lambda: torch.tensor(values, dtype=torch.float32))


# Packed-state layout used by the rollout engines: x = (N, 16) float32 with
#   x[..., 0:3]   position (world)
#   x[..., 3:7]   quaternion (x, y, z, w)
#   x[..., 7:10]  velocity (world)
#   x[..., 10:13] body angular velocity
#   x[..., 13:16] force disturbance (world)
PACKED_STATE_DIM = 16
POS = slice(0, 3)
QUAT = slice(3, 7)
VEL = slice(7, 10)
OMEGA = slice(10, 13)
FDIST = slice(13, 16)


@dataclasses.dataclass
class EnvState3D:
    """Full episode state (JAX: structs.EnvState3D); every field a tensor
    except ``control_params``."""

    pos: torch.Tensor  # (3,)
    vel: torch.Tensor  # (3,)
    quat: torch.Tensor  # (4,) (x, y, z, w)
    omega: torch.Tensor  # (3,)
    omega_tar: torch.Tensor  # (3,)
    pos_traj: torch.Tensor  # (T, 3)
    vel_traj: torch.Tensor  # (T, 3)
    acc_traj: torch.Tensor  # (T, 3)
    pos_tar: torch.Tensor  # (3,)
    vel_tar: torch.Tensor  # (3,)
    acc_tar: torch.Tensor  # (3,)
    last_thrust: torch.Tensor  # () float32
    last_torque: torch.Tensor  # (3,)
    time: torch.Tensor  # () int32
    f_disturb: torch.Tensor  # (3,)
    vel_hist: torch.Tensor  # (adapt_horizon + 2, 3)
    omega_hist: torch.Tensor  # (adapt_horizon + 2, 3)
    action_hist: torch.Tensor  # (adapt_horizon + 2, 4)
    control_params: Any = 0.0

    def replace(self, **changes) -> "EnvState3D":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class Action3D:
    """Physical action (JAX: structs.Action3D): the collective thrust and the
    body torque (3,)."""

    thrust: float
    torque: torch.Tensor


# EnvParams3D fields that are integers (kept as Python ints)
_INT_FIELDS = ("max_steps_in_episode", "traj_obs_len", "traj_obs_gap",
               "disturb_period", "adapt_horizon")


@dataclasses.dataclass
class EnvParams3D:
    """Environment parameters: Crazyflie-2 constants + DR ranges (JAX:
    structs.EnvParams3D, same defaults). Build with :meth:`default` or
    :func:`params_from_numpy`; float fields are tensors on one device."""

    max_speed: torch.Tensor
    max_torque: torch.Tensor
    max_omega: torch.Tensor
    max_thrust: torch.Tensor
    dt: torch.Tensor
    g: torch.Tensor
    m: torch.Tensor
    m_mean: torch.Tensor
    m_std: torch.Tensor
    I_diag: torch.Tensor
    I_diag_mean: torch.Tensor
    I_diag_std: torch.Tensor
    l: torch.Tensor
    l_mean: torch.Tensor
    l_std: torch.Tensor
    hook_offset: torch.Tensor
    hook_offset_mean: torch.Tensor
    hook_offset_std: torch.Tensor
    action_scale: torch.Tensor
    action_scale_mean: torch.Tensor
    action_scale_std: torch.Tensor
    alpha_bodyrate: torch.Tensor
    alpha_thrust: torch.Tensor
    alpha_bodyrate_mean: torch.Tensor
    alpha_bodyrate_std: torch.Tensor
    max_steps_in_episode: int
    rope_taut_therehold: torch.Tensor
    traj_obs_len: int
    traj_obs_gap: int
    d_offset: torch.Tensor
    disturb_period: int
    disturb_scale: torch.Tensor
    disturb_params: torch.Tensor
    curri_params: torch.Tensor
    adapt_horizon: int
    dyn_noise_scale: torch.Tensor
    obs_noise_scale: torch.Tensor

    @classmethod
    def default(cls, device="cuda", **overrides) -> "EnvParams3D":
        values = dict(_DEFAULTS, **overrides)
        return params_from_numpy(values, device)

    def replace(self, **changes) -> "EnvParams3D":
        return dataclasses.replace(self, **changes)


_DEFAULTS = dict(
    max_speed=8.0, max_torque=[9e-3, 9e-3, 2e-3], max_omega=[10.0, 10.0, 3.0],
    max_thrust=0.8, dt=0.02, g=9.81,
    m=0.027, m_mean=0.027, m_std=0.003,
    I_diag=[1.7e-5, 1.7e-5, 3.0e-5], I_diag_mean=[1.7e-5, 1.7e-5, 3.0e-5],
    I_diag_std=[0.2e-5, 0.2e-5, 0.3e-5],
    l=0.3, l_mean=0.3, l_std=0.1,
    hook_offset=[0.0, 0.0, -0.01], hook_offset_mean=[0.0, 0.0, -0.02],
    hook_offset_std=[0.01, 0.01, 0.01],
    action_scale=1.0, action_scale_mean=1.0, action_scale_std=0.1,
    alpha_bodyrate=0.5, alpha_thrust=0.6, alpha_bodyrate_mean=0.5,
    alpha_bodyrate_std=0.1,
    max_steps_in_episode=300, rope_taut_therehold=1e-4, traj_obs_len=5,
    traj_obs_gap=5,
    d_offset=[0.0] * 6, disturb_period=50, disturb_scale=0.2,
    disturb_params=[0.0] * 6,
    curri_params=1.0, adapt_horizon=4,
    dyn_noise_scale=0.05, obs_noise_scale=0.05,
)


def _f32(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def _int_leaf(name: str, v) -> int:
    """An integer episode constant; a batched leaf must hold one value."""
    v = np.unique(np.asarray(v))
    if v.size != 1:
        raise ValueError(f"{name}: scenarios differ ({v.tolist()}), the port "
                         "keeps one integer episode constant")
    return int(v[0])


def params_from_numpy(leaves: Mapping[str, Any], device="cuda") -> EnvParams3D:
    """Build :class:`EnvParams3D` from the JAX struct's leaves as numpy
    arrays (or Python numbers): float leaves become float32 tensors on
    ``device``, the integer episode constants Python ints. Leaves batched
    over scenarios (``jax.vmap(env.sample_params)``) keep their leading
    axis; their integer constants must agree. Keys the JAX struct has and
    the port does not are an error."""
    fields = {f.name for f in dataclasses.fields(EnvParams3D)}
    unknown = set(leaves) - fields
    if unknown:
        raise KeyError(f"unknown EnvParams3D fields {sorted(unknown)}")
    kw = {}
    for name in fields:
        v = leaves.get(name, _DEFAULTS[name])
        kw[name] = _int_leaf(name, v) if name in _INT_FIELDS else _f32(v, device)
    return EnvParams3D(**kw)


def float_leaves(params: EnvParams3D) -> dict:
    """The tensor fields of ``params`` by name (every field but the integer
    episode constants)."""
    return {f.name: getattr(params, f.name) for f in dataclasses.fields(params)
            if f.name not in _INT_FIELDS}


def stack_params(params: Sequence[EnvParams3D]) -> EnvParams3D:
    """B scenarios' parameters as one :class:`EnvParams3D` whose tensor
    leaves carry a leading B axis; the integer constants must agree."""
    for name in _INT_FIELDS:
        _int_leaf(name, [getattr(p, name) for p in params])
    return params[0].replace(**{
        name: torch.stack([float_leaves(p)[name] for p in params])
        for name in float_leaves(params[0])
    })


def expand_params(params: EnvParams3D, B: int) -> EnvParams3D:
    """One params for B scenarios, as the batched solves take them: each
    tensor leaf expanded to a leading B axis (a view, no copy)."""
    return params.replace(**{k: v.expand(B, *v.shape)
                             for k, v in float_leaves(params).items()})


def index_params(params_b: EnvParams3D, b: int) -> EnvParams3D:
    """Scenario ``b`` of parameters batched by :func:`stack_params`."""
    return params_b.replace(**{k: v[b] for k, v in float_leaves(params_b).items()})


def state_from_numpy(leaves: Mapping[str, Any], device="cuda") -> EnvState3D:
    """Build :class:`EnvState3D` from the JAX struct's leaves as numpy
    arrays: float32 tensors, int32 ``time``, on ``device``."""
    kw = {}
    for f in dataclasses.fields(EnvState3D):
        if f.name == "control_params":
            kw[f.name] = leaves.get(f.name, 0.0)
        elif f.name == "time":
            kw[f.name] = torch.from_numpy(
                np.array(leaves["time"], dtype=np.int32)).to(device)
        else:
            kw[f.name] = _f32(leaves[f.name], device)
    return EnvState3D(**kw)


def pack_state(state: EnvState3D) -> torch.Tensor:
    """The 16 physical entries of an EnvState3D as one vector, (..., 16) for
    a state whose fields carry leading batch axes."""
    return torch.cat(
        [state.pos, state.quat, state.vel, state.omega, state.f_disturb], dim=-1
    )


def unpack_state(x: torch.Tensor):
    """Split a packed state ``(..., 16)`` into its five components."""
    return x[..., POS], x[..., QUAT], x[..., VEL], x[..., OMEGA], x[..., FDIST]


# --- pytrees of tensors: dataclasses, dicts, lists and tuples ----------------

def tree_flatten(tree) -> tuple:
    """``(tensor leaves, spec)``: the spec holds the structure, every
    non-tensor leaf, and each tensor's shape and dtype, and compares equal
    for trees of one structure, constants, shapes and dtypes."""
    leaves: list = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return ("tensor", tuple(x.shape), x.dtype)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            names = tuple(f.name for f in dataclasses.fields(x))
            return ("dataclass", type(x), names,
                    tuple(walk(getattr(x, n)) for n in names))
        if isinstance(x, dict):
            keys = tuple(x)
            return ("dict", keys, tuple(walk(x[k]) for k in keys))
        if isinstance(x, (list, tuple)):
            return (type(x), tuple(walk(v) for v in x))
        return ("const", x)

    spec = walk(tree)
    return leaves, spec


def tree_unflatten(spec, leaves) -> Any:
    """The tree of ``spec`` with its tensors taken in turn from ``leaves``
    (their shapes are not checked against the spec's)."""
    it = iter(leaves)

    def build(s):
        kind = s[0]
        if kind == "tensor":
            return next(it)
        if kind == "dataclass":
            return s[1](**{n: build(c) for n, c in zip(s[2], s[3])})
        if kind == "dict":
            return {k: build(c) for k, c in zip(s[1], s[2])}
        if kind == "const":
            return s[1]
        return kind(build(c) for c in s[1])

    return build(spec)


def stack(trees: Sequence) -> Any:
    """B trees of one structure (an :class:`EnvState3D`, ``StepDraws``,
    ``ResetDraws``, an info dict, solver params) as one tree whose tensor
    leaves carry a leading B axis; the non-tensor leaves must agree (the
    counterpart for :class:`EnvParams3D` is :func:`stack_params`)."""
    flat = [tree_flatten(t) for t in trees]
    spec = flat[0][1]
    if any(s != spec for _, s in flat[1:]):
        raise ValueError("stack: the trees differ in structure, a constant, a "
                         "shape or a dtype")
    return tree_unflatten(spec, [torch.stack(ls) for ls in zip(*(f[0] for f in flat))])


def index(tree, b: int) -> Any:
    """Element ``b`` of a tree batched by :func:`stack` (every tensor leaf
    indexed on its leading axis)."""
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [x[b] for x in leaves])


def vmap_trees(fn: Callable, batched: tuple, shared: tuple = ()) -> Any:
    """``fn(*batched_b, *shared)`` for every b at once: ``torch.func.vmap``
    over the tensor leaves of ``batched`` (each on axis 0), ``shared`` taken
    as it is (unbatched). The dataclasses and dicts in the arguments and in
    ``fn``'s output are not pytrees vmap knows, so their tensor leaves are
    handed across and the trees rebuilt on each side; non-tensor leaves
    (Python floats, None) stay constants."""
    leaves, spec = tree_flatten(tuple(batched))
    out_spec = []

    def one(b):
        out = fn(*tree_unflatten(spec, b), *shared)
        out_leaves, s = tree_flatten(out)
        out_spec.append(s)
        return tuple(out_leaves)

    out = torch.func.vmap(one)(list(leaves))
    return tree_unflatten(out_spec[0], out)


def tree_select(cond: torch.Tensor, a, b):
    """Field-wise ``torch.where(cond, a, b)`` over tensors, dataclasses of
    tensors and dicts of them (the auto-reset select; no host sync).
    Non-tensor leaves (Python numbers, None) are taken from ``b``."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond, a, b)
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(b, **{
            f.name: tree_select(cond, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)
        })
    if isinstance(a, dict):
        return {k: tree_select(cond, a[k], b[k]) for k in a}
    return b
