"""Physics core: structs, rotation math, dynamics, trajectories, rewards, env."""

from covo_mpc_tpu_torch.models import dynamics, rewards, rotation, trajectory
from covo_mpc_tpu_torch.models.quad_env import EnvConfig, QuadEnv
from covo_mpc_tpu_torch.models.structs import (
    PACKED_STATE_DIM,
    EnvParams3D,
    EnvState3D,
    pack_state,
    params_from_numpy,
    state_from_numpy,
    unpack_state,
)

__all__ = [
    "EnvConfig",
    "EnvParams3D",
    "EnvState3D",
    "PACKED_STATE_DIM",
    "QuadEnv",
    "dynamics",
    "pack_state",
    "params_from_numpy",
    "rewards",
    "rotation",
    "state_from_numpy",
    "trajectory",
    "unpack_state",
]
