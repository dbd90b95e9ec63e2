"""Physics core: structs, rotation math, dynamics, trajectories, rewards, env,
the episode-log wrapper and the reference's small utilities."""

from covo_mpc_tpu_torch.models import dynamics, misc, rewards, rotation, trajectory
from covo_mpc_tpu_torch.models.quad_env import EnvConfig, QuadEnv
from covo_mpc_tpu_torch.models.wrappers import LogEnvState, LogWrapper
from covo_mpc_tpu_torch.models.structs import (
    PACKED_STATE_DIM,
    Action3D,
    EnvParams3D,
    EnvState3D,
    default_array,
    pack_state,
    params_from_numpy,
    state_from_numpy,
    unpack_state,
)

__all__ = [
    "Action3D",
    "EnvConfig",
    "EnvParams3D",
    "EnvState3D",
    "LogEnvState",
    "LogWrapper",
    "PACKED_STATE_DIM",
    "QuadEnv",
    "default_array",
    "dynamics",
    "misc",
    "pack_state",
    "params_from_numpy",
    "rewards",
    "rotation",
    "state_from_numpy",
    "trajectory",
    "unpack_state",
]
