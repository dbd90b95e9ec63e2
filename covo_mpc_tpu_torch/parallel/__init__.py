"""The multi-device layer on ``torch.distributed``: one process a rank, one
device a process.

- ``distributed``: the launcher contract (``initialize_distributed``,
  ``device_topology``) and k ranks on one host (``run_ranks``);
- ``mesh``: named axes over the ranks (``make_mesh``, ``Mesh``), each axis
  a process group whose ``pmin`` / ``psum`` are ``dist.all_reduce``;
- ``sharded``: the sample axis of the MPPI and CoVO solves split over
  ranks (three collectives a solve);
- ``scenarios``: scenario batching on one device, each controller's
  batched twin, and the multichip steps (scenarios data parallel, samples
  sharded);
- ``offline``: CoVO offline's Σ schedule designed over the ranks;
- ``pipeline``: the two-stage speculative CoVO pipeline.

Every name of the JAX package's ``parallel.__all__`` has its counterpart
here.
"""

# scenarios first: it imports sharded, whose import of runtime imports the
# batched protocol, which imports scenarios back
from covo_mpc_tpu_torch.parallel.scenarios import (  # isort: skip
    batched_controller,
    make_batched_covo_solve,
    make_batched_mppi_solve,
    make_multichip_control_step,
    make_multichip_covo_step,
)
from covo_mpc_tpu_torch.parallel.distributed import (
    device_topology,
    initialize_distributed,
    run_ranks,
)
from covo_mpc_tpu_torch.parallel.mesh import SAMPLE_AXIS, SCENARIO_AXIS, Mesh, make_mesh
from covo_mpc_tpu_torch.parallel.offline import make_distributed_offline_schedule
from covo_mpc_tpu_torch.parallel.pipeline import (
    PIPE_AXIS,
    make_init_factor,
    make_pipeline_mesh,
    make_pipeline_step,
)
from covo_mpc_tpu_torch.parallel.sharded import (
    make_distributed_covo_solve,
    make_sharded_covo_sample_rollout,
    make_sharded_mppi_solve,
)

__all__ = [
    "PIPE_AXIS",
    "SAMPLE_AXIS",
    "SCENARIO_AXIS",
    "Mesh",
    "batched_controller",
    "device_topology",
    "initialize_distributed",
    "make_batched_covo_solve",
    "make_batched_mppi_solve",
    "make_distributed_covo_solve",
    "make_distributed_offline_schedule",
    "make_init_factor",
    "make_mesh",
    "make_multichip_control_step",
    "make_multichip_covo_step",
    "make_pipeline_mesh",
    "make_pipeline_step",
    "make_sharded_covo_sample_rollout",
    "make_sharded_mppi_solve",
    "run_ranks",
]
