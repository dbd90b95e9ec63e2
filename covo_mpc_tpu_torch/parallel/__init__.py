"""Scenario batching: B scenarios' solves in one call on one device, and
each controller's batched twin (the batched protocol's controller). The
mesh and sharded steps of the JAX package are not ported yet."""

from covo_mpc_tpu_torch.parallel.scenarios import (
    batched_controller,
    make_batched_covo_solve,
    make_batched_mppi_solve,
)

__all__ = ["batched_controller", "make_batched_covo_solve", "make_batched_mppi_solve"]
