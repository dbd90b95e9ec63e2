"""Typed run configuration of the command line (``covo_mpc_tpu_torch.cli``).

Counterpart of :class:`covo_mpc_tpu.runtime.config.RunConfig`, with its
fields and defaults, plus ``device`` (the card by default; ``"cpu"`` is how
a caller, the tests among them, asks for the CPU). ``engine`` takes the
port's names: ``auto`` (the kernels for an env on the card, the plain path
on the CPU), ``torch`` (the plain PyTorch path) or ``cuda`` (the
hand-written kernels). The JAX package's engine names raise, naming their
counterpart.
"""

from __future__ import annotations

import dataclasses

ENGINES = ("auto", "torch", "cuda")
# the JAX package's engines and the port's counterpart of each
JAX_ENGINES = {"jnp": "torch", "pallas": "cuda", "pallas_interpret": "torch"}


@dataclasses.dataclass
class RunConfig:
    # reference-compatible fields
    task: str = "tracking"  # tracking | tracking_zigzag | tracking_slow | hovering
    controller: str = "covo_online"  # pid | random | mppi | covo_online | covo_offline | covo_speculative
    controller_params: str = ""  # "N{N}_H{H}_lam{lam}", empty = paper defaults
    obs_type: str = "quad"
    debug: bool = False
    mode: str = "eval"  # eval | render | bench
    lower_controller: str = "base"
    noDR: bool = False
    disturb_type: str = "gaussian"
    name: str = ""

    # the solver's knobs
    # parity / invariant draw from JAX's keys (JAX's episodes, step for step)
    rng_mode: str = "fast"  # parity | fast | invariant | kernel (in-kernel Philox draw, cuda engine only)
    # auto resolves as the JAX factory does: fwd_fwd under parity, else adjoint
    hessian_mode: str = "auto"  # auto | fwd_fwd (reference) | fwd_rev | sensitivity | adjoint | gn (Gauss-Newton)
    engine: str = "auto"  # auto | torch | cuda
    sigma_mode: str = "auto"  # auto | eigh | ns | ns_pallas (K8 on the cuda engine)
    # render mode: re-sample env params + reset the controller whenever an
    # episode ends inside the recording
    render_reset_on_done: bool = False
    total_steps: int = 300 * 4 * 10
    seed: int = 1
    results_dir: str = "results"
    # per-solve health metrics (ESS, cost quantiles, Sigma conditioning)
    # written as JSONL by eval mode (runtime/metrics.py)
    metrics: bool = False
    # torch.profiler trace directory of bench mode; empty = no trace
    trace_dir: str = ""
    # eval mode: run under the failure-detecting supervisor
    # (runtime/supervisor.py): chunked episodes, checkpoint/resume,
    # numeric and backend failure recovery
    supervised: bool = False
    checkpoint_dir: str = ""  # supervisor checkpoints; empty = results_dir/ckpt_<name>
    chunk_episodes: int = 4  # supervisor recovery granularity

    # the port's device: "cuda" (the card) or "cpu"
    device: str = "cuda"

    def __post_init__(self):
        if self.engine in JAX_ENGINES:
            raise ValueError(
                f"engine {self.engine!r} is the JAX package's; the port's "
                f"counterpart is {JAX_ENGINES[self.engine]!r} (one of {ENGINES})")
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r} (one of {ENGINES})")
