"""Solve-quality metrics and a JSONL sink.

Counterpart of :mod:`covo_mpc_tpu.runtime.metrics`: per solve, the cost
statistics, the effective sample size of the importance weights and the
conditioning of CoVO's Sigma, the quantities that say whether a
sampling-based MPC is healthy. Every statistic reduces over the last axis
(the samples), so a leading scenario or step axis gives one value each;
:func:`solve_metrics_sharded` also reduces over a mesh axis, from the
shards' partials.

:func:`sigma_metrics` takes Sigma's eigenvalues. ``torch.linalg.eigvalsh``
checks its result on the host, so it cannot run inside a CUDA graph: under
:func:`deferred_sigma` (the episode runners' scope) it returns Sigma itself
under the key ``"sigma"``, the runner stacks the episode's Sigmas, and
:func:`resolve_sigma` computes their metrics in one batched call after the
episode.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import time
from typing import Optional

import torch

SIGMA = "sigma"
_DEFERRED = contextvars.ContextVar("covo_sigma_metrics_deferred", default=False)


def quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q`` quantile over the last axis with linear interpolation at
    ``q (n - 1)`` (``jnp.quantile``'s default): a sort and two gathers at a
    static index, so it runs inside a CUDA graph."""
    n = x.shape[-1]
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    w = pos - lo
    s = torch.sort(x, dim=-1).values
    return s[..., lo] * (1.0 - w) + s[..., hi] * w


def solve_metrics(costs: torch.Tensor, weights: torch.Tensor) -> dict:
    """Per-solve health metrics over the sample axis (scalars for one solve)."""
    return {
        "cost_min": torch.amin(costs, dim=-1),
        "cost_mean": torch.mean(costs, dim=-1),
        "cost_p90": quantile(costs, 0.9),
        # effective sample size of the exponential weights: 1 / sum(w^2);
        # N means uniform (lambda too large), 1 means collapse (too small)
        "ess": 1.0 / torch.sum(weights**2, dim=-1),
    }


def solve_metrics_sharded(costs, weights, axis, n_total) -> dict:
    """:func:`solve_metrics` as the batched and sharded solves report it:
    min, mean and max of the costs and the ESS. ``axis=None``: each
    scenario's samples lie on this device. ``axis`` a bound mesh axis
    (``parallel.mesh.Mesh.axis``): each rank holds its slice of the
    samples, and the statistics come from all-reduced shard partials
    (min, sum, max of the costs, the sum of the squared weights) over
    ``n_total`` samples; ``weights`` must already be normalized over all
    of them. The exact p90 would need a global sort: cost_max takes its
    place, as in JAX."""
    if axis is None:
        return {
            "cost_min": torch.amin(costs, dim=-1),
            "cost_mean": torch.mean(costs, dim=-1),
            "cost_max": torch.amax(costs, dim=-1),
            "ess": 1.0 / torch.sum(weights**2, dim=-1),
        }
    if isinstance(axis, str):
        raise TypeError(f"solve_metrics_sharded: axis {axis!r} is a name; pass the bound "
                        "axis, mesh.axis(name) (parallel/mesh.py)")
    return {
        "cost_min": axis.pmin(torch.amin(costs, dim=-1)),
        "cost_mean": axis.psum(torch.sum(costs, dim=-1)) / n_total,
        "cost_max": axis.pmax(torch.amax(costs, dim=-1)),
        "ess": 1.0 / axis.psum(torch.sum(weights**2, dim=-1)),
    }


def sigma_metrics(a_cov: torch.Tensor) -> dict:
    """Conditioning of the sampling covariance (CoVO's Sigma health) from
    its eigenvalues, clamped at 1e-12; a leading axis gives one value per
    matrix. Under :func:`deferred_sigma` returns ``{"sigma": a_cov}``."""
    if _DEFERRED.get():
        return {SIGMA: a_cov}
    eigs = torch.linalg.eigvalsh(a_cov)
    return {
        "sigma_cond": eigs[..., -1] / torch.clamp(eigs[..., 0], min=1e-12),
        "sigma_logdet": torch.sum(torch.log(torch.clamp(eigs, min=1e-12)), dim=-1),
    }


@contextlib.contextmanager
def deferred_sigma():
    """A scope in which :func:`sigma_metrics` hands Sigma back instead of
    its eigenvalues (restored on exit)."""
    token = _DEFERRED.set(True)
    try:
        yield
    finally:
        _DEFERRED.reset(token)


def resolve_sigma(metrics: dict) -> dict:
    """``metrics`` with a deferred ``"sigma"`` stack (T, D, D) replaced by
    its :func:`sigma_metrics`, (T,) each, in one batched eigensolve."""
    if SIGMA not in metrics:
        return metrics
    out = {k: v for k, v in metrics.items() if k != SIGMA}
    token = _DEFERRED.set(False)
    try:
        out.update(sigma_metrics(metrics[SIGMA]))
    finally:
        _DEFERRED.reset(token)
    return out


class MetricsLogger:
    """JSONL metrics sink with wall-clock stamps.

    The file is opened at the first ``log`` (truncating any previous run's
    records: re-running an eval with the same ``--name`` must not
    accumulate stale rows) and kept open across records; ``close`` flushes.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records = []
        self._fh = None

    def log(self, step: int, **values):
        rec = {"step": step, "t": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self.records.append(rec)
        if self.path:
            if self._fh is None:
                self._fh = open(self.path, "w")
            self._fh.write(json.dumps(rec) + "\n")

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def summary(self) -> dict:
        if not self.records:
            return {}
        keys = [k for k in self.records[-1] if k not in ("step", "t")]
        out = {}
        for k in keys:
            vals = [r[k] for r in self.records if k in r]
            out[k] = {"mean": sum(vals) / len(vals), "last": vals[-1]}
        return out
