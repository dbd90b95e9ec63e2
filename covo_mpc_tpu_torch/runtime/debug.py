"""Debug mode: eager episodes and non-finite trapping.

Counterpart of :mod:`covo_mpc_tpu.runtime.debug`. JAX's debug mode turns
on ``jax_debug_nans`` and may disable ``jit`` for a scope; the port's
counterparts of those two halves:

* ``disable_jit``: the episode runners (``runtime/episode.py``,
  ``runtime/render.py``) run the eager loop instead of replaying a
  captured CUDA graph, the port's ``jit``;
* ``nans``: after every solve of an eager episode, the action and the new
  mean are checked finite (a host read per step), and the first
  non-finite one raises ``FloatingPointError`` with its step index.

:func:`checked_solver` wraps one solver with the same check.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_EAGER = contextvars.ContextVar("covo_debug_eager", default=False)
_NANS = contextvars.ContextVar("covo_debug_nans", default=False)


@contextlib.contextmanager
def debug_mode(nans: bool = True, disable_jit: bool = True):
    """A scope (restored on exit) in which episodes run eagerly
    (``disable_jit``) and every solve's outputs are checked finite
    (``nans``)."""
    tokens = (_EAGER.set(disable_jit), _NANS.set(nans))
    try:
        yield
    finally:
        _EAGER.reset(tokens[0])
        _NANS.reset(tokens[1])


def jit_disabled() -> bool:
    """Whether the episode runners must run the eager loop."""
    return _EAGER.get()


def nans_checked() -> bool:
    """Whether each solve's outputs are checked finite."""
    return _NANS.get()


def check_finite(action, control_params, where: str) -> None:
    """Raise ``FloatingPointError`` naming ``where`` if the action or the
    new mean (``control_params.a_mean``, where the solver has one) holds a
    non-finite value. Reads the device."""
    for name, x in (("action", action),
                    ("a_mean", getattr(control_params, "a_mean", None))):
        if isinstance(x, torch.Tensor) and not bool(torch.isfinite(x).all()):
            raise FloatingPointError(f"{where}: non-finite {name} from the solver")


def checked_solver(solver):
    """``solve(obs, state, params, cp, info)`` that runs ``solver`` and
    raises ``FloatingPointError`` on a non-finite action or new mean."""

    def solve(obs, state, params, cp, info=None):
        action, cp, out = solver(obs, state, params, cp, info)
        check_finite(action, cp, "solve")
        return action, cp, out

    return solve
