"""Checkpoints of solver state and results, as ``.npz`` keyed by field name.

Counterpart of :mod:`covo_mpc_tpu.runtime.checkpoint`, in the same layout:
one array per non-None field of the solver's params (a float as a 0-d
array), so a file saved by either package loads into the other, and a
schedule computed once (CoVO offline's Sigmas, max_steps x D x D, ~20 MB
at the paper's config) can be reused across runs and machines.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_solver_state(control_params, path: str) -> str:
    """Persist solver params (MPPIParams / CoVOParams / PIDParams)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves = {f.name: _numpy(getattr(control_params, f.name))
              for f in dataclasses.fields(control_params)
              if getattr(control_params, f.name) is not None}
    np.savez_compressed(path, **leaves)
    return path


def _device_of(params) -> torch.device:
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def load_solver_state(template, path: str):
    """Load into the same struct type as ``template``, field by field: a 0-d
    array as a float, any other as a row-major float32 tensor on the
    template's device, as ``covo_params_from_numpy`` and
    ``mppi_params_from_numpy`` build them. A key the struct lacks raises."""
    device = _device_of(template)
    updates = {}
    with np.load(path) as data:
        for k in data.files:
            v = data[k]
            updates[k] = (float(v) if v.ndim == 0 else
                          torch.from_numpy(np.array(v, np.float32, order="C")).to(device))
    return template.replace(**updates)


def save_eval_result(result, path: str) -> str:
    """Persist an EvalResult: the per-episode errors and their mean and std."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        path,
        err_pos_ep=_numpy(result.err_pos_ep),
        mean=result.mean,
        std=result.std,
    )
    return path
