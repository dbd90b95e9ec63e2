"""Episode-trace plotting (matplotlib, imported when a plot is drawn).

Counterpart of :mod:`covo_mpc_tpu.utils.plotting`: the episode dashboard
of a rendered trace (``runtime/render.py``) and the per-episode error bars
of an eval. matplotlib is not a dependency of the port: without it, each
function raises ``ImportError`` and the command line skips the PNG.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from covo_mpc_tpu_torch.models.rotation import quat_to_rpy


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_episode(trace: dict, dt: float, path: str, title: str = "") -> str:
    """Draw the episode dashboard: pos / vel / rpy against their targets,
    omega against the commanded omega_tar, the disturbance force, the
    reward, the thrust and the per-channel action. ``trace`` is the dict
    :func:`covo_mpc_tpu_torch.runtime.render.render_episode` returns;
    channels missing from it are skipped. Returns the written path."""
    plt = _pyplot()
    T = trace["pos"].shape[0]
    t = np.arange(T) * dt
    rpy = quat_to_rpy(torch.as_tensor(np.asarray(trace["quat"]))).numpy()

    fig, axes = plt.subplots(6, 3, figsize=(15, 15), sharex=True)
    groups = [
        ("pos", trace["pos"], trace.get("pos_tar"), ["x", "y", "z"]),
        ("vel", trace["vel"], trace.get("vel_tar"), ["x", "y", "z"]),
        ("rpy", rpy, None, ["roll", "pitch", "yaw"]),
        ("omega", trace["omega"], trace.get("omega_tar"), ["x", "y", "z"]),
        ("f_disturb", trace.get("f_disturb"), None, ["x", "y", "z"]),
    ]
    for row, (name, val, tar, labels) in enumerate(groups):
        for col in range(3):
            ax = axes[row][col]
            if val is not None:
                ax.plot(t, val[:, col], label=labels[col])
            if tar is not None:
                ax.plot(t, tar[:, col], "--", label=f"{labels[col]} target")
            ax.set_ylabel(f"{name} {labels[col]}")
            ax.legend(fontsize=7)

    axes[5][0].plot(t, trace["reward"])
    axes[5][0].set_ylabel("reward")
    axes[5][1].plot(t, trace["last_thrust"])
    axes[5][1].set_ylabel("thrust [N]")
    if "action" in trace:
        for ch, lab in enumerate(["thrust", "wx", "wy", "wz"]):
            axes[5][2].plot(t, trace["action"][:, ch], label=lab)
        axes[5][2].legend(fontsize=7)
    axes[5][2].set_ylabel("action (normalized)")
    for ax in axes[5]:
        ax.set_xlabel("time [s]")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_eval_errors(err_pos_ep, path: str, label: str = "") -> str:
    """Per-episode mean tracking-error bar chart of an eval run."""
    plt = _pyplot()
    err = np.asarray(torch.as_tensor(err_pos_ep).cpu())
    fig, ax = plt.subplots(figsize=(8, 3))
    ax.bar(np.arange(len(err)), err * 100)
    ax.set_xlabel("episode")
    ax.set_ylabel("mean err_pos [cm]")
    ax.set_title(label or "evaluation")
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
