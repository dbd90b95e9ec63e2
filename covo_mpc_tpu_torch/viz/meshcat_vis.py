"""3-D replay of a rendered episode in meshcat (an optional dependency).

Counterpart of :mod:`covo_mpc_tpu.viz.meshcat_vis`: replays a trace saved
by :mod:`covo_mpc_tpu_torch.runtime.render` (the same ``.npz`` channels as
JAX's): the drone's pose, the target marker, the target trajectory and the
disturbance arrow, at 1/dt frames a second (reference:
quadjax/scripts/vis.py:1-98). The geometry is primitive shapes, so no mesh
assets are needed. The helpers that build the transforms are plain numpy;
:func:`replay` needs meshcat and raises a clear ``ImportError`` without it.
"""

from __future__ import annotations

import time

import numpy as np


def _require_meshcat():
    try:
        import meshcat
        import meshcat.geometry as g
        import meshcat.transformations as tf

        return meshcat, g, tf
    except ImportError as e:
        raise ImportError(
            "meshcat is not installed; `pip install meshcat` to use the 3-D "
            "replay (plots via covo_mpc_tpu_torch.utils.plotting need nothing extra)"
        ) from e


def _quat_xyzw_to_matrix(q):
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    s = 2.0 / n if n > 0 else 0.0
    M = np.eye(4)
    M[:3, :3] = [
        [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
        [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
        [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
    ]
    return M


def _vec_to_transform(origin, vec, scale: float = 1.0):
    """Transform placing a unit +z arrow along ``vec`` at ``origin``, with
    length |vec| * scale (the force-arrow math of reference
    scripts/vis.py:14-40 — which builds this frame but then drops it and
    returns only the translation; here the rotation+scale is applied).
    """
    origin = np.asarray(origin, dtype=float)
    vec = np.asarray(vec, dtype=float)
    M = np.eye(4)
    M[:3, 3] = origin
    norm = np.linalg.norm(vec)
    if norm == 0:
        M[:3, :3] = 0.0  # zero force: collapse the arrow
        return M
    ez = vec / norm
    if ez[0] == 0 and ez[1] == 0:
        ex = np.array([1.0, 0.0, 0.0])
        ey = np.array([0.0, 1.0, 0.0]) * np.sign(ez[2])
    else:
        ex = np.array([ez[1], -ez[0], 0.0])
        ex /= np.linalg.norm(ex)
        ey = np.cross(ez, ex)
    M[:3, 0] = ex * norm * scale
    M[:3, 1] = ey * norm * scale
    M[:3, 2] = ez * norm * scale
    return M


def replay(trace: dict, dt: float = 0.02, speed: float = 1.0, url=None,
           traj_stride: int = 2, force_scale: float = 2.0):
    """Replay a rendered episode trace in a meshcat viewer: drone pose,
    target marker, green target-trajectory dots (every ``traj_stride``
    steps, reference vis.py:65-82), and the disturbance-force arrow
    (reference vis.py:92-94, scale matching its 2.0)."""
    meshcat, g, tf = _require_meshcat()
    vis = meshcat.Visualizer(url) if url else meshcat.Visualizer()

    vis["drone/body"].set_object(
        g.Box([0.1, 0.1, 0.03]), g.MeshLambertMaterial(color=0x2266CC)
    )
    vis["drone/nose"].set_object(
        g.Sphere(0.02), g.MeshLambertMaterial(color=0xCC2222)
    )
    vis["target"].set_object(
        g.Sphere(0.03), g.MeshLambertMaterial(color=0x22CC44, opacity=0.6)
    )
    # unit +z arrow (shaft + head primitives; no mesh assets needed)
    vis["disturb/shaft"].set_object(
        g.Cylinder(height=0.8, radius=0.01),
        g.MeshLambertMaterial(color=0xCC8822),
    )
    vis["disturb/head"].set_object(
        g.Sphere(0.025), g.MeshLambertMaterial(color=0xCC8822)
    )

    pos, quat, tar = trace["pos"], trace["quat"], trace["pos_tar"]
    f_disturb = trace.get("f_disturb")

    # trajectory dots: the target path actually flown (trace["pos_tar"]
    # holds the pos_traj[t] lookups, models/trajectory.py)
    for j in range(0, tar.shape[0], traj_stride):
        node = vis[f"traj/{j}"]
        node.set_object(
            g.Sphere(0.01), g.MeshLambertMaterial(color=0x00FF00, opacity=0.5)
        )
        Mj = np.eye(4)
        Mj[:3, 3] = tar[j]
        node.set_transform(Mj)

    # meshcat Cylinder is y-aligned and centered; pre-rotate to +z, offset
    shaft_local = np.eye(4)
    shaft_local[:3, :3] = [[1, 0, 0], [0, 0, -1], [0, 1, 0]]
    shaft_local[2, 3] = 0.4
    head_local = np.eye(4)
    head_local[2, 3] = 0.8
    vis["disturb/shaft"].set_transform(shaft_local)
    vis["disturb/head"].set_transform(head_local)

    for i in range(pos.shape[0]):
        M = _quat_xyzw_to_matrix(quat[i])
        M[:3, 3] = pos[i]
        vis["drone"].set_transform(M)
        nose = np.eye(4)
        nose[:3, 3] = [0.06, 0.0, 0.0]
        vis["drone/nose"].set_transform(nose)
        Mt = np.eye(4)
        Mt[:3, 3] = tar[i]
        vis["target"].set_transform(Mt)
        if f_disturb is not None:
            vis["disturb"].set_transform(
                _vec_to_transform(pos[i], f_disturb[i], force_scale)
            )
        time.sleep(dt / speed)
    return vis
