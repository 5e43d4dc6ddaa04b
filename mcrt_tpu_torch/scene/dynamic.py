"""Host-side 4x4 transform helpers (counterpart of part of
``mcrt_tpu/scene/dynamic.py``): the builders place instanced shapes with
them.  (``SceneAnimator`` and refit wait for the dynamic-scenes slice.)"""
from __future__ import annotations

import numpy as np


def translation(offset) -> np.ndarray:
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = np.asarray(offset, np.float32)
    return t


def scale(factors) -> np.ndarray:
    t = np.eye(4, dtype=np.float32)
    t[0, 0], t[1, 1], t[2, 2] = np.broadcast_to(np.asarray(factors, np.float32), (3,))
    return t


def rotation_y(angle_rad: float) -> np.ndarray:
    c, s = float(np.cos(angle_rad)), float(np.sin(angle_rad))
    t = np.eye(4, dtype=np.float32)
    t[0, 0], t[0, 2], t[2, 0], t[2, 2] = c, s, -s, c
    return t
