"""Aspect-ratio coordinate remapping between rectangular and square domains.

The reference's BFS workflow resamples rectangular-domain fields into a
square coordinate system before its (cavity-trained) SR model and back
after (`bfs_ml_accelerated.py:59-145`). The array shape is unchanged - only
physical coordinates are remapped: the square system spans
[0, max(lx, ly)] in both axes, so for the 10x3 BFS domain ~70% of the
square's y-range lies OUTSIDE the data and RectBivariateSpline silently
**extrapolates** it; the post-ML inverse samples the y in [0, ly] band back
out. This module reproduces that convention exactly (SciPy kx=ky=3 splines,
host-side) for reference-parity comparisons.

A numpy/SciPy-only copy of `sr_for_cfd_tpu/sr/resample.py`, kept in the
port so that it imports nothing of the JAX package.

The default path treats the square-array fields directly as model
input ("identity" interpretation) - equivalent to the correction being a
coordinate relabeling - and stays entirely on device. `ml_super_resolution`
selects between the two via `aspect_mode` ('identity' | 'extrapolate').
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _grids(lx: float, ly: float, nx: int, ny: int):
    L = max(lx, ly)
    return (
        np.linspace(0, lx, nx), np.linspace(0, ly, ny),
        np.linspace(0, L, nx), np.linspace(0, L, ny),
    )


def rect_to_square(
    fields: Dict[str, np.ndarray], lx: float, ly: float
) -> Dict[str, np.ndarray]:
    """Reference pre-ML remap (`reshape_rectangular_to_square`,
    `bfs_ml_accelerated.py:59-101`): evaluate the rect-domain spline at
    square coordinates (extrapolating beyond the data)."""
    from scipy import interpolate

    out = {}
    for comp, field in fields.items():
        ny, nx = field.shape
        x_rect, y_rect, x_sq, y_sq = _grids(lx, ly, nx, ny)
        spline = interpolate.RectBivariateSpline(
            y_rect, x_rect, field, kx=3, ky=3
        )
        out[comp] = spline(y_sq, x_sq)
    return out


def square_to_rect(
    fields: Dict[str, np.ndarray], lx: float, ly: float
) -> Dict[str, np.ndarray]:
    """Reference post-ML inverse (`reshape_square_to_rectangular`,
    `bfs_ml_accelerated.py:104-145`)."""
    from scipy import interpolate

    out = {}
    for comp, field in fields.items():
        ny, nx = field.shape
        x_rect, y_rect, x_sq, y_sq = _grids(lx, ly, nx, ny)
        spline = interpolate.RectBivariateSpline(
            y_sq, x_sq, field, kx=3, ky=3
        )
        out[comp] = spline(y_rect, x_rect)
    return out
