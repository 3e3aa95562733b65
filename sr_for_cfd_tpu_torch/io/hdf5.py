"""HDF5 field storage with the reference's exact schema (counterpart of
`sr_for_cfd_tpu/io/hdf5.py`).

Group `Re{Re}_mesh{nx}x{ny}` with attrs (bc_type, case_name,
reynolds_number, nx, ny, total_points [+ lx, ly, step_height for BFS]) and
flattened row-major datasets x, y, u, v, p of the transposed interior
(`PyCFD_ML_accelerated.py:517-544`; data notebook cell 2; BFS variant
`bfs_ml_accelerated.py:722-752`). Files written here are read by the JAX
package's loader and the reference's, and the other way round.

h5py is imported inside the functions that read or write: the port
imports without it (the card's machine has none), and a call without it
raises an `ImportError` that names it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import BFSGeometry, MeshParameters
from ..utils.naming import fmt_re


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "reading or writing .h5 files needs the h5py package, which is "
            "not installed", name="h5py") from e
    return h5py


def group_name(re: float, nx: int, ny: int) -> str:
    return f"Re{fmt_re(re)}_mesh{nx}x{ny}"


def save_fields_hdf5(
    filename: str,
    fields: Dict[str, np.ndarray],  # (ny, nx) interior fields
    mesh: MeshParameters,
    re: float,
    case_name: str = "lid driven cavity",
    bc_type: str = "lid_driven_cavity",
    bfs: Optional[BFSGeometry] = None,
) -> str:
    """Append/overwrite one case group. Returns the group name."""
    h5py = _h5py()
    out_dir = os.path.dirname(filename)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    gname = group_name(re, mesh.nx, mesh.ny)
    x = np.linspace(0, mesh.lx, mesh.nx)
    y = np.linspace(0, mesh.ly, mesh.ny)
    X, Y = np.meshgrid(x, y)
    with h5py.File(filename, "a") as f:
        if gname in f:
            del f[gname]
        grp = f.create_group(gname)
        grp.attrs["bc_type"] = bc_type
        grp.attrs["case_name"] = case_name
        grp.attrs["reynolds_number"] = re
        grp.attrs["nx"] = mesh.nx
        grp.attrs["ny"] = mesh.ny
        grp.attrs["total_points"] = mesh.nx * mesh.ny
        if bfs is not None:
            grp.attrs["lx"] = mesh.lx
            grp.attrs["ly"] = mesh.ly
            grp.attrs["step_height"] = bfs.step_height
        grp.create_dataset("x", data=X.flatten())
        grp.create_dataset("y", data=Y.flatten())
        for comp in ("u", "v", "p"):
            grp.create_dataset(comp, data=np.asarray(fields[comp]).flatten())
    return gname


def load_paired_reynolds_multi(
    file_paths: List[str], lr_dim: int, hr_dim: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Multi-file paired LR/HR loader (reference training loader,
    sr-ae-conv.ipynb cell 0): pairs `Re{Re}_mesh{lr}x{lr}` with
    `Re{Re}_mesh{hr}x{hr}` groups, one sample per (Re, component), tracking
    each sample's bc_type attr.

    Returns (x_lr[N,lr,lr,1], x_hr[N,hr,hr,1], reynolds[N], components[N],
    bc_types[N]). Falls back to a dummy dataset (random HR avg-pooled to LR)
    when nothing loads, so the training pipeline runs end-to-end without
    simulation data - the reference's fake-backend behavior.
    """
    h5py = _h5py()
    xs_lr, xs_hr, res, comps, bcs = [], [], [], [], []
    for path in file_paths:
        try:
            f = h5py.File(path, "r")
        except (IOError, OSError, FileNotFoundError):
            continue
        with f:
            keys = list(f.keys())
            if not keys:
                continue

            def parse_re(k):
                try:
                    return float(k.split("_")[0][2:])
                except ValueError:
                    return None

            re_numbers = sorted(
                {parse_re(k) for k in keys if k.startswith("Re")} - {None}
            )
            for re in re_numbers:
                g_lr = f"Re{fmt_re(re)}_mesh{lr_dim}x{lr_dim}"
                g_hr = f"Re{fmt_re(re)}_mesh{hr_dim}x{hr_dim}"
                if g_lr in keys and g_hr in keys:
                    # per-GROUP bc_type (a combined file can mix BC types;
                    # a file-level read would mislabel samples and corrupt
                    # the per-BC train/test split downstream)
                    bc_type = f[g_lr].attrs.get("bc_type", "unknown")
                    for comp in ("u", "v", "p"):
                        if comp in f[g_lr] and comp in f[g_hr]:
                            xs_lr.append(
                                f[g_lr][comp][()].astype(np.float32).reshape(lr_dim, lr_dim)
                            )
                            xs_hr.append(
                                f[g_hr][comp][()].astype(np.float32).reshape(hr_dim, hr_dim)
                            )
                            res.append(re)
                            comps.append(comp)
                            bcs.append(bc_type)

    if not xs_lr:
        # dummy-data fallback: random HR fields average-pooled to LR
        if hr_dim % lr_dim != 0:
            raise ValueError("For dummy data, hr_dim must be a multiple of lr_dim.")
        n = 20
        factor = hr_dim // lr_dim
        rng = np.random.default_rng(0)
        for comp in ("u", "v", "p"):
            x_hr = rng.standard_normal((n, hr_dim, hr_dim)).astype(np.float32)
            x_lr = x_hr.reshape(n, lr_dim, factor, lr_dim, factor).mean(axis=(2, 4))
            xs_hr.extend(x_hr)
            xs_lr.extend(x_lr)
            res.extend(range(50, 50 * n + 1, 50))
            comps.extend([comp] * n)
            bcs.extend(["dummy"] * n)

    return (
        np.asarray(xs_lr, dtype=np.float32)[..., None],
        np.asarray(xs_hr, dtype=np.float32)[..., None],
        np.asarray(res),
        np.asarray(comps),
        np.asarray(bcs),
    )
