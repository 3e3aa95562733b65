"""Plain-text .dat writers matching the reference formats byte-for-layout
(a numpy-only copy of `sr_for_cfd_tpu/io/datfiles.py`, kept in the port
so that it imports nothing of the JAX package). The full-field body goes
through the native writer (`io/native_io.py`) where it builds, else the
whole file is written in Python, as in the JAX package.

Full-field dump (`LDV PyCFD given by sir.py:245-258`) and centerline
profiles (`LDV PyCFD given by sir.py:260-285`); the centerline file is the
format of the golden validation artifact `outputs/bfs_Re400_centerline.dat`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..config import MeshParameters


def extract_centerlines(
    var: np.ndarray, mesh: MeshParameters
) -> Dict[str, np.ndarray]:
    """Centerline profiles from a (3, nx+2, ny+2) field stack
    (reference `extract_centerlines`, `PyCFD_ML_accelerated.py:1236-1270`):
    u along the vertical line at x = lx/2, v along the horizontal line at
    y = ly/2."""
    u_vertical = np.asarray(var[0, mesh.nx // 2, 1:-1])
    v_horizontal = np.asarray(var[1, 1:-1, mesh.ny // 2])
    return {
        "y": np.linspace(0, mesh.ly, mesh.ny),
        "u_centerline": u_vertical,
        "x": np.linspace(0, mesh.lx, mesh.nx),
        "v_centerline": v_horizontal,
    }


def _full_field_header(mesh: MeshParameters, re: float, dt: float) -> str:
    return f"# Reynolds number: {re}\n# Mesh: {mesh.nx}x{mesh.ny}\n# Time step: {dt}\n"


def save_full_field_python(
    filename: str, var: np.ndarray, mesh: MeshParameters, re: float, dt: float
) -> None:
    """The whole full-field file written in Python (the fallback)."""
    nvar = var.shape[0]
    var_names = ["U", "V", "P"]
    with open(filename, "w") as f:
        f.write(_full_field_header(mesh, re, dt))
        for k in range(nvar):
            name = var_names[k] if k < 3 else "?"
            f.write(f"\n# ########## {name} velocity ############ \n")
            for i in range(mesh.nx + 2):
                for j in range(mesh.ny + 2):
                    f.write(f"{var[k, i, j]:.6f} \t")
                f.write("\n")


def save_full_field(
    filename: str, var: np.ndarray, mesh: MeshParameters, re: float, dt: float
) -> None:
    """The header in Python, the body through the native writer; where that
    is unavailable or fails, the whole file rewritten in Python (a failed
    native attempt may have appended part of a body)."""
    from . import native_io

    with open(filename, "w") as f:
        f.write(_full_field_header(mesh, re, dt))
    if native_io.append_field_sections(filename, np.asarray(var)):
        return
    native_io.used["python"] += 1
    save_full_field_python(filename, var, mesh, re, dt)


def save_centerline_data(
    filename: str, var: np.ndarray, mesh: MeshParameters, re: float
) -> None:
    cl = extract_centerlines(var, mesh)
    y, u_v = cl["y"], cl["u_centerline"]
    x, v_h = cl["x"], cl["v_centerline"]
    with open(filename, "w") as f:
        f.write(f"# Reynolds number: {re}\n")
        f.write(f"# Mesh: {mesh.nx}x{mesh.ny}\n")
        f.write("# Centerline data\n")
        f.write("# y\tu(x=0.5)\tx\tv(y=0.5)\n")
        for i in range(max(len(y), len(x))):
            if i < len(y):
                f.write(f"{y[i]:.6f}\t{u_v[i]:.6f}\t")
            else:
                f.write("\t\t")
            if i < len(x):
                f.write(f"{x[i]:.6f}\t{v_h[i]:.6f}")
            f.write("\n")



def load_centerline_dat(filename: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Parse a centerline .dat back into (y, u, x, v) arrays (for golden
    regression tests against reference artifacts)."""
    ys, us, xs, vs = [], [], [], []
    with open(filename) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split("\t")
            if len(parts) >= 2 and parts[0].strip():
                ys.append(float(parts[0]))
                us.append(float(parts[1]))
            if len(parts) >= 4 and parts[2].strip():
                xs.append(float(parts[2]))
                vs.append(float(parts[3]))
    return np.array(ys), np.array(us), np.array(xs), np.array(vs)
