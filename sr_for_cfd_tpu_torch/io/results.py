"""Per-run artifact writer (counterpart of `sr_for_cfd_tpu/io/results.py`).

Writes the two plain-text artifacts of the reference's `_save_results`:
the full-field dump `{base}_full.dat` and the centerline profile
`{base}_centerline.dat`. The JAX package also writes an HDF5 group and
three PNGs; those writers (h5py, matplotlib) are not ported yet (ROADMAP
queue A, item A8).
"""

from __future__ import annotations

import os


def save_all_results(solver, output_base_name: str) -> None:
    from .datfiles import save_centerline_data, save_full_field

    out_dir = os.path.dirname(output_base_name)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    case = solver.case
    var = solver.Var
    re = case.fluid.Re
    save_full_field(f"{output_base_name}_full.dat", var, case.mesh, re,
                    case.settings.dt)
    save_centerline_data(f"{output_base_name}_centerline.dat", var,
                         case.mesh, re)
