"""Per-run artifact suite (counterpart of `sr_for_cfd_tpu/io/results.py`).

The reference's `_save_results` set: the full-field dump `{base}_full.dat`
and the centerline profile `{base}_centerline.dat`, the HDF5 group
`{base}.h5` and the plots `{base}_centerlines.png`, `{base}_contours.png`
and `{base}_convergence.png` (the last only when there is a residual
history).

The two .dat files need numpy only and are always written. The HDF5 group
needs h5py and the plots matplotlib; where one is not installed (as on a
machine with a card and neither package), its writers are skipped, each
with one printed line that names the package and the files not written.
"""

from __future__ import annotations

import os


def run_or_skip(what: str, package: str, files, write) -> bool:
    """Run `write()`; if it raises the ImportError of a missing `package`,
    print one line naming it and the files not written instead. Returns
    whether it wrote."""
    try:
        write()
    except ImportError as e:
        if e.name != package:
            raise
        print(f"  ({what} skipped: {type(e).__name__}: {e}; not written: "
              f"{', '.join(files)})", flush=True)
        return False
    return True


def save_all_results(solver, output_base_name: str) -> None:
    from ..viz.plots import _pyplot, plot_centerlines, plot_contours, plot_convergence
    from .datfiles import save_centerline_data, save_full_field
    from .hdf5 import save_fields_hdf5

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
    h5 = f"{output_base_name}.h5"
    run_or_skip("HDF5 group", "h5py", [h5], lambda: save_fields_hdf5(
        h5, solver.interior_fields(), case.mesh, re, case_name=case.case_name,
        bc_type=case.bc_label, bfs=case.bfs))
    plots = [
        (f"{output_base_name}_centerlines.png",
         lambda f: plot_centerlines(f, var, case.mesh, re)),
        (f"{output_base_name}_contours.png",
         lambda f: plot_contours(f, var, case.mesh, re,
                                 title=case.case_name.title())),
    ]
    if len(solver.residual_history):
        plots.append((f"{output_base_name}_convergence.png",
                      lambda f: plot_convergence(f, solver.residual_history, re)))

    def write_plots():
        _pyplot()  # a missing matplotlib raises before any plot is drawn
        for path, plot in plots:
            plot(path)

    run_or_skip("plots", "matplotlib", [p for p, _ in plots], write_plots)
