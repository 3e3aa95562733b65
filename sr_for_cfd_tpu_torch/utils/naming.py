"""Artifact naming conventions and run directories.

The reference encodes the full experiment config in file names
(`{case}_Re{Re}_{nx}x{ny}_{iters}_{coarse|fine...}` patterns) and creates
timestamped run directories `outputs/dd-mm-YYYY-H-M-S`
(`PyCFD_ML_accelerated.py:21-34,746,1441-1460`). Reproduced here so runs are
drop-in comparable with reference artifacts. A copy of
`sr_for_cfd_tpu/utils/naming.py`, kept in the port so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

import os
from datetime import datetime


def fmt_re(re: float) -> str:
    """Format a Reynolds number the way the reference's f-strings do for the
    ints it passes around (Re=400 -> '400', Re=412.5 -> '412.5')."""
    f = float(re)
    return str(int(f)) if f.is_integer() else str(f)


def create_timestamped_output_dir(base_dir: str = "outputs") -> str:
    """`outputs/dd-mm-YYYY-H-M-S` run directory
    (`PyCFD_ML_accelerated.py:21-34`)."""
    stamp = datetime.now().strftime("%d-%m-%Y-%H-%M-%S")
    out = os.path.join(base_dir, stamp)
    os.makedirs(out, exist_ok=True)
    return out


def coarse_run_name(
    output_dir: str, case: str, re: float, lr_dim: int, max_iterations: int
) -> str:
    return os.path.join(
        output_dir,
        f"{case}coarse_Re{fmt_re(re)}_{lr_dim}x{lr_dim}_{max_iterations}_coarse_iterations",
    )


def fine_run_name(
    output_dir: str,
    case: str,
    re: float,
    nx: int,
    ny: int,
    coarse_iters,
    fine_iters: int,
    kind: str,
) -> str:
    """Reference fine-phase artifact base names
    (`PyCFD_ML_accelerated.py:1441-1460`): kind 'ML' (the solver appends
    '_accelerated') or 'NORMAL' (appends '_normal'); `coarse_iters=None`
    omits the coarse segment - the NORMAL run has no coarse phase.

    NORMAL has no `fine` token either: the reference names the normal run
    `..._{max_iterations_normal}_NORMAL` (`PyCFD_ML_accelerated.py:1455-1460`),
    so conventional-artifact pickup by name finds reference-produced
    NORMAL outputs too."""
    coarse = "" if coarse_iters is None else f"{coarse_iters}_coarse_"
    fine = "" if kind == "NORMAL" else "fine_"
    return os.path.join(
        output_dir,
        f"{case}_Re{fmt_re(re)}_{nx}x{ny}_{coarse}{fine_iters}_{fine}{kind}",
    )



def default_model_files(lr_dim: int, hr_dim: int, suffix: str, model_dir: str = "."):
    """Reference model-artifact naming convention
    (`PyCFD_ML_accelerated.py:1069-1074`): the stats file and the split
    Keras encoder and decoder."""
    return {
        "stats_file": os.path.join(
            model_dir, f"standardization_stats_{lr_dim}to{hr_dim}_{suffix}.txt"
        ),
        "encoder_file": os.path.join(
            model_dir, f"vanilla_encoder{lr_dim}_to_{hr_dim}_{suffix}.h5"
        ),
        "decoder_file": os.path.join(
            model_dir, f"vanilla_decoder{hr_dim}_from_{lr_dim}_{suffix}.h5"
        ),
    }
