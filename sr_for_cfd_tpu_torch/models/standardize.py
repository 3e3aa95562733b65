"""Component-specific standardization: stats computation, file round-trip,
adaptive normalization (a numpy copy of `sr_for_cfd_tpu/models/standardize.py`,
kept in the port so that it imports nothing of the JAX package; each
function gives the JAX package's values bit for bit).

The reference computes separate mean/std per component (u, v, p) x
resolution on the train split, writes them to a text file with lines
`mean{dim}_{comp} value` / `std{dim}_{comp} value`, and standardizes with a
1e-8 std floor (sr-ae-conv.ipynb cell 0; `PyCFD_ML_accelerated.py:665-673,
789-809`). The BFS workflow optionally blends the training stats with the
actual input field's stats ("adaptive normalization",
`bfs_ml_accelerated.py:1090-1100`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

STD_FLOOR = 1e-8
COMPONENTS = ("u", "v", "p")


def standardize_with_stats(arr, mean: float, std: float):
    # floor TINY stds too, not just exact zeros: a near-constant field's
    # ~1e-20 std would blow standardized values past f32 range
    std = max(abs(std), STD_FLOOR)
    return (arr - mean) / std


def inverse_standardize(arr, mean: float, std: float):
    return arr * std + mean


def dataset_standardize(arr) -> Tuple[np.ndarray, float, float]:
    """Standardize by the array's own stats (float64 accumulation, as the
    reference does); returns (standardized, mean, std)."""
    mean = float(np.mean(arr, dtype=np.float64))
    std = float(np.std(arr, dtype=np.float64))
    std = max(std, STD_FLOOR)
    return (arr - mean) / std, mean, std


def compute_component_stats(
    x: np.ndarray, components: np.ndarray, resolution: int
) -> Dict[str, float]:
    """Per-component mean/std over samples of one resolution; keys follow
    the reference's `mean{dim}_{comp}` convention."""
    stats = {}
    for comp in COMPONENTS:
        mask = components == comp
        if not mask.any():
            continue
        data = np.asarray(x)[mask]
        stats[f"mean{resolution}_{comp}"] = float(np.mean(data, dtype=np.float64))
        stats[f"std{resolution}_{comp}"] = float(np.std(data, dtype=np.float64))
    return stats


def write_stats_file(path: str, stats: Dict[str, float]) -> None:
    """Reference stats-file format (verified against
    `standardization_stats_10to400_swish_trained_upto_700_multiBC.txt`)."""
    with open(path, "w") as f:
        f.write("# Component-specific standardization statistics\n")
        f.write("# Format: mean<resolution>_<component> value\n")
        for key, value in stats.items():
            f.write(f"{key} {value}\n")


def read_stats_file(path: str) -> Dict[str, float]:
    """Parse `key value` lines, skipping comments/blank lines
    (`PyCFD_ML_accelerated.py:789-798`)."""
    stats: Dict[str, float] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) == 2:
                stats[parts[0]] = float(parts[1])
    return stats


def component_stats(
    stats: Dict[str, float], dim: int
) -> Dict[str, Tuple[float, float]]:
    """{comp: (mean, std)} for one resolution; raises KeyError naming the
    missing key like the reference's diagnostics
    (`PyCFD_ML_accelerated.py:822-825`)."""
    out = {}
    for comp in COMPONENTS:
        mk, sk = f"mean{dim}_{comp}", f"std{dim}_{comp}"
        if mk not in stats or sk not in stats:
            raise KeyError(
                f"Missing component-specific stats: required keys "
                f"mean{dim}_u/v/p and std{dim}_u/v/p; missing "
                f"{mk if mk not in stats else sk}"
            )
        out[comp] = (stats[mk], stats[sk])
    return out


def adaptive_blend(
    mean: float, std: float, field: np.ndarray, blend_factor: float
) -> Tuple[float, float]:
    """Blend training stats toward the input field's own stats
    (`bfs_ml_accelerated.py:1090-1100`): higher blend_factor = more
    adaptation to the input."""
    input_mean = float(np.mean(field))
    input_std = float(np.std(field))
    mean = (1 - blend_factor) * mean + blend_factor * input_mean
    std = (1 - blend_factor) * std + blend_factor * max(input_std, STD_FLOOR)
    return mean, std
