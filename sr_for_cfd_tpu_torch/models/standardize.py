"""Component-specific standardization stats (the parts of
`sr_for_cfd_tpu/models/standardize.py` that inference uses, copied so that
the port imports nothing of the JAX package).

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

STD_FLOOR = 1e-8
COMPONENTS = ("u", "v", "p")


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
