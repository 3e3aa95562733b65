"""Visualization suite (counterpart of `sr_for_cfd_tpu/viz/plots.py`):
centerlines, the 2x2 contour and streamline panel, convergence history,
the warm-vs-cold centerline comparison and the 4-panel SR comparison.

matplotlib (the Agg backend) is imported inside each plotting function:
the port imports without it (the card's machine has none), and a plot
without it raises an `ImportError` that names it. `format_bc_summary` and
`centerline_diff_stats` need no matplotlib.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..config import MeshParameters


def _pyplot():
    try:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError("plotting needs the matplotlib package, which is not "
                          "installed", name="matplotlib") from e
    return plt


def plot_centerlines(
    filename: str, var: np.ndarray, mesh: MeshParameters, re: float
) -> None:
    from ..io.datfiles import extract_centerlines

    plt = _pyplot()
    cl = extract_centerlines(var, mesh)
    u_center, v_center = cl["u_centerline"], cl["v_centerline"]
    y, x = cl["y"], cl["x"]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
    ax1.plot(u_center, y, "b-", linewidth=2)
    ax1.set_xlabel("U velocity")
    ax1.set_ylabel("Y")
    ax1.set_title(f"U velocity along vertical centerline (Re={re})")
    ax1.grid(True, alpha=0.3)
    ax2.plot(x, v_center, "r-", linewidth=2)
    ax2.set_xlabel("X")
    ax2.set_ylabel("V velocity")
    ax2.set_title(f"V velocity along horizontal centerline (Re={re})")
    ax2.grid(True, alpha=0.3)
    plt.tight_layout()
    plt.savefig(filename, dpi=150)
    plt.close(fig)


def plot_contours(
    filename: str,
    var: np.ndarray,
    mesh: MeshParameters,
    re: float,
    title: str = "Lid-Driven Cavity Flow",
) -> None:
    plt = _pyplot()
    x = np.linspace(0, mesh.lx, mesh.nx)
    y = np.linspace(0, mesh.ly, mesh.ny)
    X, Y = np.meshgrid(x, y)
    u = np.asarray(var[0, 1:-1, 1:-1])
    v = np.asarray(var[1, 1:-1, 1:-1])
    p = np.asarray(var[2, 1:-1, 1:-1])
    fig, axes = plt.subplots(2, 2, figsize=(12, 10))
    panels = [
        (axes[0, 0], u.T, "U Velocity", "RdBu"),
        (axes[0, 1], v.T, "V Velocity", "RdBu"),
        (axes[1, 0], p.T, "Pressure", "viridis"),
        (axes[1, 1], np.sqrt(u**2 + v**2).T, "Velocity Magnitude with Streamlines", "plasma"),
    ]
    for ax, data, ptitle, cmap in panels:
        im = ax.contourf(X, Y, data, levels=20, cmap=cmap)
        ax.set_title(ptitle)
        ax.set_xlabel("X")
        ax.set_ylabel("Y")
        ax.set_aspect("equal")
        plt.colorbar(im, ax=ax)
    axes[1, 1].streamplot(
        X, Y, u.T, v.T, color="white", linewidth=0.5, density=1.5
    )
    plt.suptitle(f"{title} (Re={re})", fontsize=16)
    plt.tight_layout()
    plt.savefig(filename, dpi=150)
    plt.close(fig)


def plot_convergence(filename: str, history, re: float) -> None:
    """Log-scale residual history (reference `_plot_convergence`,
    `PyCFD_ML_accelerated.py:639-658`); nothing for an empty history."""
    if len(history) == 0:
        return
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.plot(history.iterations, history["u"], "b-o", label="U-velocity")
    ax.plot(history.iterations, history["v"], "r-s", label="V-velocity")
    ax.plot(history.iterations, history["p"], "g-^", label="Pressure")
    ax.set_xlabel("Iteration")
    ax.set_ylabel("RMS Residual")
    ax.set_yscale("log")
    ax.set_title(f"Convergence History (Re={re})")
    ax.legend()
    ax.grid(True, which="both", ls="--", alpha=0.5)
    plt.tight_layout()
    plt.savefig(filename, dpi=150)
    plt.close(fig)


def format_bc_summary(bc) -> str:
    """Human-readable BC string for plot subtitles (reference
    `format_bc_summary`, `PyCFD_ML_accelerated.py:1186-1233`)."""
    lines = []
    for var_name, bdict in (
        ("U", bc.u_boundaries),
        ("V", bc.v_boundaries),
        ("P", bc.p_boundaries),
    ):
        parts = []
        for side in ("left", "right", "top", "bottom"):
            c = bdict[side]
            tag = "D" if c.type == "dirichlet" else "N"
            parts.append(f"{side}={tag}({c.value:g})")
        lines.append(f"{var_name}: " + ", ".join(parts))
    return " | ".join(lines)


def centerline_diff_stats(ml: Dict[str, np.ndarray],
                          normal: Dict[str, np.ndarray]) -> Dict[str, Dict[str, float]]:
    """max / mean / rms absolute differences of the two centerlines (the
    numbers `plot_centerline_comparison` returns), without a plot."""
    stats = {}
    for key, name in (("u_centerline", "U"), ("v_centerline", "V")):
        diff = np.abs(np.asarray(ml[key]) - np.asarray(normal[key]))
        stats[name] = {
            "max": float(diff.max()),
            "mean": float(diff.mean()),
            "rms": float(np.sqrt((diff**2).mean())),
        }
    return stats


def print_diff_stats(stats: Dict[str, Dict[str, float]]) -> None:
    for name, s in stats.items():
        print(f"  {name} centerline diff: max={s['max']:.6e} "
              f"mean={s['mean']:.6e} rms={s['rms']:.6e}")


def plot_centerline_comparison(
    filename: str,
    ml: Dict[str, np.ndarray],
    normal: Dict[str, np.ndarray],
    re: float,
    bc_summary: Optional[str] = None,
) -> Dict[str, Dict[str, float]]:
    """Overlay ML-accelerated vs cold-start centerlines and print max/mean/
    RMS absolute differences (reference `plot_centerline_comparison`,
    `PyCFD_ML_accelerated.py:1273-1348`). Returns the difference stats."""
    plt = _pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(14, 6))
    ax1.plot(ml["u_centerline"], ml["y"], "b-", linewidth=2, label="ML-accelerated")
    ax1.plot(
        normal["u_centerline"], normal["y"], "r--", linewidth=2, label="Normal"
    )
    ax1.set_xlabel("U velocity")
    ax1.set_ylabel("Y")
    ax1.set_title("U velocity along vertical centerline")
    ax1.legend()
    ax1.grid(True, alpha=0.3)
    ax2.plot(ml["x"], ml["v_centerline"], "b-", linewidth=2, label="ML-accelerated")
    ax2.plot(
        normal["x"], normal["v_centerline"], "r--", linewidth=2, label="Normal"
    )
    ax2.set_xlabel("X")
    ax2.set_ylabel("V velocity")
    ax2.set_title("V velocity along horizontal centerline")
    ax2.legend()
    ax2.grid(True, alpha=0.3)
    title = f"Centerline Comparison (Re={re})"
    if bc_summary:
        title += f"\n{bc_summary}"
    plt.suptitle(title)
    plt.tight_layout()
    plt.savefig(filename, dpi=150)
    plt.close(fig)

    stats = centerline_diff_stats(ml, normal)
    print_diff_stats(stats)
    return stats


def plot_superres_comparison(
    low_res_true: np.ndarray,
    high_res_true: np.ndarray,
    high_res_pred: np.ndarray,
    reynolds_num,
    component: str,
    lr_dims,
    hr_dims,
    mae_value: float,
    nmae_percentage: float,
    filename: Optional[str] = None,
) -> None:
    """4-panel SR comparison (LR truth, HR truth, prediction, signed error)
    with per-panel colorbars (sr-ae-conv.ipynb cell 0)."""
    plt = _pyplot()
    import matplotlib.gridspec as gridspec

    fig = plt.figure(figsize=(15, 8))
    gs = gridspec.GridSpec(2, 3, figure=fig, height_ratios=[1, 1])
    axes = [fig.add_subplot(gs[0, i]) for i in range(3)]
    ax3 = fig.add_subplot(gs[1, :])
    cmap = "RdBu"
    for ax, data, title in zip(
        axes,
        (low_res_true, high_res_true, high_res_pred),
        (
            f"Ground Truth ({lr_dims[1]}x{lr_dims[0]})",
            f"Ground Truth ({hr_dims[1]}x{hr_dims[0]})",
            f"Super-Resolved Prediction ({hr_dims[1]}x{hr_dims[0]})",
        ),
    ):
        im = ax.contourf(data, levels=20, cmap=cmap)
        fig.colorbar(im, ax=ax).set_label("Field Value")
        ax.set_title(title)
        ax.set_aspect("equal")
    diff = high_res_true - high_res_pred
    m = np.abs(diff).max()
    im3 = ax3.contourf(diff, levels=20, cmap=cmap, vmin=-m, vmax=m)
    fig.colorbar(im3, ax=ax3).set_label("Error")
    ax3.set_title(
        f"Difference (Error) | MAE: {mae_value:.4f} | NMAE: {nmae_percentage:.2f}%"
    )
    ax3.set_aspect("equal")
    fig.suptitle(
        f"Super-Resolution for Re={reynolds_num}, Component='{component.upper()}'",
        fontsize=16,
    )
    plt.tight_layout(rect=[0, 0, 1, 0.96])
    if filename:
        plt.savefig(filename, dpi=150)
    plt.close(fig)
