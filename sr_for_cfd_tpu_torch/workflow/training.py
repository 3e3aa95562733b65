"""SR autoencoder training pipeline (counterpart of
`sr_for_cfd_tpu/workflow/training.py`).

Rebuilds the reference's training notebook (sr-ae-conv.ipynb cell 0): MSE
loss, Adam with the Keras default LR 1e-3, 500 epochs, batch 8,
component-specific standardization computed on the train split, per-BC
Reynolds train/test/evaluate config, and MAE/NMAE evaluation in physical
units.

Parity with the JAX package:
* the epoch batches are the JAX package's: `np.random.default_rng(seed)`
  draws one permutation per epoch, tiled and cut to steps x batch, in
  blocks of `log_every` epochs;
* `Adam` is `optax.adam`'s update in optax's order of operations;
* a fresh model is initialised as Flax initialises it
  (`models.autoencoder.flax_init_`);
* the JAX package runs a block of `log_every` epochs as one dispatch.
  Here the host enqueues a block's steps and never waits inside it: each
  epoch's mean loss and the `keep_best` choice (mean < best: copy the
  weights) stay on the device, and the host reads the block's epoch
  means once.

Training and evaluation run with TF32 off (`sr.inference._no_tf32`), as
SR inference does: cuDNN's convolutions would otherwise round to TF32.

Data-parallel training (`mesh=`, a `parallel.mesh.Mesh` over the ranks of a
process group, as the JAX package shards its batches over the mesh's 'dp'
axis): the global batch is rounded up to a multiple of the ranks, every rank
draws the same batches and takes its contiguous block of each, and the
gradients and the loss are summed over the ranks with one `all_reduce` a
step and divided by the number of ranks, so that the update is that of the
global batch mean. The weights stay the same on every rank.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from ..models import standardize as stz
from ..models.autoencoder import LATENT_DIM, SuperResolutionAE, flax_init_
from ..sr.inference import _no_tf32
from ..utils.timing import StepTimer, trace_annotation

# Reference training config (sr-ae-conv.ipynb: EPOCHS=500, BATCH_SIZE=8,
# LATENT_DIM=50, Adam default LR).
DEFAULT_EPOCHS = 500
DEFAULT_BATCH_SIZE = 8
DEFAULT_LR = 1e-3

# Actual run's per-BC Reynolds split (sr-ae-conv.ipynb cell 0): both BC
# types hold out Re=800 for test/evaluate.
DEFAULT_REYNOLDS_CONFIG = {
    "lid_driven_cavity": {"train": "ALL_EXCEPT_TEST", "test": [800], "evaluate": [800]},
    "double_lid(u_top=1,u_bottom=1)": {"train": "ALL_EXCEPT_TEST", "test": [800], "evaluate": [800]},
}


class Adam:
    """`optax.adam(lr, b1, b2, eps)` on a list of tensors, updated in place
    in optax's order: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu,
    mu_hat = mu / (1 - b1^t), nu_hat = nu / (1 - b2^t),
    p = p + (-lr) mu_hat / (sqrt(nu_hat) + eps). The bias corrections are
    worked out in float64 and divided by as tensors (on the card PyTorch
    multiplies by a Python scalar's reciprocal)."""

    def __init__(self, params: List[torch.Tensor], learning_rate: float = DEFAULT_LR,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor]) -> None:
        b1, b2 = self.b1, self.b2
        self.count += 1
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                        1 - b2))
        like = self.mu[0]
        bc1 = torch.tensor(1 - b1 ** self.count, dtype=like.dtype, device=like.device)
        bc2 = torch.tensor(1 - b2 ** self.count, dtype=like.dtype, device=like.device)
        mu_hat = torch._foreach_div(self.mu, bc1)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(mu_hat, denom)
        with torch.no_grad():
            torch._foreach_add_(params, torch._foreach_mul(step, -self.lr))

    def to(self, device) -> "Adam":
        """A copy of the state on `device`."""
        out = Adam([], self.lr, self.b1, self.b2, self.eps)
        out.mu = [t.to(device, copy=True) for t in self.mu]
        out.nu = [t.to(device, copy=True) for t in self.nu]
        out.count = self.count
        return out


def mse_loss(module: nn.Module, x_lr: torch.Tensor, x_hr: torch.Tensor) -> torch.Tensor:
    return torch.mean((module(x_lr) - x_hr) ** 2)


def _mean_over_ranks(tensors: List[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Each tensor's mean over the ranks of `mesh`, in one all_reduce."""
    from ..parallel import mesh as ring

    flat = ring.psum(torch.cat([t.reshape(-1) for t in tensors]), mesh)
    flat = flat / torch.tensor(mesh.size, dtype=flat.dtype, device=flat.device)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def train_step(module: nn.Module, opt: Adam, x_lr: torch.Tensor,
               x_hr: torch.Tensor, mesh=None) -> torch.Tensor:
    """One MSE step with its Adam update of the module's weights in place;
    returns the loss (a device tensor, not read). With `mesh`, x_lr and
    x_hr are this rank's block of the batch, and the gradients and the loss
    are averaged over the ranks before the update."""
    params = list(module.parameters())
    loss = mse_loss(module, x_lr, x_hr)
    grads = list(torch.autograd.grad(loss, params))
    loss = loss.detach()
    if mesh is not None:
        *grads, loss = _mean_over_ranks(grads + [loss], mesh)
    opt.update(params, grads)
    return loss


@dataclass
class TrainResult:
    params: Dict[str, torch.Tensor]  # the kept weights (the model's state_dict)
    model: nn.Module  # the SuperResolutionAE holding them
    loss_history: List[float] = field(default_factory=list)
    stats: Dict[str, float] = field(default_factory=dict)
    seconds: float = 0.0
    best_epoch: int = -1
    best_loss: float = float("inf")


def split_by_reynolds_config(
    res: np.ndarray, bc_types: np.ndarray,
    reynolds_config: Optional[Dict] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(train_mask, test_mask) per sample from the per-BC config
    (sr-ae-conv.ipynb cell 0 'user control panel'). 'ALL' trains on every
    Re of that BC; 'ALL_EXCEPT_TEST' excludes the test list; otherwise an
    explicit Re list."""
    if reynolds_config is None:
        reynolds_config = DEFAULT_REYNOLDS_CONFIG
    train = np.zeros(len(res), dtype=bool)
    test = np.zeros(len(res), dtype=bool)
    for bc in np.unique(bc_types):
        cfg = reynolds_config.get(str(bc))
        bc_mask = bc_types == bc
        if cfg is None:
            train |= bc_mask  # unknown BC: train on everything
            continue
        test_res = set(cfg.get("test", []))
        spec = cfg.get("train", "ALL")
        if spec == "ALL":
            train |= bc_mask
        elif spec == "ALL_EXCEPT_TEST":
            train |= bc_mask & ~np.isin(res, list(test_res))
        else:
            train |= bc_mask & np.isin(res, list(spec))
        test |= bc_mask & np.isin(res, list(test_res))
    return train, test


def standardize_train_test(
    x_lr, x_hr, comps, train_mask, lr_dim: int, hr_dim: int
) -> Tuple[np.ndarray, np.ndarray, Dict[str, float]]:
    """Component-specific standardization fitted on the train split and
    applied everywhere (sr-ae-conv.ipynb cell 0). Returns standardized
    (x_lr, x_hr) and the stats dict in the reference's key convention."""
    stats: Dict[str, float] = {}
    stats.update(stz.compute_component_stats(x_lr[train_mask, ..., 0], comps[train_mask], lr_dim))
    stats.update(stz.compute_component_stats(x_hr[train_mask, ..., 0], comps[train_mask], hr_dim))
    x_lr = x_lr.copy()
    x_hr = x_hr.copy()
    for comp in stz.COMPONENTS:
        m = comps == comp
        if not m.any():
            continue
        mean_lr, std_lr = stats[f"mean{lr_dim}_{comp}"], stats[f"std{lr_dim}_{comp}"]
        mean_hr, std_hr = stats[f"mean{hr_dim}_{comp}"], stats[f"std{hr_dim}_{comp}"]
        x_lr[m] = stz.standardize_with_stats(x_lr[m], mean_lr, std_lr)
        x_hr[m] = stz.standardize_with_stats(x_hr[m], mean_hr, std_hr)
    return x_lr, x_hr, stats


def epoch_indices(rng: np.random.Generator, n: int, steps: int, batch_size: int,
                  block: int) -> np.ndarray:
    """(block, steps, batch) sample indices of a block of epochs, drawn as
    the JAX package draws them (wrap-around when n < batch_size)."""
    per_epoch = steps * batch_size
    reps = -(-per_epoch // n)
    return np.stack([
        np.tile(rng.permutation(n), reps)[:per_epoch].reshape(steps, batch_size)
        for _ in range(block)
    ]).astype(np.int32)


def _fit(module: nn.Module, x_lr: np.ndarray, x_hr: np.ndarray,
         epochs: int = DEFAULT_EPOCHS, batch_size: int = DEFAULT_BATCH_SIZE,
         learning_rate: float = DEFAULT_LR, seed: int = 0, verbose: bool = True,
         log_every: int = 50, keep_best: bool = True, device="cuda",
         mesh=None) -> TrainResult:
    """Train `module` (its weights as given) in place; see
    `train_sr_autoencoder`."""
    from ..utils.device import resolve_device

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    module = module.to(device)
    params = list(module.parameters())
    opt = Adam(params, learning_rate)
    mine = slice(None)
    if mesh is not None:
        from ..parallel.mesh import batch_sharding

        # round the batch up to a multiple of the ranks (the JAX package's
        # rule: floor division would shrink the requested global batch)
        batch_size = -(-batch_size // mesh.size) * mesh.size
        mine = batch_sharding(mesh, mesh.axis_names[0]).block(batch_size)
    n = x_lr.shape[0]
    steps = max(1, n // batch_size)
    timer = StepTimer()
    history: List[float] = []
    block_size = max(1, log_every)
    x_lr_d = torch.as_tensor(x_lr, dtype=torch.float32, device=device)
    x_hr_d = torch.as_tensor(x_hr, dtype=torch.float32, device=device)
    best_loss = torch.tensor(float("inf"), dtype=torch.float32, device=device)
    best_epoch = torch.tensor(-1, dtype=torch.int32, device=device)
    best_params = [p.detach().clone() for p in params]
    epoch = 0
    with timer.phase("fit"), _no_tf32():
        while epoch < epochs:
            block = min(block_size, epochs - epoch)
            idx = torch.as_tensor(epoch_indices(rng, n, steps, batch_size, block),
                                  dtype=torch.long).to(device, non_blocking=True)
            means = []
            with trace_annotation("training.block"):
                for e in range(block):
                    losses = torch.stack([
                        train_step(module, opt, x_lr_d[idx[e, s, mine]],
                                   x_hr_d[idx[e, s, mine]], mesh)
                        for s in range(steps)])
                    mean = torch.mean(losses)
                    better = mean < best_loss
                    with torch.no_grad():
                        for bp, p in zip(best_params, params):
                            bp.copy_(torch.where(better, p, bp))
                    best_loss = torch.where(better, mean, best_loss)
                    best_epoch = torch.where(better, torch.tensor(
                        epoch + e, dtype=torch.int32, device=device), best_epoch)
                    means.append(mean)
                # the one host read of the block
                history.extend(torch.stack(means).cpu().tolist())
            epoch += block
            if verbose:
                print(f"  epoch {epoch}/{epochs} "
                      f"recon_loss={history[-1]:.6f}", flush=True)
        if keep_best:
            with torch.no_grad():
                for p, bp in zip(params, best_params):
                    p.copy_(bp)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return TrainResult(
        params=module.state_dict(), model=module, loss_history=history,
        seconds=timer.totals["fit"], best_epoch=int(best_epoch.item()),
        best_loss=float(best_loss.item()),
    )


def train_sr_autoencoder(
    x_lr: np.ndarray,  # (N, lr, lr, 1) standardized
    x_hr: np.ndarray,  # (N, hr, hr, 1) standardized
    lr_dim: int,
    hr_dim: int,
    epochs: int = DEFAULT_EPOCHS,
    batch_size: int = DEFAULT_BATCH_SIZE,
    learning_rate: float = DEFAULT_LR,
    latent_dim: int = LATENT_DIM,
    seed: int = 0,
    mesh=None,
    verbose: bool = True,
    log_every: int = 50,
    keep_best: bool = True,
    device="cuda",
) -> TrainResult:
    """Train a SuperResolutionAE, initialised from `seed` as Flax
    initialises it, with shuffled mini-batches and MSE. With `keep_best`
    the weights of the epoch with the lowest mean loss are kept. With
    `mesh` (`parallel.mesh.make_mesh`), data-parallel over its ranks (see
    the module docstring): every rank of the mesh makes the call."""
    module = SuperResolutionAE(lr_dim, hr_dim, latent_dim)
    flax_init_(module, torch.Generator().manual_seed(seed))
    return _fit(module, x_lr, x_hr, epochs=epochs, batch_size=batch_size,
                learning_rate=learning_rate, seed=seed, verbose=verbose,
                log_every=log_every, keep_best=keep_best, device=device,
                mesh=mesh)


def _predict(model: nn.Module, params, x: np.ndarray) -> np.ndarray:
    """model(x) with `params` (a state_dict; None: the model's own) on the
    model's device, TF32 off."""
    device = next(model.parameters()).device
    xt = torch.as_tensor(x, dtype=torch.float32, device=device)
    with torch.no_grad(), _no_tf32():
        out = model(xt) if params is None else functional_call(model, params, (xt,))
    return out.cpu().numpy()


def evaluate_for_re(
    re: float,
    model: nn.Module,
    params,
    x_lr_test: np.ndarray,
    x_hr_test: np.ndarray,
    res_test: np.ndarray,
    comps_test: np.ndarray,
    stats: Dict[str, float],
    lr_dim: int,
    hr_dim: int,
    plot_dir: Optional[str] = None,
    verbose: bool = True,
) -> Dict:
    """Per-sample MAE and NMAE% in physical units after inverse
    standardization (reference `evaluate_for_re`, sr-ae-conv.ipynb cell 0).
    NMAE% = MAE / (data range) x 100. `params` is a state_dict for `model`
    (None: its own weights). `plot_dir` writes each sample's 4-panel
    comparison `sr_Re{re}_{comp}.png` there (needs matplotlib)."""
    idx = np.where(res_test == re)[0]
    results = []
    for i in idx:
        comp = str(comps_test[i])
        mean_lr, std_lr = stats[f"mean{lr_dim}_{comp}"], stats[f"std{lr_dim}_{comp}"]
        mean_hr, std_hr = stats[f"mean{hr_dim}_{comp}"], stats[f"std{hr_dim}_{comp}"]
        pred_norm = _predict(model, params, x_lr_test[i : i + 1])[0, ..., 0]
        pred = stz.inverse_standardize(pred_norm, mean_hr, std_hr)
        truth = stz.inverse_standardize(x_hr_test[i, ..., 0], mean_hr, std_hr)
        mae = float(np.mean(np.abs(truth - pred)))
        rng_ = float(truth.max() - truth.min())
        nmae = mae / rng_ * 100 if rng_ > 0 else float("inf")
        results.append({"component": comp, "mae": mae, "nmae_pct": nmae})
        if verbose:
            print(f"  Re={re} {comp.upper()}: MAE={mae:.4f} NMAE={nmae:.2f}%")
        if plot_dir:
            from ..utils.naming import fmt_re
            from ..viz.plots import plot_superres_comparison

            os.makedirs(plot_dir, exist_ok=True)
            lr_truth = stz.inverse_standardize(x_lr_test[i, ..., 0], mean_lr, std_lr)
            plot_superres_comparison(
                lr_truth, truth, pred, re, comp,
                (lr_dim, lr_dim), (hr_dim, hr_dim), mae, nmae,
                filename=f"{plot_dir}/sr_Re{fmt_re(re)}_{comp}.png",
            )
    if results:
        avg_mae = float(np.mean([r["mae"] for r in results]))
        avg_nmae = float(np.mean([r["nmae_pct"] for r in results]))
    else:
        avg_mae = avg_nmae = float("nan")
    if verbose:
        print(f"  Average MAE: {avg_mae:.4f} | Average NMAE: {avg_nmae:.2f}%")
    return {"per_sample": results, "avg_mae": avg_mae, "avg_nmae_pct": avg_nmae}


def evaluate_shipped_model(
    lr_dim: int,
    hr_dim: int,
    suffix: str,
    data_files: List[str],
    eval_re: float = 800,
    art_dir: str = "artifacts",
    verbose: bool = False,
    device="cuda",
) -> Dict:
    """Held-out evaluation of a SHIPPED artifact pair: load the combined
    .msgpack + stats .txt by the reference naming convention
    (sr-ae-conv.ipynb export cell), standardize the held-out samples with
    the shipped stats, and return the same MAE/NMAE report as
    `evaluate_for_re`. Reads the data files with h5py."""
    from ..io.hdf5 import load_paired_reynolds_multi
    from ..sr.inference import SRModel

    stats = stz.read_stats_file(os.path.join(
        art_dir, f"standardization_stats_{lr_dim}to{hr_dim}_{suffix}.txt"))
    model = SRModel.from_checkpoint(
        os.path.join(art_dir,
                     f"vanilla_superres_{lr_dim}to{hr_dim}_{suffix}.msgpack"),
        lr_dim, hr_dim, device=device)
    x_lr, x_hr, res, comps, _ = load_paired_reynolds_multi(
        data_files, lr_dim, hr_dim)
    keep = res == eval_re
    x_lr, x_hr, res, comps = x_lr[keep], x_hr[keep], res[keep], comps[keep]
    if len(x_lr) == 0:
        raise ValueError(f"no Re={eval_re} samples in {data_files}")
    z_lr = np.empty_like(x_lr)
    z_hr = np.empty_like(x_hr)
    for comp in stz.COMPONENTS:
        m = comps == comp
        if not m.any():
            continue
        z_lr[m] = stz.standardize_with_stats(
            x_lr[m], stats[f"mean{lr_dim}_{comp}"], stats[f"std{lr_dim}_{comp}"])
        z_hr[m] = stz.standardize_with_stats(
            x_hr[m], stats[f"mean{hr_dim}_{comp}"], stats[f"std{hr_dim}_{comp}"])
    return evaluate_for_re(
        eval_re, model.module, None, z_lr, z_hr, res, comps,
        stats, lr_dim, hr_dim, verbose=verbose)


def family_artifact_paths(lr_dim: int, hr_dim: int, suffix: str,
                          art_dir: str = "artifacts") -> Dict[str, str]:
    """The complete artifact set one trained pair must ship: msgpack triple
    + Keras .h5 triple + stats .txt (reference export cell,
    sr-ae-conv.ipynb: encoder, decoder AND combined model for every pair)."""
    names = {
        "encoder": f"vanilla_encoder{lr_dim}_to_{hr_dim}_{suffix}.msgpack",
        "decoder": f"vanilla_decoder{hr_dim}_from_{lr_dim}_{suffix}.msgpack",
        "combined": f"vanilla_superres_{lr_dim}to{hr_dim}_{suffix}.msgpack",
        "encoder_h5": f"vanilla_encoder{lr_dim}_to_{hr_dim}_{suffix}.h5",
        "decoder_h5": f"vanilla_decoder{hr_dim}_from_{lr_dim}_{suffix}.h5",
        "combined_h5": f"superresolution{lr_dim}to{hr_dim}_{suffix}.h5",
        "stats": f"standardization_stats_{lr_dim}to{hr_dim}_{suffix}.txt",
    }
    return {k: os.path.join(art_dir, v) for k, v in names.items()}


def missing_family_artifacts(art_dir: str = "artifacts") -> Dict[str, List[str]]:
    """Scan art_dir for trained pairs (keyed on the combined .msgpack) and
    report which of each pair's required artifacts are absent. Empty dict
    = family complete."""
    import re as _re

    missing: Dict[str, List[str]] = {}
    pat = _re.compile(r"vanilla_superres_(\d+)to(\d+)_(.+)\.msgpack$")
    for fname in sorted(os.listdir(art_dir)):
        m = pat.match(fname)
        if not m:
            continue
        lr_dim, hr_dim, suffix = int(m.group(1)), int(m.group(2)), m.group(3)
        paths = family_artifact_paths(lr_dim, hr_dim, suffix, art_dir)
        absent = [k for k, p in paths.items() if not os.path.exists(p)]
        if absent:
            missing[f"{lr_dim}to{hr_dim}_{suffix}"] = absent
    return missing


def export_models(
    result: TrainResult,
    stats: Dict[str, float],
    lr_dim: int,
    hr_dim: int,
    suffix: str,
    out_dir: str = ".",
) -> Dict[str, str]:
    """Save encoder / decoder / combined checkpoints (Flax msgpack, read by
    the JAX package's `SRModel.from_checkpoint`) + stats .txt with the
    reference's artifact naming (sr-ae-conv.ipynb export cell), and the
    Keras .h5 triple where TensorFlow imports (`models/keras_export.py`);
    otherwise the JAX package's skip line is printed."""
    from ..io.checkpoint import params_to_jax, save_params

    os.makedirs(out_dir, exist_ok=True)
    tree = params_to_jax(result.params, lr_dim, hr_dim)
    params = tree["params"]
    paths = {
        "encoder": os.path.join(out_dir, f"vanilla_encoder{lr_dim}_to_{hr_dim}_{suffix}.msgpack"),
        "decoder": os.path.join(out_dir, f"vanilla_decoder{hr_dim}_from_{lr_dim}_{suffix}.msgpack"),
        "combined": os.path.join(out_dir, f"vanilla_superres_{lr_dim}to{hr_dim}_{suffix}.msgpack"),
        "stats": os.path.join(out_dir, f"standardization_stats_{lr_dim}to{hr_dim}_{suffix}.txt"),
    }
    save_params(paths["encoder"], {"params": params["encoder_lr"]})
    save_params(paths["decoder"], {"params": params["decoder_hr"]})
    save_params(paths["combined"], tree)
    stz.write_stats_file(paths["stats"], stats)
    # reference-compatible Keras .h5 triple: encoder + decoder +
    # combined superresolution model (optional: requires tensorflow)
    try:
        from ..models.keras_export import export_combined_h5, export_superres_h5

        paths["encoder_h5"] = os.path.join(
            out_dir, f"vanilla_encoder{lr_dim}_to_{hr_dim}_{suffix}.h5")
        paths["decoder_h5"] = os.path.join(
            out_dir, f"vanilla_decoder{hr_dim}_from_{lr_dim}_{suffix}.h5")
        export_superres_h5(tree, lr_dim, hr_dim,
                           paths["encoder_h5"], paths["decoder_h5"])
        paths["combined_h5"] = os.path.join(
            out_dir, f"superresolution{lr_dim}to{hr_dim}_{suffix}.h5")
        export_combined_h5(tree, lr_dim, hr_dim, paths["combined_h5"])
    except Exception as e:
        print(f"  (Keras .h5 export skipped: {type(e).__name__}: {e})")
    return paths
