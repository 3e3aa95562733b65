"""The port's six main paths on two trees in one call, for an A/B on one card.

    python3 scripts/torch_ab_paths.py TREE [TREE ...] [--out DIR] [--paths NAME ...]

Each TREE is the root of a checkout of the repository (for example the
parent commit and the change unpacked with `git archive`, given in the
order parent, change, change, parent). For each, in its own process run
from that root, the script builds the tree's kernels, makes the one-rank
NCCL group and runs the six main paths of that tree's `chip_smoke.py`
(non-fused BFS, north star, big-grid cavity, tiled cavity, SPMD sweeps,
SPMD multigrid) without its gates, so that both trees' paths run on the
same card in one machine. Each path prints its ms/iter, inner counts and
launches per step as `chip_smoke.py` does; with --out, each side's log is
written under DIR too; --paths runs only the named paths (`chip_smoke.py`'s
phase functions, e.g. phase_big_grid), so that more sides fit one call;
`--paths phase_kernels` runs rows 1 and 2's gates instead (their kernel,
plain and stage-form times). Needs a CUDA card; exits non-zero if a side
fails.
"""

import argparse
import os
import subprocess
import sys

PATHS = ("phase_non_fused", "phase_north_star", "phase_big_grid", "phase_tiled",
         "phase_spmd_sweeps", "phase_spmd_multigrid")

# run inside one tree: its chip_smoke.py's build, process group and paths
SIDE = """
import os, sys, tempfile
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from sr_for_cfd_tpu_torch.ops import kernel_lib
from sr_for_cfd_tpu_torch.parallel import mesh
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
kernel_lib.build(force=True)
kernel_lib.load_library()
os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
mesh.init_single_rank("cuda", tempfile.mkdtemp(prefix="srcfd_ab_"))
for name in %r:
    getattr(cs, name)("cuda")
    torch.cuda.synchronize()
torch.distributed.destroy_process_group()
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--out", default=None)
    ap.add_argument("--paths", nargs="+", choices=PATHS + ("phase_kernels",),
                    default=list(PATHS))
    args = ap.parse_args()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    for i, tree in enumerate(args.trees):
        root = os.path.abspath(tree)
        print(f"SIDE {i + 1} {tree}", flush=True)
        run = subprocess.run([sys.executable, "-c", SIDE % (tuple(args.paths),)], cwd=root,
                             capture_output=True, text=True, timeout=1200)
        lines = [ln for ln in run.stdout.splitlines() + run.stderr.splitlines()
                 if "ms/iter" in ln or ": kernel " in ln or "Error" in ln or "FAIL" in ln]
        print("\n".join(lines), flush=True)
        if args.out:
            name = f"side{i + 1}_{os.path.basename(root.rstrip('/'))}.log"
            with open(os.path.join(args.out, name), "w") as f:
                f.write(run.stdout + run.stderr)
        if run.returncode != 0:
            print(f"SIDE {i + 1} {tree}: exit {run.returncode}\n{run.stderr[-2000:]}")
            sys.exit(1)


if __name__ == "__main__":
    main()
