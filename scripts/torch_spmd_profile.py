"""Where the time of the port's row-decomposed solver goes, on one card.

    python3 scripts/torch_spmd_profile.py [--steps N] [--out DIR]

Runs the two one-rank `SpmdSolver` configurations of
`sr_for_cfd_tpu_torch/parallel/presets.py`, which `chip_smoke.py` drives
too (the 400^2 cavity on the per-rank sweep, the 2048^2 cavity on the
sharded V-cycle; NCCL world size 1 through a `file://` store), warms each
up for two steps,
then traces N steps (default 3) with `torch.profiler` and prints, per path:
ms per step on the host clock, the device's busy share (the union of the
CUDA kernel and memcpy intervals over the traced wall time), device time by
kernel name (top 12), host time by operator (top 12), and the step's time
split by the step's `record_function` spans (`spmd.momentum`,
`spmd.pressure`, `spmd.rest`, host time inclusive). Needs a CUDA
card; with --out, writes the chrome traces under DIR.
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def busy_share(events, wall_us):
    """Union of device intervals over the wall time."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / wall_us


def profile_path(name, kw, steps, out_dir):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from sr_for_cfd_tpu_torch import SpmdSolver
    from sr_for_cfd_tpu_torch.parallel import presets

    solver = SpmdSolver(presets.cavity_case(kw, 1000), device="cuda")
    for _ in range(2):
        solver.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        counts = []
        for _ in range(steps):
            with record_function("spmd.step"):
                counts.append(solver.step())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, f"spmd_{name}.json"))
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    # the device side of the record_function spans is an annotation, not work
    dev = [e for e in events if e.device_type == cuda and not e.name.startswith("spmd.")]
    share = busy_share(dev, wall * 1e6)
    by_kernel = {}
    for e in dev:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
    top_dev = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    host = [(a.key, a.self_cpu_time_total, a.count) for a in prof.key_averages()
            if not a.key.startswith("spmd.")]
    top_host = sorted(host, key=lambda r: -r[1])[:12]
    spans = {}
    for e in events:
        if e.device_type != cuda and e.name.startswith("spmd."):
            spans[e.name] = spans.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    out = dict(path=name, steps=steps, ms_per_step=1e3 * wall / steps,
               device_busy_share=share, inner_counts=counts,
               host_ms_per_step_by_span=spans,
               device_ms_per_step=sum(by_kernel.values()) / 1e3 / steps,
               device_ms_per_step_by_kernel={k: v / 1e3 / steps for k, v in top_dev},
               host_self_ms_per_step_by_op={k: (t / 1e3 / steps, c // steps)
                                            for k, t, c in top_host})
    print(json.dumps(out, indent=1), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import subprocess

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    import torch.distributed as dist

    from sr_for_cfd_tpu_torch.ops import kernel_lib
    from sr_for_cfd_tpu_torch.parallel import mesh, presets

    kernel_lib.load_library()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    store = tempfile.mkdtemp(prefix="srcfd_prof_")
    mesh.init_single_rank("cuda", store)
    try:
        profile_path("sweeps_400", presets.SWEEPS_400, args.steps, args.out)
        profile_path("multigrid_2048", presets.MULTIGRID_2048, args.steps, args.out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
