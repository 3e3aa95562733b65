"""The host side of a loop whose exit is decided on the card.

Three loops of the port keep their exit state on the card: the tiled
pressure loop (`ops/tiled_kernels.py`, one sweep a launch of
`csrc/shard_rb.cu`'s fused form), the big-grid momentum loop
(`ops/momentum_kernels.py`) and the fused step's momentum loop
(`ops/step_kernels.py`), both k sweeps a launch of `csrc/mom_pass.cu`.
Each launch's last block takes the rms of its last sweep and runs
`rb_ops.cuh:loop_state_step` on a small device state (rms, best, stale,
checks, it, done): the unified stall policy, `it` advanced by the sweeps of
one launch, and `done` where the host loop's condition fails. Every block
of a later launch returns at once when `done` is set.

`DeviceExitLoop.run` enqueues the launches in batches and reads the state
once per batch, through pinned memory behind each batch: with `ahead`, the
next batch is enqueued before the host waits (the card does not idle while
the host reads, and a batch after the exit runs as no-op launches); without
it, a batch is enqueued only when the last one has not ended the loop. The
batch size fits each loop's usual count: 8 sweeps ahead for the tiled
pressure loop (~141 sweeps a solve), fewer and not ahead for the momentum
loops (~1.05 passes a big-grid solve, ~4.2 sweeps a north-star solve),
whose no-op launches would otherwise outnumber their passes.

`ExitState` and `exit_state_step` are the plain twin of the device state
and of `loop_state_step`, written as the C code is; the CPU tests hold them
against the host loops' `stall_update` / `stalled`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import kernel_lib
from .sweeps import STALL_MIN_CHECKS, STALL_PATIENCE, STALL_RATIO, STALL_RESET_RATIO, stalled


@dataclass
class ExitState:
    """The loop state the kernels keep on the card (csrc/rb_ops.cuh
    TiledState), in numpy float32 and ints."""

    rms: np.float32 = np.float32(np.inf)
    best: np.float32 = np.float32(np.inf)
    stale: int = 0
    checks: int = 0
    it: int = 0
    done: int = 0


def exit_state_step(s: ExitState, now: np.float32, tol: np.float32, max_iter: int,
                    per_launch: int = 1, on_best: bool = False) -> ExitState:
    """Plain twin of the kernels' last block after a launch whose last
    sweep's rms is `now`, written as `loop_state_step` is: the stall policy
    of `rb_sor_loop_small_kernel` (NaN-propagating best), `it` advanced by
    `per_launch` sweeps, then `done` when the host loop's condition fails;
    it tests the rms, or the best rms with `on_best`."""
    f = np.float32
    new_best = now < f(STALL_RESET_RATIO) * s.best
    descending = now < f(STALL_RATIO) * s.rms
    stale = 0 if new_best else (s.stale if descending else s.stale + 1)
    best = f(np.nan) if (np.isnan(s.best) or np.isnan(now)) else f(np.fmin(s.best, now))
    checks, it = s.checks + 1, s.it + per_launch
    stop = stale >= STALL_PATIENCE and checks >= STALL_MIN_CHECKS
    tested = best if on_best else now
    done = int(not (it < max_iter and tested >= tol and not stop))
    return ExitState(f(now), best, stale, checks, it, done)


def state_words(s: ExitState) -> np.ndarray:
    """An ExitState as the kernels' 8 int32 words."""
    w = np.zeros(8, dtype=np.int32)
    w[:2].view(np.float32)[:] = (s.rms, s.best)
    w[2:6] = (s.stale, s.checks, s.it, s.done)
    return w


def first_done(tol32: np.float32, max_iter: int) -> bool:
    """The host loop's condition before any sweep, failed (the rms and the
    best rms both start at inf)."""
    return not (0 < max_iter and np.float32(np.inf) >= tol32 and not stalled(0, 0))


class DeviceExitLoop:
    """The loop state on the card, its fresh value, and the pinned host
    copies and events of the batches; `run` drives one solve. `counter` is
    the wrapper whose `launches` and `reads` count the loop's launches (no-op
    ones included) and host reads."""

    def __init__(self, device, tol: float, max_iter: int, *, counter, batch: int,
                 ahead: bool, per_launch: int = 1, on_best: bool = False):
        self.device = torch.device(device)
        self.tol32, self.max_iter = np.float32(tol), int(max_iter)
        self.per_launch, self.on_best = int(per_launch), bool(on_best)
        self.batch, self.ahead, self.counter = int(batch), bool(ahead), counter
        self.lib = kernel_lib.load_library()
        self.state = torch.zeros(8, dtype=torch.int32, device=self.device)
        self.fresh = torch.from_numpy(state_words(ExitState())).to(self.device)
        on_card = self.device.type == "cuda"
        self.seen = [torch.zeros(8, dtype=torch.int32, pin_memory=on_card)
                     for _ in range(2)]
        self.copied = [torch.cuda.Event() if on_card else None for _ in range(2)]

    def run(self, launch) -> int:
        """One solve: `launch(i, stream)` enqueues launch i (0-based); at
        most ceil(max_iter / per_launch) launches. Returns the state's `it`
        (sweeps run): launch it / per_launch - 1 was the last that worked."""
        if first_done(self.tol32, self.max_iter):
            return 0
        self.state.copy_(self.fresh)
        stream = kernel_lib.stream_ptr(self.device)
        total = -(-self.max_iter // self.per_launch)
        batches = -(-total // self.batch)

        def enqueue(k):
            first = k * self.batch
            n = min(self.batch, total - first)
            for i in range(first, first + n):
                launch(i, stream)
            self.counter.launches += n
            self.seen[k % 2].copy_(self.state, non_blocking=True)
            if self.copied[k % 2] is not None:
                self.copied[k % 2].record()

        words = None
        if self.ahead:
            enqueue(0)
        for k in range(batches):
            if not self.ahead:
                enqueue(k)
            elif k + 1 < batches:
                enqueue(k + 1)
            if self.copied[k % 2] is not None:
                self.copied[k % 2].synchronize()
            self.counter.reads += 1
            words = self.seen[k % 2].tolist()
            if words[5]:
                break
        if words is None or not words[5]:
            raise RuntimeError("a device-exit loop's state never set done")
        return words[4]
