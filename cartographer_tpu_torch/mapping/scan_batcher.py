"""Cross-robot scan batching for the serving path.

Counterpart of the JAX package's `mapping/scan_batcher.py`. N robot
threads, each driving a LocalTrajectoryBuilder2D, would each pay the whole
per-scan step: a launch per kernel and a blocking fetch per robot and scan.
Here concurrent robots' steps coalesce into ticks of the robot-batched step
(`local_trajectory_builder_2d.batched_step`): one host-to-device copy of
the tick's staging rows, one launch per kernel for all of the tick's
robots, and one blocking device-to-host copy of the packed results.

A dispatcher thread collects submissions and fires a tick when `max_batch`
have arrived or the oldest has waited `max_wait_s`. It hands the tick's
result to a completion thread, which waits for that tick's own CUDA event
(the results copied without blocking into pinned memory) and wakes the
robots; it never synchronizes the device, so tick N + 1 is dispatched while
tick N's fetch is in flight. At most two ticks are in flight.

Every kernel launches on the dispatcher's current CUDA stream, and the
robot threads' own device work (a new submap's blank grid, the window's
copies) runs on theirs: both are PyTorch's default stream unless a caller
sets another, so the stream orders a robot's preparation before its tick.

Padded lanes: with `fixed_bucket` every tick has `max_batch` lanes. The
port's grids are updated in place (the JAX program's are functional, so it
pads by replaying entry 0), so a padded lane repeats entry 0's inputs with
its mask and active slots cleared: it reads entry 0's grids and writes
nothing.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List

import torch

from cartographer_tpu_torch.mapping.local_trajectory_builder_2d import (
    _ACTIVE,
    _SMALL,
    batched_step,
)


class ScanBatcher:
    """Coalesces concurrent LocalTrajectoryBuilder2D steps.

    All participating builders must share the same step options (their
    `step_key`); the batcher raises for a builder whose key differs.
    """

    def __init__(self, max_batch: int = 16, max_wait_s: float = 0.004,
                 fixed_bucket: bool = False):
        """`fixed_bucket` pads every tick to `max_batch` lanes: the launch
        shapes never change (padded lanes cost device work, not launches)."""
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.fixed_bucket = fixed_bucket
        self._cv = threading.Condition()
        self._pending: List[dict] = []
        self._key = None
        self._shutdown = False
        self._inflight: "queue.Queue" = queue.Queue(maxsize=2)
        self._inflight_count = 0  # guarded by _cv's lock
        # Telemetry: ticks, scans, host seconds building and dispatching
        # ticks, the completion thread's seconds waiting for fetches, and
        # the dispatcher's seconds waiting for ticks to fill.
        self.num_batches = 0
        self.num_scans = 0
        self.dispatch_seconds = 0.0
        self.fetch_seconds = 0.0
        self.collect_seconds = 0.0
        self._thread = threading.Thread(target=self._loop, daemon=True, name="scan-batcher")
        self._completion = threading.Thread(target=self._complete_loop, daemon=True,
                                            name="scan-batcher-completion")
        self._thread.start()
        self._completion.start()

    def close(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        self._thread.join(timeout=5)
        self._inflight.put(None)
        self._completion.join(timeout=5)

    # ---------------------------------------------------------------- submit

    def submit(self, step_key: tuple, args: tuple) -> tuple:
        """Block until this submission's step has run inside some tick.
        `args` is (builder, seed), the builder's staging row written;
        returns (the robot's packed row (numpy), its range data in the
        local frame)."""
        entry = {"args": args, "ev": threading.Event(), "out": None, "err": None,
                 "t": time.monotonic()}
        with self._cv:
            if self._key is None:
                self._key = step_key
            elif self._key != step_key:
                raise ValueError("ScanBatcher shared across builders with different step "
                                 "options; use one batcher per configuration")
            self._pending.append(entry)
            self._cv.notify_all()
        entry["ev"].wait()
        if entry["err"] is not None:
            raise entry["err"]
        return entry["out"]

    # ------------------------------------------------------------ dispatcher

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._shutdown and not self._pending:
                    self._cv.wait()
                if self._shutdown and not self._pending:
                    return
                # Fill the tick: wait up to max_wait_s and, while both
                # in-flight slots are taken, past it (the tick then gathers
                # one fetch's worth of arrivals); with a free slot it fires
                # at the deadline, so its work overlaps the other's fetch.
                c0 = time.monotonic()
                deadline = self._pending[0]["t"] + self.max_wait_s
                while not self._shutdown and len(self._pending) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 and self._inflight_count < 2:
                        break
                    self._cv.wait(remaining if remaining > 0 else None)
                self.collect_seconds += time.monotonic() - c0
                batch = self._pending[:self.max_batch]
                self._pending = self._pending[self.max_batch:]
                if batch:
                    self._inflight_count += 1
            if batch:
                try:
                    r0 = time.monotonic()
                    self._run(batch)
                    self.dispatch_seconds += time.monotonic() - r0
                except Exception as e:  # noqa: BLE001 — propagate to callers
                    with self._cv:
                        self._inflight_count -= 1
                        self._cv.notify_all()
                    for entry in batch:
                        entry["err"] = e
                        entry["ev"].set()

    def _complete_loop(self) -> None:
        while True:
            item = self._inflight.get()
            if item is None:
                return
            batch, host, event, rd = item
            try:
                f0 = time.monotonic()
                if event is not None:
                    event.synchronize()  # this tick's work and copy, nothing later
                packed = host.numpy()
                self.fetch_seconds += time.monotonic() - f0
                for i, e in enumerate(batch):
                    e["out"] = (packed[i], rd.robot(i))
                    e["ev"].set()
            except Exception as exc:  # noqa: BLE001
                for e in batch:
                    e["err"] = exc
                    e["ev"].set()
            finally:
                with self._cv:
                    self._inflight_count -= 1
                    self._cv.notify_all()

    def _run(self, batch: List[dict]) -> None:
        n = len(batch)
        lanes = self.max_batch if self.fixed_bucket else n
        builders = [e["args"][0] for e in batch]
        seeds = [e["args"][1] for e in batch]
        b0 = builders[0]
        cuda = b0._device.type == "cuda"
        rows = b0._staging.shape[1]
        staging = torch.empty((lanes, rows), dtype=torch.float32, pin_memory=cuda)
        torch.cat([b._staging for b in builders], out=staging[:n])
        if lanes > n:
            # Inert lanes: entry 0's inputs, no point valid, no slot active.
            capacity = (rows - _SMALL) // 8
            staging[n:] = staging[0]
            staging[n:, 7 * capacity:8 * capacity] = 0.0
            staging[n:, 8 * capacity + _ACTIVE.start:8 * capacity + _ACTIVE.stop] = 0.0
            builders += [b0] * (lanes - n)
            seeds += [seeds[0]] * (lanes - n)
        packed, rd = batched_step(builders, staging, seeds)
        event = None
        if cuda:
            host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = packed
        self.num_batches += 1
        self.num_scans += n
        # The completion thread waits for this tick while the next one is
        # gathered and dispatched.
        self._inflight.put((batch, host, event, rd))
