"""Host->device double-buffered frame feeder — the processing engine.

Rebuilds the reference's L2 transport + L3 dispatch as a device pipeline:

reference                                  here
---------------------------------------   -----------------------------------
appsink cb -> GAsyncQueue (O(1) ref)       submit() -> LeakyQueue
1-8 worker threads pop + process           feeder thread batches frames and
  (OpenCVequalHist.cpp:102-196)              dispatches the jitted enhance fn
ARM->FPGA DMA write/exec/read              async device_put + XLA dispatch +
  (OpenCLequalHist.cpp:346-365)              overlapped host readback
ProcessedFrame re-order map (binary-only)  Resequencer
appsrc push                                on_output callback

Double buffering: JAX dispatch is asynchronous, so the feeder keeps up to
``depth`` batches in flight — while batch i is executing on the device, batch
i+1 is staged and dispatched; only then is batch i's result materialized to
host memory.  This overlaps host->device transfer, device compute, and
device->host readback exactly like the reference overlaps its per-worker
OpenCL command queues.

The ``workers`` knob of the reference CLIs (clamped to 8,
``OpenCVequalHist.cpp:274-275``) maps to ``depth`` here.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

import numpy as np

from opencv_opencl_tpu.metrics.counters import FrameRateCounters
from opencv_opencl_tpu.metrics.timing import TimingStats
from opencv_opencl_tpu.runtime.queues import Closed, LeakyQueue
from opencv_opencl_tpu.runtime.sequencer import Resequencer

__all__ = ["FrameFeeder"]

_POP_TIMEOUT_S = 0.05  # the reference workers' 50 ms timeout pop


class FrameFeeder:
    """Streaming frame processor around a jitted batch function.

    Parameters
    ----------
    process_batch: callable mapping uint8 (N, rows, W) -> device array of the
        same shape (e.g. ``Enhancer.process_batch``). N may vary per call up
        to ``batch_size`` (each distinct N jit-compiles once).
    batch_size: max frames fused into one device dispatch.
    depth: in-flight batches (double buffering at 2; reference --workers).
    queue_capacity: input LeakyQueue size (reference max-size-buffers=8).
    on_output: called with (seq, np.uint8 frame, meta) in seq order.
    """

    def __init__(
        self,
        process_batch: Callable,
        batch_size: int = 4,
        depth: int = 2,
        queue_capacity: int = 8,
        on_output: Callable[[int, np.ndarray, Any], None] | None = None,
        counters: FrameRateCounters | None = None,
        timing: TimingStats | None = None,
        pad_batches: bool = True,
        native_staging: bool | tuple[int, ...] = False,
        priority_of: Callable | None = None,
        on_drop_item: Callable | None = None,
    ) -> None:
        """``native_staging``: pass the frame shape (rows, width) to stage
        frames through the C++ preallocated ring (GIL-free memcpy + batch
        assembly into one contiguous buffer — the reference's preallocated
        GstBuffer pool); metas ride a parallel Python dict."""
        self.process_batch = process_batch
        self.batch_size = max(1, batch_size)
        self.depth = min(max(1, depth), 8)
        self.on_output = on_output or (lambda seq, frame, meta: None)
        self.counters = counters or FrameRateCounters()
        self.timing = timing or TimingStats(label="feeder")
        self.pad_batches = pad_batches
        self._native = None
        self._native_shape = None
        self._native_metas: dict[int, Any] = {}
        if native_staging:
            from opencv_opencl_tpu import native

            if native.available():
                self._native_shape = tuple(native_staging)
                frame_bytes = int(np.prod(self._native_shape))
                self._native = native.NativeRing(queue_capacity, frame_bytes)
        # QoS + native staging compose: the C++ ring's priority-aware
        # eviction (fp_ring_push_prio) reports WHICH seq it evicted, so
        # per-stream drop accounting stays truthful on the GIL-free path
        self._priority_of = priority_of
        self._on_drop_item = on_drop_item

        def _note_drop(item):
            self.counters.count("dropped_overflow")
            if on_drop_item is not None:
                on_drop_item(item)

        qkw = dict(max_size=queue_capacity, on_drop=_note_drop)
        if priority_of is not None:
            from opencv_opencl_tpu.runtime.queues import PriorityLeakyQueue

            self._inq = PriorityLeakyQueue(priority_of=priority_of, **qkw)
        else:
            self._inq = LeakyQueue(**qkw)
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._meta_lock = threading.Lock()
        self._out_seq = 0  # dense output ordering, assigned at dispatch
        self._reseq = Resequencer(self._emit)
        self._inflight: list[tuple] = []
        # preallocated host staging buffers (one per in-flight batch + 1):
        # no per-batch np.stack allocation — the analogue of the reference's
        # pre-allocated per-worker CL buffers (OpenCLequalHist.cpp:175-192).
        # A slot is recycled only once its batch retires, so it can never be
        # rewritten while a (possibly zero-copy) transfer still reads it.
        self._staging_free: list[np.ndarray] = []
        self._staging_shape: tuple[int, ...] | None = None
        self._thread: threading.Thread | None = None
        self._stopping = threading.Event()

    # ---- input side (any thread) ----

    def submit(self, frame: np.ndarray, meta: Any = None) -> int:
        """O(1) enqueue of one frame; returns its sequence number."""
        with self._seq_lock:
            seq = self._seq
            self._seq += 1
        self.counters.count("input_frames")
        # a frame arriving after stop() (the appsink callback can race
        # shutdown) degrades to a drop — never an exception in the caller
        if self._native is not None:
            with self._meta_lock:
                self._native_metas[seq] = meta
            flat = np.asarray(frame).reshape(-1)
            prio = (int(self._priority_of((seq, frame, meta)))
                    if self._priority_of is not None else 0)
            try:
                # uniform priority (no priority_of) degrades to the plain
                # drop-oldest policy, but the ring still reports WHICH seq
                # it evicted, keeping per-stream accounting truthful
                status, evicted_seq = self._native.push_prio(flat, seq, prio)
            except RuntimeError:  # ring closed
                status, evicted_seq = "rejected", None
            if status != "ok":
                self.counters.count("dropped_overflow")
                if status == "rejected":
                    # the incoming frame itself was dropped
                    if self._on_drop_item is not None:
                        self._on_drop_item((seq, frame, meta))
                    with self._meta_lock:
                        self._native_metas.pop(seq, None)
                else:  # evicted: attribute the drop to the EVICTED frame's
                    # stream, not the new one's
                    with self._meta_lock:
                        ev_meta = self._native_metas.pop(evicted_seq, None)
                    if self._on_drop_item is not None:
                        self._on_drop_item((evicted_seq, None, ev_meta))
        else:
            try:
                self._inq.put((seq, np.asarray(frame), meta))
            except Closed:
                self.counters.count("dropped_overflow")
        return seq

    def queue_length(self) -> int:
        if self._native is not None:
            return len(self._native)
        return len(self._inq)

    def _acquire_slot(self, frame_shape: tuple[int, ...]) -> np.ndarray:
        shape = (self.batch_size, *frame_shape)
        if self._staging_shape != shape:
            self._staging_shape = shape
            self._staging_free = [
                np.empty(shape, np.uint8) for _ in range(self.depth + 2)
            ]
        return (self._staging_free.pop() if self._staging_free
                else np.empty(shape, np.uint8))

    def _native_get_batch(self):
        """Pop a batch from the C++ ring DIRECTLY into a staging slot (the
        ring's GIL-free memcpy is the only copy).  Returns (items, slot);
        items None on close, empty on timeout."""
        slot = self._acquire_slot(self._native_shape)
        n, seqs = self._native.pop_batch(
            slot.reshape(self.batch_size, -1), self.batch_size,
            timeout_ms=int(_POP_TIMEOUT_S * 1000),
        )
        if n <= 0:
            self._staging_free.append(slot)
            return ([] if n == 0 else None), None
        out = []
        with self._meta_lock:
            for i in range(n):
                seq = int(seqs[i])
                out.append((seq, slot[i],
                            self._native_metas.pop(seq, None)))
            # metas of ring-dropped frames (seq below the oldest popped) can
            # never surface again — prune so a long stream doesn't leak
            floor = int(seqs[:n].min())
            for k in [k for k in self._native_metas if k < floor]:
                del self._native_metas[k]
        return out, slot

    # ---- output side (feeder thread) ----

    def _emit(self, seq: int, item: tuple[np.ndarray, Any]) -> None:
        frame, meta = item
        self.counters.count("output_frames")
        try:
            self.on_output(seq, frame, meta)
        except Exception:
            self.counters.count("push_failures")

    def _retire_oldest(self) -> None:
        import time

        entries, device_out, t_dispatch, slot = self._inflight.pop(0)
        t0 = time.perf_counter()
        host = np.asarray(device_out)  # blocks until device done + D2H copy
        mem_ms = (time.perf_counter() - t0) * 1e3
        compute_ms = (t0 - t_dispatch) * 1e3
        n = len(entries)
        self.timing.record(compute_ms, mem_ms, compute_ms + mem_ms)
        for i, (seq, meta) in enumerate(entries):
            self._reseq.push(seq, (host[i], meta))
        del device_out
        if slot is not None and slot.shape == self._staging_shape:
            # shape-tag check: a mid-stream frame-shape change resets the
            # pool; stale-shape slots must not poison it
            self._staging_free.append(slot)

    def _stage(self, frames: list[np.ndarray],
               slot: np.ndarray | None = None) -> tuple[np.ndarray, Any]:
        """Assemble a batch into a recycled staging buffer (alloc-free in
        steady state).  Returns (batch_view, slot).  A pre-filled ``slot``
        (the native-ring pop target) skips the copy entirely."""
        if slot is None:
            slot = self._acquire_slot(frames[0].shape)
            for i, f in enumerate(frames):
                np.copyto(slot[i], f)
        if self.pad_batches and len(frames) < self.batch_size:
            # keep the device shape static: pad with repeats of the last
            for i in range(len(frames), self.batch_size):
                np.copyto(slot[i], frames[-1])
            return slot, slot
        return slot[: len(frames)], slot

    def _dispatch(self, items: list[tuple[int, np.ndarray, Any]],
                  slot: np.ndarray | None = None) -> None:
        import time

        frames = [f for (_, f, _) in items]
        n = len(frames)
        batch, slot = self._stage(frames, slot)
        t_dispatch = time.perf_counter()
        try:
            out = self.process_batch(batch)
        except Exception:
            self.counters.count("processing_errors", n)
            if slot.shape == self._staging_shape:
                self._staging_free.append(slot)
            return  # no output seqs consumed -> no resequencer gap
        # dense output sequence assigned at dispatch (queue drops and
        # processing errors therefore never create gaps the resequencer
        # would stall on — the stream degrades to drops, never to stalls)
        entries = [(self._out_seq + i, meta)
                   for i, (_, _, meta) in enumerate(items)]
        self._out_seq += len(items)
        self._inflight.append((entries, out, t_dispatch, slot))
        while len(self._inflight) >= self.depth:
            self._retire_oldest()

    def _run(self) -> None:
        while True:
            slot = None
            if self._native is not None:
                got, slot = self._native_get_batch()
                if got is None:
                    break  # ring closed + drained
                if not got:
                    if self._stopping.is_set():
                        break
                    while self._inflight:
                        self._retire_oldest()
                    continue
            else:
                try:
                    got = self._inq.get_batch(
                        self.batch_size, timeout=_POP_TIMEOUT_S
                    )
                except TimeoutError:
                    if self._stopping.is_set():
                        break
                    # idle: retire in-flight work so latency stays low
                    while self._inflight:
                        self._retire_oldest()
                    continue
                except Closed:
                    break
            try:
                self._dispatch(got, slot)
            except Exception:
                # staging/assembly failures must not kill the feeder
                # thread — count and keep streaming (drop semantics)
                self.counters.count("processing_errors", len(got))
        while self._inflight:
            self._retire_oldest()
        self._reseq.flush()

    # ---- lifecycle ----

    def start(self) -> "FrameFeeder":
        if self._thread is not None:
            raise RuntimeError("feeder already started")
        self._stopping.clear()
        self._thread = threading.Thread(target=self._run, daemon=True, name="tpu-feeder")
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 600.0) -> None:
        """Stop the feeder; with drain=True, process everything queued first.

        ``timeout`` bounds the join — generous by default because the very
        first dispatch may include device-program compilation (the
        reference's equivalent one-time cost is the xclbin load).
        """
        if self._thread is None:
            return
        if not drain:
            self._inq.clear()
        self._stopping.set()
        self._inq.close()  # queued frames still drain; get raises Closed after
        if self._native is not None:
            # close() lets already-queued frames drain (pop returns -1 only
            # after empty); without it the ring stays open and post-stop
            # submit() calls would silently enqueue frames no one pops
            self._native.close()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            self.counters.count("processing_errors")
        self._thread = None

    def warmup(self, frame_shape: tuple[int, ...]) -> None:
        """Compile the batch program before streaming starts — the analogue
        of the reference loading the FPGA bitstream before PLAYING
        (OpenCLequalHist.cpp:106-140)."""
        import numpy as np

        dummy = np.zeros((self.batch_size, *frame_shape), dtype=np.uint8)
        out = self.process_batch(dummy)
        np.asarray(out)

    @property
    def stats(self) -> dict[str, int]:
        s = self.counters.snapshot()
        s["dropped_late"] = self._reseq.dropped_late
        s["frames_lost"] = self._reseq.frames_lost
        s["emitted"] = self._reseq.emitted
        return s
