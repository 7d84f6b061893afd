"""Multi-stream serving: N independent streams through ONE device.

The reference runs one stream per process (each relay binary owns one
camera/file and one UDP peer).  One device has room for several streams,
so the production-serving shape is many streams per device.
``StreamMux`` multiplexes frames from N streams into the shared
:class:`FrameFeeder` — the batch axis IS the worker pool, so frames of
different streams ride the same device dispatch — and routes outputs
back per stream, in order, with per-stream accounting.

Ordering: the feeder's global :class:`Resequencer` emits in global
submit order, and each stream's frames are submitted in its own order,
so per-stream order is preserved by construction.  Backpressure stays
leaky (drop-oldest) exactly like the single-stream path — one stalled
stream cannot stall the others because admission is per-submit, not
per-stream-queue.

Reference analogue: none (extension); the closest is running N relay
processes against one FPGA, which the reference cannot do — the OpenCL
context is exclusive (``OpenCLequalHist.cpp:106-140``).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from opencv_opencl_tpu.runtime.feeder import FrameFeeder

__all__ = ["StreamMux"]


class StreamMux:
    """Fan N streams into one FrameFeeder and demux outputs per stream.

    Parameters
    ----------
    process_batch: the shared jitted batch fn (all streams must share one
        frame geometry — one compiled program per geometry).
    n_streams: stream count (ids are 0..n_streams-1).
    on_output: called with ``(stream_id, stream_seq, frame, meta)`` in
        per-stream order.
    priorities: optional per-stream QoS classes (higher = more
        important).  When given, overload eviction drops the oldest
        frame of the lowest-priority stream first
        (:class:`~opencv_opencl_tpu.runtime.queues.PriorityLeakyQueue`),
        so congestion sheds best-effort streams before premium ones.
    Remaining kwargs are forwarded to :class:`FrameFeeder`.
    """

    def __init__(
        self,
        process_batch: Callable,
        n_streams: int,
        on_output: Callable[[int, int, np.ndarray, Any], None] | None = None,
        priorities: list[int] | None = None,
        **feeder_kwargs,
    ) -> None:
        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        if priorities is not None and len(priorities) != n_streams:
            raise ValueError(
                f"priorities has {len(priorities)} entries for "
                f"{n_streams} streams")
        self.n_streams = n_streams
        self.on_output = on_output or (lambda s, k, f, m: None)
        self._submit_seq = [0] * n_streams
        self._emit_seq = [0] * n_streams
        self._dropped = [0] * n_streams  # per-stream overflow evictions
        self.priorities = priorities
        if priorities is not None:
            feeder_kwargs["priority_of"] = (
                lambda item: priorities[item[2]["_mux_stream"]])
        user_drop = feeder_kwargs.pop("on_drop_item", None)

        def _drop(item):
            self._note_drop(item)  # per-stream accounting stays truthful
            if user_drop is not None:
                user_drop(item)

        feeder_kwargs["on_drop_item"] = _drop
        self.feeder = FrameFeeder(
            process_batch, on_output=self._route, **feeder_kwargs)

    def _note_drop(self, item) -> None:
        try:
            self._dropped[item[2]["_mux_stream"]] += 1
        except (TypeError, KeyError, IndexError):
            pass  # non-mux item (shouldn't happen): global counter has it

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self.feeder.start()

    def stop(self, drain: bool = True) -> None:
        self.feeder.stop(drain=drain)

    # -- data path -----------------------------------------------------------

    def submit(self, stream_id: int, frame: np.ndarray,
               meta: Any = None) -> int:
        """O(1) enqueue of one frame of ``stream_id``; returns the frame's
        per-stream sequence number (overload drops are leaky/drop-oldest
        inside the feeder, surfaced via ``stats``)."""
        if not 0 <= stream_id < self.n_streams:
            raise ValueError(f"stream_id {stream_id} out of range")
        k = self._submit_seq[stream_id]
        self._submit_seq[stream_id] += 1
        self.feeder.submit(
            frame, meta={"_mux_stream": stream_id, "_mux_seq": k,
                         "user": meta})
        return k

    def _route(self, seq: int, frame: np.ndarray, meta: Any) -> None:
        s = meta["_mux_stream"]
        self._emit_seq[s] += 1
        self.on_output(s, meta["_mux_seq"], frame, meta["user"])

    # -- accounting ----------------------------------------------------------

    @property
    def stats(self) -> dict:
        base = dict(self.feeder.stats)
        base["per_stream"] = [
            {"submitted": self._submit_seq[s],
             "emitted": self._emit_seq[s],
             "dropped": self._dropped[s]}
            for s in range(self.n_streams)
        ]
        return base
