"""Multi-stream relay: N independent streams served by ONE chip.

Usage:
  python -m opencv_opencl_tpu.apps.multi_relay --streams=4
      [--width=1920 --height=1080 --fps=30] [--op=clahe|histeq]
      [--chroma=gray|passthrough] [--clipLimit=2.0] [--tile=8]
      [--batch=4] [--workers=2] [--max-frames=N] [--duration=s]
      [--source=test|<video file>]      # one source replicated per stream
      [--sink=null|rtp://host:port|rtp+h264://host:port]
                         # rtp: stream i goes to port+2*i; rtp+h264/h265
                         # runs the encoded emit chain per stream
                         # (encoder backend via --encoder=..., io.encoder syntax incl.
                         #  gop=N:search=R[:halfpel|:quarterpel|:fastsub][:bitpack][:refs=2])
      [--status-interval=2]
      [--mesh=auto|DxS]  # multi-chip serving: shard the stream batch
                         # over a (data, space) device mesh
      [--adaptive-rate [--max-rate=FPS]]  # per-stream AIMD on each RTP
                         # session's RTCP loss: a congested viewer sheds
                         # only its own frames
      [--priorities=2,1,...]  # per-stream QoS classes (higher = more
                         # important): overload evicts the lowest class
                         # first, so premium streams survive congestion
      [--hist-downsample=N]  # APPROXIMATE fast-histogram mode (see relay)
      [--native]         # GIL-free C++ staging ring; composes with
                         # --priorities (fp_ring_push_prio evicts the
                         # lowest class and reports whose frame it was,
                         # keeping per-stream drop accounting truthful)

The serving extension of ``relay``: one device has room for several
streams, so production packs many streams per device.  Frames from all
streams share device batches via ``runtime/mux.StreamMux``; outputs
route back per stream in order.  The reference cannot do this at all —
its OpenCL context is process-exclusive (``OpenCLequalHist.cpp:106-140``)
and each relay binary owns one stream.

RTP port spacing is 2 per stream because each RTP session's RTCP rides
its companion port (port+1, io/rtcp.py).
"""

from __future__ import annotations

import sys
import time

from opencv_opencl_tpu.apps._cli import (
    install_sigterm_handler, parse_kv_args)


def run(argv: list[str]) -> int:
    install_sigterm_handler()
    opts, _ = parse_kv_args(
        argv,
        {
            "streams": int, "width": int, "height": int, "fps": float,
            "op": str, "chroma": str, "clipLimit": float, "tile": int,
            "batch": int, "workers": int, "max-frames": int,
            "duration": float, "source": str, "sink": str,
            "status-interval": float, "rtcp-schedule": str, "mesh": str,
            "adaptive-rate": bool, "max-rate": float, "priorities": str,
            "native": bool, "encoder": str, "hist-downsample": int,
        },
    )
    n = opts.get("streams", 2)
    if "max-rate" in opts and opts["max-rate"] <= 0:
        print("--max-rate must be > 0", file=sys.stderr)
        return 2
    width = opts.get("width", 1920)
    height = opts.get("height", 1080)
    fps = opts.get("fps", 30.0)
    op = opts.get("op", "clahe")
    max_frames = opts.get("max-frames")
    duration = opts.get("duration")
    sink_spec = opts.get("sink", "null")
    interval = opts.get("status-interval", 2.0)

    import numpy as np

    from opencv_opencl_tpu.core.frames import ChromaPolicy, FrameSpec
    from opencv_opencl_tpu.io.videofile import FileSource, NullSink, TestSource
    from opencv_opencl_tpu.models import Enhancer, EnhancerConfig
    from opencv_opencl_tpu.runtime.mux import StreamMux

    spec = FrameSpec(width=width, height=height, fps=fps)
    chroma = (ChromaPolicy.GRAY if opts.get("chroma", "").lower() == "gray"
              else ChromaPolicy.PASSTHROUGH)
    try:
        cfg = EnhancerConfig(
            op=op, clip_limit=opts.get("clipLimit", 2.0),
            tile_grid=(opts.get("tile", 8),) * 2, chroma=chroma,
            hist_downsample=opts.get("hist-downsample", 1),
        )
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    if cfg.hist_downsample > 1:
        if "mesh" in opts:
            print("--hist-downsample is not supported with --mesh "
                  "(the sharded path is exact-only)", file=sys.stderr)
            return 2
        print(f"APPROXIMATE histogram mode: every "
              f"{cfg.hist_downsample}th row (not bit-exact vs cv2)")
    if "mesh" in opts:
        # multi-device serving: the stream batch shards over the mesh's
        # data axis (whole frames per device), rows over space — N
        # streams across M devices with the same StreamMux front
        from opencv_opencl_tpu.parallel.mesh import mesh_from_cli
        from opencv_opencl_tpu.parallel.sharded import ShardedEnhancer

        try:
            mesh = mesh_from_cli(opts["mesh"])
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        enhancer = ShardedEnhancer(cfg, spec, mesh=mesh)
        batch = opts.get("batch", 4)
        if batch < 1 or batch % mesh.shape["data"]:
            print(f"--batch={batch} must be a positive multiple of the "
                  f"mesh data axis ({mesh.shape['data']})", file=sys.stderr)
            return 2
        print(f"Sharded over mesh {dict(mesh.shape)} "
              f"({len(mesh.devices.flat)} devices)")
    else:
        try:
            enhancer = Enhancer(cfg, spec)
        except ValueError as e:  # e.g. hist-downsample vs tile height
            print(str(e), file=sys.stderr)
            return 2

    sinks = []
    if sink_spec.startswith("rtp://"):
        from opencv_opencl_tpu.io.rtp import RtpUdpSink

        host, port = sink_spec[len("rtp://"):].rsplit(":", 1)
        for s in range(n):
            sinks.append(RtpUdpSink(
                host, int(port) + 2 * s, kind="jpeg", fps=fps,
                rtcp_schedule=opts.get("rtcp-schedule", "tick")))
        print(f"Sinks: rtp://{host}:{port}..{int(port) + 2 * (n - 1)} "
              f"(stride 2: RTCP companions)")
    elif sink_spec.startswith(("rtp+h264://", "rtp+h265://")):
        # encoded emit per stream (OpenCVequalHist.cpp:308-332 chain),
        # one encoder + RTP session per stream, same 2-port stride
        from opencv_opencl_tpu.io.encoder import encoded_rtp_sink_from_url

        try:
            for s in range(n):
                sinks.append(encoded_rtp_sink_from_url(
                    sink_spec, spec.width, spec.height, fps=fps,
                    backend=opts.get("encoder", "auto"),
                    rtcp_schedule=opts.get("rtcp-schedule", "tick"),
                    port_offset=2 * s))
        except ValueError as e:
            for snk in sinks:
                snk.close()
            print(str(e), file=sys.stderr)
            return 2
        print(f"Sinks: encoded RTP {sink_spec} .. +{2 * (n - 1)} "
              f"(encoder={type(sinks[0].encoder).__name__})")
    else:
        sinks = [NullSink() for _ in range(n)]

    governors = None
    adaptive = opts.get("adaptive-rate", False)
    if adaptive:
        # per-stream congestion control: each stream's RTCP receiver
        # reports drive its own AIMD loop, so one congested viewer sheds
        # only its own frames — the other streams keep their full rate.
        # Default ceiling 10% above the pacing rate (slot-grid resonance
        # with an exactly-at-fps submit cadence would shed clean frames).
        from opencv_opencl_tpu.runtime.governor import (
            AdaptiveRateGovernor, feed_governor_from_rtcp)

        rate_cap = opts.get("max-rate", (fps or 30.0) * 1.1)
        governors = [AdaptiveRateGovernor(rate_cap) for _ in range(n)]
    elif "max-rate" in opts:
        # static per-stream cap, like relay --max-rate (drop-only)
        from opencv_opencl_tpu.runtime.governor import RateGovernor

        governors = [RateGovernor(opts["max-rate"]) for _ in range(n)]

    def on_out(stream, sseq, frame, meta):
        sinks[stream].write(frame)

    priorities = None
    if "priorities" in opts:
        try:
            priorities = [int(x) for x in opts["priorities"].split(",")]
        except ValueError:
            print(f"--priorities={opts['priorities']!r} invalid: "
                  f"comma-separated ints", file=sys.stderr)
            return 2
        if len(priorities) != n:
            print(f"--priorities needs {n} entries (one per stream)",
                  file=sys.stderr)
            return 2
    mux = StreamMux(enhancer.process_batch, n, on_output=on_out,
                    priorities=priorities,
                    batch_size=opts.get("batch", 4),
                    depth=opts.get("workers", 2),
                    queue_capacity=max(8, 4 * n),
                    native_staging=((spec.buffer_rows, spec.width)
                                    if opts.get("native") else False))
    src_path = opts.get("source", "test")
    sources = []
    for s in range(n):
        if src_path == "test":
            sources.append(iter(TestSource(spec)))
        else:
            sources.append(iter(FileSource(src_path, width=width,
                                           height=height, loop=True)))

    print(f"Serving {n} streams of {width}x{height} {op} on one chip "
          f"(batch={opts.get('batch', 4)}, depth={opts.get('workers', 2)})")
    mux.start()
    t0 = time.monotonic()
    last_tick = t0
    k = 0
    period = 1.0 / fps if fps > 0 else 0.0
    try:
        while True:
            if max_frames is not None and k >= max_frames:
                break
            if duration is not None and time.monotonic() - t0 > duration:
                break
            for s in range(n):
                if governors is not None:
                    if adaptive:
                        feed_governor_from_rtcp(governors[s], sinks[s],
                                                label=f" stream {s}")
                    if not governors[s].admit():
                        continue  # shed THIS stream's frame only
                try:
                    mux.submit(s, next(sources[s]))
                except StopIteration:
                    sources[s] = iter(TestSource(spec))
                    mux.submit(s, next(sources[s]))
            k += 1
            now = time.monotonic()
            if now - last_tick >= interval:
                st = mux.stats
                agg_fps = st["emitted"] / (now - t0)
                print(f"[status] rounds={k} emitted={st['emitted']} "
                      f"({agg_fps:.1f} fps aggregate, "
                      f"{agg_fps / n:.1f}/stream) "
                      f"dropped(late)={st['dropped_late']} "
                      f"errors={st['processing_errors']}")
                last_tick = now
            next_t = t0 + k * period
            delay = next_t - time.monotonic()
            if delay > 0:
                time.sleep(delay)
    except KeyboardInterrupt:
        print("\nInterrupted.")
    mux.stop(drain=True)
    for sk in sinks:
        sk.close()
    wall = time.monotonic() - t0
    st = mux.stats
    print(f"\nShutdown: {st['emitted']} frames across {n} streams in "
          f"{wall:.2f}s ({st['emitted'] / wall if wall > 0 else 0:.1f} fps "
          f"aggregate); per-stream: "
          + ", ".join(
              f"#{i}={p['emitted']}/{p['submitted']}"
              + (f" (dropped {p['dropped']})" if p["dropped"] else "")
              for i, p in enumerate(st["per_stream"])))
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
