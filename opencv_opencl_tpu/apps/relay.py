"""Live relay (<- reference ``OpenCVequalHist.cpp`` family + ``OpenCLequalHist.cpp``).

Usage:
  python -m opencv_opencl_tpu.apps.relay [--codec=h264|h265] [--bitrate=20000]
      [--workers=2] [--width=1920] [--height=1080] [--fps=60]
      [--op=histeq|clahe|none] [--chroma=gray|passthrough]
      [--clipLimit=2.0] [--tile=8] [--batch=4]
      [--source=test|<video file>] [--sink=null|<output file>]
                   # sinks also accept rtp://host:port (JPEG/RTP),
                   # rtp+raw://host:port (raw NV12 lines), and
                   # rtp+h264://host:port / rtp+h265://host:port
                   # (encoded RFC 6184/7798 — the full reference emit
                   # chain, encoder chosen via --encoder)
      [--encoder=auto|pcm[:slices]|cavlc[:qp=N][:slices=M][:gop=N][:search=R][:halfpel|:quarterpel|:fastsub][:bitpack]|ffmpeg|gi]  # encoder for rtp+h26x
                   # sinks (io.encoder; pcm = in-repo lossless I_PCM)
      [--fused-encode]  # with --sink=rtp+h264:// --encoder=tpu[...]:
                   # enhance + H.264 level computation fuse into ONE
                   # device program — frames never return to host as
                   # pixels, only quantized levels come down
                   # (models/fused_encode.py)
      [--hist-downsample=N]  # APPROXIMATE throughput mode: histograms
                   # from every Nth row, counts rescaled (selective
                   # downsampling, arXiv:1709.04583); default 1 = exact
      [--duration=seconds] [--max-frames=N] [--status-interval=2]
      [--ref-frame]  # clahe: LUTs from the previous frame (latency
                     # hiding)
      [--max-rate=N] [--adaptive-rate]  # static videorate cap, or an
                     # RTCP-loss-driven AIMD rate loop (native RTP sinks)
      [--rtcp-schedule=tick|rfc3550]  # fixed 2-s SR cadence (reference
                     # semantics) or the RFC 3550 interval algorithm
      [--mesh=auto|DxS]  # multi-chip: shard the batch over a (data,
                     # space) device mesh (e.g. --mesh=4x2); batch must
                     # be a multiple of D.  Takes precedence over
                     # --ref-frame (the sharded path is stateless).
      [--io=gst]   # drive a real GStreamer pipeline via python-gi
                   # (appsink -> feeder -> appsrc; sink may be
                   #  rtp://host:port, a file, or null)

Defaults mirror the reference live relay (1920x1080 @ 60, h264, 20 Mbps,
2 workers: ``OpenCVequalHist.cpp:262-266``).  The worker pool + GAsyncQueue +
FPGA DMA of the reference become the device FrameFeeder (``--workers`` is the
in-flight pipeline depth, clamped to 8 like the reference's thread cap);
``--chroma`` selects between the gray (UV=128) and color-preserving
(passthrough) variants of the reference family; the 2-second status tick and
ACTIVE/IDLE/BACKLOG classifier are reproduced from ``OpenCLequalHist.cpp``.
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
            "codec": str, "bitrate": int, "workers": int, "width": int,
            "height": int, "fps": float, "op": str, "chroma": str,
            "clipLimit": float, "tile": int, "batch": int, "source": str,
            "sink": str, "duration": float, "max-frames": int,
            "status-interval": float, "realtime": bool, "max-rate": float,
            "adaptive-rate": bool, "native": bool, "preset": str,
            "io": str, "ref-frame": bool, "sdp-file": str,
            "rtcp-schedule": str, "mesh": str, "encoder": str,
            "hist-downsample": int, "fused-encode": bool,
        },
    )
    if "max-rate" in opts and opts["max-rate"] <= 0:
        print("--max-rate must be > 0", file=sys.stderr)
        return 2
    if opts.get("io") == "gst":
        from opencv_opencl_tpu.io.gst_adapter import gi_available

        if not gi_available():
            print("--io=gst unavailable: python-gi with GStreamer 1.0 is "
                  "not available on this host; use io.videofile "
                  "sources/sinks or install gir1.2-gstreamer",
                  file=sys.stderr)
            return 2
    if "preset" in opts:
        from opencv_opencl_tpu.models.presets import PRESETS

        p = PRESETS[opts["preset"]]
        opts.setdefault("codec", p.encoder.codec)
        opts.setdefault("bitrate", p.encoder.bitrate_kbps)
        opts.setdefault("width", p.width)
        opts.setdefault("height", p.height)
        opts.setdefault("fps", p.fps)
        opts.setdefault("op", p.enhancer.op)
        opts.setdefault("chroma", p.enhancer.chroma.value)
        opts.setdefault("clipLimit", p.enhancer.clip_limit)
        opts.setdefault("tile", p.enhancer.tile_grid[0])
        print(f"Preset '{opts['preset']}' ({p.reference}): {p.description}")
    codec = opts.get("codec", "h264")
    bitrate = opts.get("bitrate", 20000)
    workers = min(max(opts.get("workers", 2), 1), 8)
    width = opts.get("width", 1920)
    height = opts.get("height", 1080)
    fps = opts.get("fps", 60.0)
    op = opts.get("op", "histeq")
    chroma_s = opts.get("chroma", "gray")
    batch = opts.get("batch", 4)
    source = opts.get("source", "test")
    sink_path = opts.get("sink", "null")
    duration = opts.get("duration")
    max_frames = opts.get("max-frames")
    interval = opts.get("status-interval", 2.0)
    realtime = opts.get("realtime", False)

    import numpy as np

    from opencv_opencl_tpu.core.frames import ChromaPolicy, FrameSpec
    from opencv_opencl_tpu.io.videofile import (
        FileSink, FileSource, NullSink, RawSink, TestSource,
    )
    from opencv_opencl_tpu.metrics.counters import FrameRateCounters, StatusReporter
    from opencv_opencl_tpu.models import Enhancer, EnhancerConfig
    from opencv_opencl_tpu.runtime import FrameFeeder
    from opencv_opencl_tpu.runtime.governor import RateGovernor

    chroma = (ChromaPolicy.GRAY if chroma_s.lower() == "gray"
              else ChromaPolicy.PASSTHROUGH)

    gst_mode = opts.get("io") == "gst"
    src = sink = None
    if gst_mode:
        # the GStreamer pipelines own capture/emit: do NOT open cv2
        # sources/sinks here (a FileSink would truncate the very file the
        # gst filesink writes; sockets/captures would leak)
        spec = FrameSpec(width=width, height=height, fps=fps)
    elif source == "test":
        spec = FrameSpec(width=width, height=height, fps=fps)
        src = TestSource(spec, num_frames=max_frames)
    else:
        src = FileSource(source, width=width, height=height)
        spec = FrameSpec(width=src.spec.width, height=src.spec.height, fps=fps)

    if gst_mode:
        pass
    elif sink_path == "null":
        sink = NullSink()
    elif sink_path.startswith(("rtp://", "rtp+raw://")):
        # native RTP/UDP data plane (no GStreamer needed): JPEG/RTP
        # (RFC 2435, interoperable with rtpjpegdepay) or raw NV12 lines
        from opencv_opencl_tpu.io.rtp import RtpUdpSink

        kind = "raw" if sink_path.startswith("rtp+raw://") else "jpeg"
        hostport = sink_path.split("://", 1)[1]
        rtp_host, rtp_port = hostport.rsplit(":", 1)
        schedule = opts.get("rtcp-schedule", "tick")
        if schedule not in ("tick", "rfc3550"):
            print(f"--rtcp-schedule={schedule!r} invalid: tick|rfc3550",
                  file=sys.stderr)
            return 2
        sink = RtpUdpSink(rtp_host, int(rtp_port), kind=kind, fps=fps,
                          rtcp_schedule=schedule)
        if "sdp-file" in opts:
            # a stock player (ffplay/VLC) opens this file to receive the
            # stream — the in-repo equivalent of handing the lab PC the
            # udpsink coordinates
            from opencv_opencl_tpu.io.sdp import build_rtp_session_sdp

            with open(opts["sdp-file"], "w") as f:
                f.write(build_rtp_session_sdp(
                    rtp_host, int(rtp_port), kind,
                    width=spec.width, height=spec.height))
            print(f"SDP written: {opts['sdp-file']}")
    elif sink_path.startswith(("rtp+h264://", "rtp+h265://")):
        # full reference emit chain: encode -> RFC 6184/7798 payload ->
        # UDP (OpenCVequalHist.cpp:308-332), behind the pluggable
        # encoder boundary (io.encoder: pcm | cavlc | ffmpeg | gi | auto)
        from opencv_opencl_tpu.io.encoder import encoded_rtp_sink_from_url

        es_codec = "h264" if sink_path.startswith("rtp+h264://") else "h265"
        try:
            sink = encoded_rtp_sink_from_url(
                sink_path, spec.width, spec.height, fps=fps,
                bitrate_kbps=bitrate, backend=opts.get("encoder", "auto"),
                rtcp_schedule=opts.get("rtcp-schedule", "tick"))
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        rtp_host, rtp_port = sink.rtp.addr[0], sink.rtp.addr[1]
        print(f"Encoder: {type(sink.encoder).__name__} ({es_codec})")
        if "sdp-file" in opts:
            # hand stock players (ffplay/VLC) the session description
            from opencv_opencl_tpu.io.sdp import build_rtp_session_sdp

            with open(opts["sdp-file"], "w") as f:
                f.write(build_rtp_session_sdp(
                    rtp_host, int(rtp_port), es_codec,
                    width=spec.width, height=spec.height))
            print(f"SDP written: {opts['sdp-file']}")
    elif sink_path.endswith(".nv12") or sink_path.endswith(".raw"):
        sink = RawSink(sink_path)
    else:
        sink = FileSink(sink_path, spec)

    try:
        cfg = EnhancerConfig(
            op=op, clip_limit=opts.get("clipLimit", 2.0),
            tile_grid=(opts.get("tile", 8),) * 2, chroma=chroma,
            use_ref_frame=opts.get("ref-frame", False),
            hist_downsample=opts.get("hist-downsample", 1),
        )
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    if cfg.hist_downsample > 1:
        if "mesh" in opts or cfg.use_ref_frame:
            print("--hist-downsample is not supported with --mesh or "
                  "--ref-frame (exact-only paths)", file=sys.stderr)
            return 2
        print(f"APPROXIMATE histogram mode: every "
              f"{cfg.hist_downsample}th row (not bit-exact vs cv2)")
    mesh = None
    fused = bool(opts.get("fused-encode"))
    if "mesh" in opts:
        # multi-chip: shard the batch over `data`, rows over `space` —
        # the scaling analogue of the reference's worker pool, one flag
        from opencv_opencl_tpu.parallel.mesh import mesh_from_cli

        try:
            # one shared parser (relay + multi_relay): only mesh
            # construction errors belong to the flag; anything
            # the sharded builders raise is a real config error
            mesh = mesh_from_cli(opts["mesh"])
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
    if mesh is not None and fused:
        # enhancement fuses INTO the mesh encode program
        # (parallel/sharded_encode): no separate sharded enhancer
        enhancer = None
    elif mesh is not None:
        from opencv_opencl_tpu.parallel.sharded import ShardedEnhancer

        enhancer = ShardedEnhancer(cfg, spec, mesh=mesh)
        ndata = enhancer.mesh.shape["data"]
        if batch < 1 or batch % ndata:
            print(f"--batch={batch} must be a positive multiple of the "
                  f"mesh data axis ({ndata})", file=sys.stderr)
            return 2
        print(f"Sharded over mesh {dict(enhancer.mesh.shape)} "
              f"({len(enhancer.mesh.devices.flat)} devices)")
    elif cfg.use_ref_frame and op == "clahe":
        # streaming mode: LUTs from the previous frame's histograms (the
        # accel.cpp two-input hook) — each scan step maps with the
        # carried LUTs and histograms the frame
        from opencv_opencl_tpu.models.enhancer import StreamingEnhancer

        enhancer = StreamingEnhancer(cfg, spec)
    else:
        try:
            enhancer = Enhancer(cfg, spec)
        except ValueError as e:  # e.g. hist-downsample vs tile height
            print(str(e), file=sys.stderr)
            return 2
    counters = FrameRateCounters()

    process_fn = enhancer.process_batch if enhancer is not None else None
    fused_gop = False
    fused_reset = None
    if fused:
        from opencv_opencl_tpu.io.encoder import EncodedRtpSink

        if (gst_mode or cfg.use_ref_frame
                or not isinstance(sink, EncodedRtpSink)
                or not hasattr(sink.encoder, "encode_from_packed")):
            print("--fused-encode requires --sink=rtp+h264:// with "
                  "--encoder=tpu[...] (and no --io=gst or "
                  "--ref-frame)", file=sys.stderr)
            return 2
        import jax.numpy as jnp

        from opencv_opencl_tpu.io.h264_inter import TpuGopEncoder
        from opencv_opencl_tpu.models.fused_encode import (
            build_enhance_gop_fn, build_enhance_levels_fn)

        enc = sink.encoder
        fused_gop = isinstance(enc, TpuGopEncoder)
        if mesh is not None:
            # multi-chip fused enhance+encode: GOP-per-device data
            # parallelism (parallel/sharded_encode) — byte-identical
            # to the sequential stream because GOPs are independent
            # encode units (every IDR ignores the incoming recon)
            import jax

            from opencv_opencl_tpu.parallel.sharded_encode import (
                build_mesh_gop_fn, build_mesh_levels_fn,
                pad_batch_for_mesh)

            if fused_gop and (enc.gdr or enc._cpb is not None):
                print("--fused-encode with --mesh requires IDR GOP "
                      "boundaries and per-frame-synchronous state to "
                      "stay on one chip: no gdr, no cpb",
                      file=sys.stderr)
                return 2
            ndev = len(mesh.devices.flat)
            if fused_gop:
                mesh_fn, mesh_sharding, unit = build_mesh_gop_fn(
                    cfg, spec, enc.gop, mesh, search=enc.search,
                    subpel=enc.subpel, refs=enc.refs,
                    deblock=enc.deblock,
                    bitpack=(enc._nw_mb if enc._bitpack else 0),
                    parts=enc.parts)
            else:
                mesh_fn, mesh_sharding, unit = build_mesh_levels_fn(
                    cfg, spec, mesh,
                    bitpack=(enc._nw_mb if enc._bitpack else 0))
            if batch < 1 or batch % (ndev * unit):
                print(f"--batch={batch} must be a positive multiple "
                      f"of mesh devices x GOP frames "
                      f"({ndev} x {unit})", file=sys.stderr)
                return 2

            def process_fn(nv12_batch):
                # stateless steps make padding safe (pad frames are
                # causally downstream of every real output); the tail
                # of a stream just encodes a short final GOP
                padded, real = pad_batch_for_mesh(
                    np.asarray(nv12_batch), ndev, unit)
                packed = mesh_fn(jax.device_put(padded, mesh_sharding),
                                 jnp.int32(enc.qp))
                return packed[:real]

            print(f"Fused enhance+encode over mesh "
                  f"{dict(mesh.shape)} ({ndev} devices, "
                  f"{'GOP' if fused_gop else 'frame'}-per-device; "
                  f"frames stay in device memory as pixels)")
        elif fused_gop:
            # GOP: the device programs chain recon/frame-index state
            # across batches; padding would advance it on fake frames
            # (deblock and the GDR refresh wave both ride inside the
            # device scan: the filter wavefront keeps the FILTERED
            # reference in device memory, the marching band is two traced
            # scalars derived from the frame index)
            fused_fn = build_enhance_gop_fn(
                cfg, spec, enc.gop, search=enc.search,
                subpel=enc.subpel, refs=enc.refs,
                deblock=enc.deblock, gdr=enc.gdr,
                bitpack=(enc._nw_mb if enc._bitpack else 0),
                parts=enc.parts)
            fstate = {"recon": enc.initial_recon(), "idx": 0}

            def process_fn(nv12_batch):
                packed, *rec = fused_fn(
                    nv12_batch, jnp.int32(enc.qp), fstate["idx"],
                    *fstate["recon"])
                fstate["recon"] = tuple(rec)
                fstate["idx"] += int(nv12_batch.shape[0])
                return packed

            def fused_reset():
                # warmup ran dummy frames through the stateful chain
                fstate["recon"] = enc.initial_recon()
                fstate["idx"] = 0
        else:
            fused_fn = build_enhance_levels_fn(
                cfg, spec,
                bitpack=(enc._nw_mb if enc._bitpack else 0))

            def process_fn(nv12_batch):
                # qp is read at dispatch time and rides in-band in the
                # packed levels, so the retire-side entropy coder always
                # writes the slice-header qp the levels were actually
                # quantized with
                return fused_fn(nv12_batch, jnp.int32(enc.qp))

        if mesh is None:
            print("Fused enhance+encode: frames stay in device memory as "
                  "pixels; the host receives quantized levels only"
                  + (f" (GOP {enc.gop}, recon resident in device memory)"
                     if fused_gop else ""))

    def on_output(seq, frame, meta):
        if fused:
            nbytes = sink.write_packed(frame)
            counters.count("encoder_frames")
            counters.count("encoder_bytes", nbytes)
            return
        if sink is not None:
            sink.write(frame)
        counters.count("encoder_frames")
        counters.count("encoder_bytes", frame.nbytes)

    feeder = FrameFeeder(
        process_fn, batch_size=batch, depth=workers,
        on_output=on_output, counters=counters,
        pad_batches=not fused_gop,  # GOP chain must not see fake frames
        native_staging=((spec.buffer_rows, spec.width)
                        if opts.get("native") else False),
    )
    reporter = StatusReporter(
        counters, interval_s=interval, num_workers=workers,
        queue_length_fn=feeder.queue_length,
        avg_process_ms_fn=lambda: feeder.timing.avg_total_ms,
    )

    print("Compiling device program (one-time, like the xclbin load)...")
    feeder.warmup((spec.buffer_rows, spec.width))
    if hasattr(enhancer, "reset"):
        # warmup ran zero frames through the stateful streaming enhancer —
        # restore the documented identity-like initial histogram state
        enhancer.reset()
    if fused_reset is not None:
        # same for the fused-GOP device state (recon + frame index)
        fused_reset()
    staging = "native C++ ring" if feeder._native is not None else "python queue"
    print(f"NV12 {op} relay pipeline started "
          f"({spec.width}x{spec.height}@{fps:g}, codec={codec}, "
          f"bitrate={bitrate} kbps, workers={workers}, chroma={chroma.value}, "
          f"staging={staging})")
    print("(with frame ordering)")

    if gst_mode:
        # live GStreamer path: appsink -> feeder -> appsrc over python-gi
        # (the reference's actual frame transport, OpenCVequalHist.cpp:71-98)
        from opencv_opencl_tpu.io import gst as gstb
        from opencv_opencl_tpu.io.gst_adapter import GstAppBridge, TimestampPolicy

        if source == "test":
            cap = gstb.test_capture_pipeline(
                width=width, height=height, fps=int(fps),
                num_buffers=max_frames)
            policy = TimestampPolicy.RELAY
        elif source.startswith("/dev/video"):
            cap = gstb.capture_pipeline(device=source, width=width,
                                        height=height, fps=int(fps))
            policy = TimestampPolicy.RELAY
        else:
            cap = gstb.file_capture_pipeline(source, width=width,
                                             height=height, fps_num=int(fps))
            policy = TimestampPolicy.SYNTHESIZE
        enc = gstb.EncoderConfig(codec=codec, bitrate_kbps=bitrate)
        if sink_path == "null":
            emit = (f"appsrc name=my_src format=time is-live=true "
                    f"do-timestamp=true caps=video/x-raw,format=NV12,"
                    f"width={width},height={height},framerate={int(fps)}/1 "
                    f"! fakesink sync=false")
        elif sink_path.startswith("rtp+raw://"):
            # raw (unencoded) RTP: rtpvrawpay wants I420
            host_port = sink_path.split("://", 1)[1]
            h_, p_ = host_port.rsplit(":", 1)
            emit = (f"appsrc name=my_src format=time is-live=true "
                    f"do-timestamp=true caps=video/x-raw,format=NV12,"
                    f"width={width},height={height},framerate={int(fps)}/1 "
                    f"! videoconvert ! video/x-raw,format=I420 ! "
                    f"rtpvrawpay mtu=1200 ! "
                    f"udpsink host={h_} port={p_} sync=false qos-dscp=60")
        elif "://" in sink_path:
            host_port = sink_path.split("://", 1)[1]
            h_, p_ = host_port.rsplit(":", 1)
            emit = gstb.emit_pipeline(enc, width=width, height=height,
                                      fps=int(fps), host=h_, port=int(p_))
        else:
            emit = gstb.file_emit_pipeline(enc, width=width, height=height,
                                           fps_num=int(fps),
                                           output_file=sink_path)
        try:
            bridge = GstAppBridge.from_gi(
                cap, emit, feeder, (spec.buffer_rows, spec.width), fps=fps,
                policy=policy,
            )
        except RuntimeError as e:
            print(f"--io=gst unavailable: {e}", file=sys.stderr)
            return 2
        feeder.start()
        reporter.start()
        bridge.start()
        try:
            bridge.wait(duration)
        except KeyboardInterrupt:
            print("\nInterrupted.")
        bridge.stop()
        feeder.stop(drain=True)
        reporter.stop()
        reporter.tick()
        stats = feeder.stats
        print(f"\nShutdown: {stats['emitted']} frames emitted, "
              f"dropped(late)={stats['dropped_late']}, "
              f"errors={stats['processing_errors']}")
        feeder.timing.final_report()
        return 0

    if opts.get("adaptive-rate"):
        # congestion-aware: RTCP receiver reports drive an AIMD rate loop
        # (ceiling = --max-rate or the configured fps)
        from opencv_opencl_tpu.runtime.governor import (
            AdaptiveRateGovernor, feed_governor_from_rtcp)

        # default ceiling 10% above the pacing rate: an exactly-at-fps
        # submit cadence would otherwise resonate with the admit slot
        # grid and shed frames on a loss-free stream
        governor = AdaptiveRateGovernor(
            opts.get("max-rate", (fps or 30.0) * 1.1))
    else:
        governor = (RateGovernor(opts["max-rate"])
                    if "max-rate" in opts else None)

    feeder.start()
    reporter.start()
    t_start = time.monotonic()
    frame_period = 1.0 / fps if fps > 0 else 0.0
    n = 0
    try:
        for nv12 in src:
            counters.count("camera_frames")
            if governor is not None and not governor.admit():
                continue  # videorate drop-only: cap the input rate
            feeder.submit(nv12, meta={"pts": n * frame_period})
            n += 1
            if opts.get("adaptive-rate"):
                feed_governor_from_rtcp(governor, sink)
            if max_frames is not None and n >= max_frames:
                break
            if duration is not None and time.monotonic() - t_start > duration:
                break
            if realtime:
                next_t = t_start + n * frame_period
                delay = next_t - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
    except KeyboardInterrupt:
        print("\nInterrupted.")
    feeder.stop(drain=True)
    reporter.stop()
    reporter.tick()
    if getattr(sink, "rtcp", None) is not None:
        # surface the far end's Receiver Report, if any arrived (loss/RTT
        # — the numbers the reference read off details.html)
        sink.rtcp.poll()
        if sink.rtcp.remote_blocks:
            blk = sink.rtcp.remote_blocks[-1]
            rtt = f"{sink.rtt_ms:.1f} ms" if sink.rtt_ms is not None else "n/a"
            print(f"[rtcp] receiver reports: lost={blk.cumulative_lost} "
                  f"fraction={blk.fraction_lost}/256 "
                  f"jitter={blk.jitter} rtp-units rtt={rtt}")
    sink.close()

    stats = feeder.stats
    wall = time.monotonic() - t_start
    print(f"\nShutdown: {stats['emitted']} frames emitted in {wall:.2f}s "
          f"({stats['emitted'] / wall if wall > 0 else 0:.1f} fps), "
          f"dropped(late)={stats['dropped_late']}, "
          f"dropped(overflow)={stats['dropped_overflow']}, "
          f"errors={stats['processing_errors']}")
    feeder.timing.final_report()
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
