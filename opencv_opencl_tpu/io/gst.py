"""GStreamer pipeline description builders + gated launcher.

The reference's L1 media shell is a set of ``gst_parse_launch`` strings; this
framework keeps that boundary: these builders emit the same pipeline
descriptions (same elements, same low-latency tuning) with the device backend
sitting between an appsink and an appsrc exactly where the reference's
worker pool sat.  On hosts without GStreamer the builders still work (they
only produce strings) — ``GstShell`` gates the actual launch.

Reference pipelines reproduced:
- live capture:  ``OpenCVequalHist.cpp:292-300`` (v4l2src io-mode=4 dmabuf,
  videorate drop-only, leaky queue, appsink max-buffers=1 drop)
- live emit:     ``OpenCVequalHist.cpp:308-333`` (appsrc is-live,
  omxh264/h265enc low-latency config, rtp pay, udpsink QoS DSCP 60)
- tuned emit:    the binary-only ``improvement`` ELF deltas (mtu=1200,
  cpb-size=1000 initial-delay=500, appsrc max-buffers=8, queue
  max-size-buffers=4, udpsink buffer-size=100MB)
- file capture:  ``CLAHECompare.cpp:419-423`` / ``AirplanMP4.cpp:309-317``
- file emit:     ``CLAHECompare.cpp:438-483`` (tee -> rtp/udp + mp4mux)
"""

from __future__ import annotations

import dataclasses
import shlex
import shutil
import subprocess

__all__ = [
    "EncoderConfig",
    "capture_pipeline",
    "test_capture_pipeline",
    "emit_pipeline",
    "file_capture_pipeline",
    "file_emit_pipeline",
    "mp4_capture_pipeline",
    "webrtc_pipeline",
    "webrtc_pipeline_sw",
    "webrtc_pipeline_vp8",
    "vad_test_pipeline",
    "silent_audio_branch",
    "gst_available",
    "GstShell",
]


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """OMX VCU encoder tuning (reference defaults).

    The low-latency parameter block is the reference's
    (``OpenCVequalHist.cpp:313-315``): 8 slices, IDR every 240 frames,
    low-latency control-rate, low-delay-P GOP, horizontal GDR.
    """

    codec: str = "h264"            # h264 | h265
    bitrate_kbps: int = 20000
    num_slices: int = 8
    periodicity_idr: int = 240
    cpb_size: int = 500
    initial_delay: int | None = None
    gdr_mode: str = "horizontal"
    control_rate: str = "low-latency"
    gop_mode: str = "low-delay-p"

    @property
    def element(self) -> str:
        return "omxh265enc" if self.codec == "h265" else "omxh264enc"

    @property
    def payloader(self) -> str:
        return "rtph265pay" if self.codec == "h265" else "rtph264pay"

    def encoder_str(self) -> str:
        s = (
            f"{self.element} num-slices={self.num_slices} "
            f"periodicity-idr={self.periodicity_idr} cpb-size={self.cpb_size} "
            f"gdr-mode={self.gdr_mode} control-rate={self.control_rate} "
            f"target-bitrate={self.bitrate_kbps} gop-mode={self.gop_mode}"
        )
        if self.initial_delay is not None:
            s += f" initial-delay={self.initial_delay}"
        return s


def capture_pipeline(
    device: str = "/dev/video0",
    width: int = 1920,
    height: int = 1080,
    fps: int = 60,
    queue_buffers: int = 8,
    appsink_name: str = "cv_sink",
) -> str:
    """Live camera -> NV12 -> appsink (dmabuf zero-copy, drop-on-overload)."""
    return (
        f"v4l2src device={device} io-mode=4 ! "
        f"video/x-raw,format=NV12,width={width},height={height},framerate={fps}/1 ! "
        f"videorate drop-only=true max-rate={fps} ! "
        f"queue name=q_cam leaky=downstream max-size-buffers={queue_buffers} ! "
        f"appsink name={appsink_name} emit-signals=true max-buffers=1 drop=true sync=false"
    )


def emit_pipeline(
    enc: EncoderConfig,
    width: int = 1920,
    height: int = 1080,
    fps: int = 60,
    host: str = "192.168.25.69",
    port: int = 5004,
    appsrc_name: str = "my_src",
    tuned: bool = False,
) -> str:
    """appsrc -> OMX encode -> RTP pay -> UDP sink.

    ``tuned=True`` applies the binary-only ``improvement`` ELF deltas
    (mtu 1200, bigger cpb + initial-delay, tighter queues, 100 MB socket).
    """
    if tuned:
        enc = dataclasses.replace(enc, cpb_size=1000, initial_delay=500)
    appsrc_extra = " max-buffers=8" if tuned else ""
    q_buffers = 4 if tuned else 2
    pay_extra = " mtu=1200" if tuned else ""
    buf_size = 100_000_000 if tuned else 60_000_000
    return (
        f"appsrc name={appsrc_name} is-live=true do-timestamp=true format=time "
        f"block=false{appsrc_extra} "
        f"caps=video/x-raw,format=NV12,width={width},height={height},framerate={fps}/1 ! "
        f"queue name=q_after_src leaky=downstream max-size-buffers={q_buffers} ! "
        f"{enc.encoder_str()} ! "
        f"{enc.payloader} pt=96{pay_extra} ! "
        f"udpsink host={host} port={port} sync=false buffer-size={buf_size} qos-dscp=60"
    )


def file_capture_pipeline(
    path: str,
    width: int = 1280,
    height: int = 720,
    fps_num: int = 30,
    fps_den: int = 1,
    appsink_name: str = "cv_sink",
) -> str:
    """filesrc -> decodebin -> convert/scale/rate -> NV12 -> appsink."""
    return (
        f'filesrc location="{path}" ! decodebin ! '
        f"videoconvert ! videoscale ! videorate ! "
        f"video/x-raw,format=NV12,width={width},height={height},"
        f"framerate={fps_num}/{fps_den} ! "
        f"appsink name={appsink_name} emit-signals=true max-buffers=4 drop=false sync=false"
    )


def test_capture_pipeline(
    width: int = 1920,
    height: int = 1080,
    fps: int = 30,
    num_buffers: int | None = None,
    appsink_name: str = "cv_sink",
) -> str:
    """videotestsrc -> NV12 -> appsink: the camera-less test capture (the
    reference's ``videotestsrc`` senders, ``webrtc/vad.cpp:312-330``)."""
    nb = f" num-buffers={num_buffers}" if num_buffers is not None else ""
    return (
        f"videotestsrc is-live=true{nb} ! "
        f"video/x-raw,format=NV12,width={width},height={height},framerate={fps}/1 ! "
        f"appsink name={appsink_name} emit-signals=true max-buffers=1 drop=true sync=false"
    )


def mp4_capture_pipeline(path: str, appsink_name: str = "cv_sink",
                         decoder: str = "omx") -> str:
    """MP4 H.264 hardware-decode capture (``AirplanMP4.cpp:309-317``).

    ``decoder``: "omx" (the reference's VCU element) or "avdec" (software
    fallback for hosts without an OMX stack, same demux/parse chain)."""
    dec = "omxh264dec" if decoder == "omx" else "avdec_h264 ! videoconvert"
    return (
        f'filesrc location="{path}" ! qtdemux ! h264parse ! {dec} ! '
        f"video/x-raw,format=NV12 ! "
        f"appsink name={appsink_name} emit-signals=true max-buffers=4 drop=false sync=false"
    )


def file_emit_pipeline(
    enc: EncoderConfig,
    width: int = 1280,
    height: int = 720,
    fps_num: int = 30,
    fps_den: int = 1,
    host: str = "192.168.25.69",
    port: int = 5004,
    output_file: str | None = None,
    appsrc_name: str = "my_src",
) -> str:
    """appsrc -> encode -> [udp only | tee -> rtp/udp + mp4mux -> filesink]."""
    head = (
        f"appsrc name={appsrc_name} format=time block=true "
        f"caps=video/x-raw,format=NV12,width={width},height={height},"
        f"framerate={fps_num}/{fps_den} ! "
        f"queue ! {enc.encoder_str()} ! "
    )
    if output_file is None:
        return head + f"{enc.payloader} pt=96 ! udpsink host={host} port={port} sync=false"
    parse = "h265parse" if enc.codec == "h265" else "h264parse"
    return (
        head
        + f"tee name=t "
        f"t. ! queue ! {enc.payloader} pt=96 ! udpsink host={host} port={port} sync=false "
        f't. ! queue ! {parse} ! mp4mux ! filesink location="{output_file}"'
    )


def _webrtc_bin(name: str, stun_server: str, latency: int | None = None) -> str:
    """Shared webrtcbin tail (all sender variants end here)."""
    tail = (f"webrtcbin name={name} stun-server={stun_server} "
            f"bundle-policy=max-bundle")
    if latency is not None:
        tail += f" latency={latency}"
    return tail


def webrtc_pipeline(
    enc: EncoderConfig,
    device: str = "/dev/video0",
    width: int = 1920,
    height: int = 1080,
    fps: int = 30,
    stun_server: str = "stun://stun.l.google.com:19302",
    webrtc_name: str = "sendrecv",
    profile: str | None = None,
) -> str:
    """Camera -> OMX encode -> rtp pay -> webrtcbin (``webrtc/sender.cpp:105-141``)."""
    prof = profile or ("main" if enc.codec == "h265" else "baseline")
    caps = (
        f"video/x-h265,profile={prof}" if enc.codec == "h265"
        else f"video/x-h264,stream-format=byte-stream,profile={prof}"
    )
    return (
        f"v4l2src device={device} io-mode=4 ! "
        f"video/x-raw,format=NV12,width={width},height={height},framerate={fps}/1 ! "
        f"{enc.encoder_str()} ! {caps} ! "
        f"{enc.payloader} config-interval=-1 pt=96 mtu=1200 ! "
        f"application/x-rtp,media=video,encoding-name="
        f"{'H265' if enc.codec == 'h265' else 'H264'},payload=96 ! "
        + _webrtc_bin(webrtc_name, stun_server, latency=0)
    )


def webrtc_pipeline_sw(
    codec: str = "h264",
    device: str = "/dev/video0",
    width: int = 1280,
    height: int = 720,
    fps: int = 30,
    bitrate_kbps: int = 2000,
    stun_server: str = "stun://stun.l.google.com:19302",
    webrtc_name: str = "sendrecv",
) -> str:
    """Software-encoder WebRTC pipeline (``webrtc/index.cpp:239-273``):
    x264/x265 tune=zerolatency with mtu=1200."""
    if codec == "h265":
        enc = (f"videoconvert ! x265enc tune=zerolatency speed-preset=ultrafast "
               f"bitrate={bitrate_kbps} ! video/x-h265 ! "
               f"rtph265pay config-interval=-1 pt=96 mtu=1200")
        enc_name = "H265"
    else:
        enc = (f"videoconvert ! x264enc tune=zerolatency speed-preset=ultrafast "
               f"bitrate={bitrate_kbps} key-int-max={2 * fps} ! "
               f"video/x-h264,profile=baseline ! "
               f"rtph264pay config-interval=-1 pt=96 mtu=1200")
        enc_name = "H264"
    return (
        f"v4l2src device={device} ! "
        f"video/x-raw,width={width},height={height},framerate={fps}/1 ! "
        f"{enc} ! "
        f"application/x-rtp,media=video,encoding-name={enc_name},payload=96 ! "
        + _webrtc_bin(webrtc_name, stun_server)  # reference index.cpp: no
        # io-mode/NV12 caps (videoconvert path) and no latency override
    )


def webrtc_pipeline_vp8(
    device: str = "/dev/video0",
    width: int = 1920,
    height: int = 1080,
    fps: int = 30,
    target_bitrate: int = 25_000_000,
    stun_server: str = "stun://stun.l.google.com:19302",
    webrtc_name: str = "sendrecv",
) -> str:
    """VP8 WebRTC pipeline (``webrtc/claude.cpp:233-249``): NV12 ->
    videoconvert I420 -> vp8enc deadline=1 cpu-used=8."""
    return (
        f"v4l2src device={device} io-mode=4 ! "
        f"video/x-raw,format=NV12,width={width},height={height},framerate={fps}/1 ! "
        f"videoconvert ! video/x-raw,format=I420 ! "
        f"vp8enc deadline=1 cpu-used=8 threads=4 target-bitrate={target_bitrate} "
        f"keyframe-max-dist={2 * fps} ! "
        f"rtpvp8pay pt=96 mtu=1200 ! "
        f"application/x-rtp,media=video,encoding-name=VP8,payload=96 ! "
        + _webrtc_bin(webrtc_name, stun_server)
    )


def vad_test_pipeline(
    stun_server: str = "stun://stun.l.google.com:19302",
    webrtc_name: str = "webrtcbin",
    video_bitrate: int = 10_240_000,
) -> str:
    """Two-track test sender (``webrtc/vad.cpp:312-330`` / ``atc.cpp``):
    videotestsrc -> VP8 and audiotestsrc -> Opus into one webrtcbin."""
    return (
        f"webrtcbin name={webrtc_name} bundle-policy=max-bundle latency=100 "
        f"stun-server={stun_server} "
        f"videotestsrc is-live=true ! videoconvert ! queue ! "
        f"vp8enc target-bitrate={video_bitrate} deadline=1 ! rtpvp8pay ! "
        f"application/x-rtp,media=video,encoding-name=VP8,payload=96 ! "
        f"{webrtc_name}. "
        f"audiotestsrc is-live=true ! audioconvert ! audioresample ! queue ! "
        f"opusenc ! rtpopuspay ! "
        f"application/x-rtp,media=audio,encoding-name=OPUS,payload=97 ! "
        f"{webrtc_name}."
    )


def silent_audio_branch(webrtc_name: str = "sendrecv") -> str:
    """Silent Opus audio track (``webrtc/vadcamera.cpp:415-487``): keeps
    browsers' AV sync state machines happy on video-only senders."""
    return (
        f"audiotestsrc wave=silence is-live=true ! "
        f"audio/x-raw,rate=48000,channels=2 ! audioconvert ! opusenc ! "
        f"rtpopuspay pt=97 ! "
        f"application/x-rtp,media=audio,encoding-name=OPUS,payload=97 ! "
        f"{webrtc_name}."
    )


def gst_available() -> bool:
    return shutil.which("gst-launch-1.0") is not None


class GstShell:
    """Launch a pipeline description via gst-launch-1.0 (when present).

    For full appsink/appsrc integration a GStreamer python (gi) stack is
    required; this shell covers the launch-and-stream cases (e.g. replaying
    a processed file over RTP) on deployment hosts.
    """

    def __init__(self, description: str):
        self.description = description
        self.proc: subprocess.Popen | None = None

    def start(self) -> None:
        if not gst_available():
            raise RuntimeError(
                "gst-launch-1.0 not found: install GStreamer or use the "
                "cv2-based io.videofile sinks"
            )
        self.proc = subprocess.Popen(
            ["gst-launch-1.0", "-q", *shlex.split(self.description)]
        )

    def stop(self) -> None:
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=5)
            self.proc = None
