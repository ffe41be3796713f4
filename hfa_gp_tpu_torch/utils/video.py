"""Video assembly of the port (counterpart of hfa_gp_tpu/utils/video.py).

libx264 through imageio where it is installed with an ffmpeg backend;
otherwise a dependency-free MJPEG AVI (PIL JPEG frames in a RIFF
container), which VLC, ffmpeg and browsers with AVI support play.
"""

from __future__ import annotations

import contextlib
import io
import os
import struct

from PIL import Image


def _imageio_writer(path: str, fps: int):
    """An imageio libx264 writer, or None where imageio or its ffmpeg
    backend is missing."""
    try:
        import imageio
        return imageio.get_writer(path, mode="I", fps=fps, codec="libx264",
                                  bitrate="12M")
    except (ImportError, ValueError, RuntimeError, OSError):
        return None


def write_mjpeg_avi(frames, path: str, fps: int = 24,
                    quality: int = 90) -> None:
    """frames: (H, W, 3) uint8 arrays → MJPEG AVI at `path`."""
    jpegs = []
    for arr in frames:
        buf = io.BytesIO()
        Image.fromarray(arr, "RGB").save(buf, "JPEG", quality=quality)
        data = buf.getvalue()
        jpegs.append(data + b"\x00" * (len(data) % 2))
    if not jpegs:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    n, max_size = len(jpegs), max(len(j) for j in jpegs)

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        return fourcc + struct.pack("<I", len(payload)) + payload \
            + b"\x00" * (len(payload) % 2)

    def lst(fourcc: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", fourcc + payload)

    avih = struct.pack("<IIIIIIIIIIIIII", int(1e6 / fps), max_size * fps,
                       0, 0x10, n, 0, 1, max_size, w, h, 0, 0, 0, 0)
    strh = b"vids" + b"MJPG" + struct.pack(
        "<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1, fps, 0, n, max_size, 0xFFFFFFFF,
        0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3,
                       0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi = lst(b"movi", b"".join(chunk(b"00dc", j) for j in jpegs))
    index, offset = [], 4
    for j in jpegs:
        index.append(struct.pack("<4sIII", b"00dc", 0x10, offset, len(j)))
        offset += 8 + len(j)
    body = b"AVI " + hdrl + movi + chunk(b"idx1", b"".join(index))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def write_video_frames(frames, path: str, fps: int = 24) -> str:
    """Write (H, W, 3) uint8 frames to `path`; returns the path written,
    whose extension is .avi when the MJPEG writer was used."""
    frames = list(frames)
    writer = _imageio_writer(path, fps)
    if writer is not None:
        try:
            for f in frames:
                writer.append_data(f)
            writer.close()
            return path
        except (ValueError, RuntimeError, OSError):
            # the ffmpeg backend can fail on the first frame only
            with contextlib.suppress(ValueError, RuntimeError, OSError):
                writer.close()
            if os.path.exists(path):
                os.remove(path)
    avi_path = os.path.splitext(path)[0] + ".avi"
    write_mjpeg_avi(frames, avi_path, fps=fps)
    return avi_path
