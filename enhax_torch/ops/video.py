"""Host-side video I/O over OpenCV and the ffmpeg binary.

Port of ``enhax/ops/video.py``: ``VideoReaderCV`` streams RGB frames,
``VideoWriterCV`` writes them through OpenCV, ``VideoWriterFFmpeg`` pipes
raw rgb24 frames into an ffmpeg encoder subprocess (codecs and containers
beyond OpenCV's), and ``make_video_writer`` picks between the two. Frames
are RGB HWC numpy arrays on the host, float in [0, 1] or uint8. OpenCV is
imported, and the ffmpeg binary looked up, inside the functions, as
``ops/io.py`` does, so the package imports on machines that lack them.
"""

from __future__ import annotations

import collections
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np


def _to_uint8(frame) -> np.ndarray:
    frame = np.asarray(frame)
    if frame.dtype in (np.float32, np.float64, np.float16):
        frame = np.clip(frame * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return frame


class VideoReaderCV:
    """Stream RGB frames from a video file (float32 in [0, 1] by default)."""

    def __init__(self, path, to_float: bool = True):
        import cv2
        self.path = str(path)
        self.cap = cv2.VideoCapture(self.path)
        if not self.cap.isOpened():
            raise FileNotFoundError(f"cannot open video: {path}")
        self.to_float = to_float
        self.frame_count = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.fps = float(self.cap.get(cv2.CAP_PROP_FPS)) or 30.0
        self.height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.index = 0

    def __len__(self) -> int:
        return max(self.frame_count, 0)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        import cv2
        ok, frame = self.cap.read()
        if not ok:
            self.cap.release()
            raise StopIteration
        self.index += 1
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        if self.to_float:
            frame = frame.astype(np.float32) / 255.0
        return frame

    def close(self) -> None:
        self.cap.release()


class VideoWriterCV:
    """Write RGB frames to a video file through OpenCV; sized by the first
    frame unless ``size`` (h, w) is given (other frames are resized)."""

    def __init__(self, path, fps: float = 30.0, size: tuple[int, int] | None = None,
                 fourcc: str = "mp4v"):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.fps = fps
        self.size = size
        self.fourcc = fourcc
        self.writer = None

    def write(self, frame) -> None:
        import cv2
        frame = _to_uint8(frame)
        if self.writer is None:
            h, w = self.size if self.size else frame.shape[:2]
            self.size = (h, w)
            self.writer = cv2.VideoWriter(str(self.path), cv2.VideoWriter_fourcc(*self.fourcc),
                                          self.fps, (w, h))
        if frame.shape[:2] != self.size:
            frame = cv2.resize(frame, (self.size[1], self.size[0]))
        self.writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))

    def write_batch(self, frames) -> None:
        for f in frames:
            self.write(f)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.release()
            self.writer = None


def is_ffmpeg_available(binary: str = "ffmpeg") -> bool:
    return shutil.which(binary) is not None


class VideoWriterFFmpeg:
    """Pipe RGB frames into an ffmpeg encoder subprocess: rawvideo rgb24 on
    stdin, encoded to ``pix_fmt`` (yuv420p by default; odd sizes padded by
    one pixel) at ``fps``, the destination overwritten; ``extra_args`` go
    to the output as they are. Sized by the first frame as
    ``VideoWriterCV``. The encoder's stderr is drained on a thread (an
    undrained pipe fills and deadlocks ffmpeg against stdin); a failed
    write or close raises with its last lines."""

    def __init__(self, path, fps: float = 30.0, size: tuple[int, int] | None = None,
                 pix_fmt: str = "yuv420p", codec: str | None = None, binary: str = "ffmpeg",
                 extra_args: tuple = (), verbose: bool = False):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.fps = fps
        self.size = size
        self.pix_fmt = pix_fmt
        self.codec = codec
        self.binary = binary
        self.extra_args = tuple(extra_args)
        self.verbose = verbose
        self.proc = None
        self._stderr_thread = None
        self._stderr_tail = collections.deque(maxlen=64)

    def _start(self, frame) -> None:
        if not is_ffmpeg_available(self.binary):
            raise RuntimeError(f"{self.binary!r} not found on PATH; use VideoWriterCV")
        h, w = self.size if self.size else frame.shape[:2]
        self.size = (h, w)
        cmd = [self.binary, "-y", "-f", "rawvideo", "-pix_fmt", "rgb24", "-s", f"{w}x{h}",
               "-r", str(self.fps), "-i", "pipe:"]
        if not self.verbose:
            cmd += ["-loglevel", "error"]
        if self.codec:
            cmd += ["-c:v", self.codec]
        cmd += ["-pix_fmt", self.pix_fmt]
        if self.pix_fmt == "yuv420p" and (h % 2 or w % 2):
            cmd += ["-vf", "pad=ceil(iw/2)*2:ceil(ih/2)*2"]
        cmd += [*self.extra_args, str(self.path)]
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stderr=subprocess.PIPE)

        def drain(stream, tail):
            for line in iter(stream.readline, b""):
                tail.append(line)

        self._stderr_thread = threading.Thread(
            target=drain, args=(self.proc.stderr, self._stderr_tail), daemon=True)
        self._stderr_thread.start()

    def _fail(self, action: str):
        rc = self.proc.poll()
        if self._stderr_thread is not None:
            self._stderr_thread.join(timeout=2.0)
        err = b"".join(self._stderr_tail).decode(errors="replace").strip()[-500:]
        self.proc = None
        raise RuntimeError(f"ffmpeg {action} {self.path} failed (exit {rc}): {err}")

    def write(self, frame) -> None:
        frame = np.ascontiguousarray(_to_uint8(frame))
        if self.proc is None:
            self._start(frame)
        if frame.shape[:2] != self.size:
            import cv2
            frame = cv2.resize(frame, (self.size[1], self.size[0]))
        try:
            self.proc.stdin.write(frame.tobytes())
        except OSError:   # BrokenPipeError included
            self._fail("encoding to")

    def write_batch(self, frames) -> None:
        for f in frames:
            self.write(f)

    def close(self) -> None:
        if self.proc is None:
            return
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        if self.proc.wait() != 0:
            self._fail("finalizing")
        self.proc = None


def make_video_writer(path, fps: float = 30.0, size=None, prefer: str = "auto", **kwargs):
    """``prefer="auto"``: the ffmpeg pipe where the binary exists, else
    OpenCV; ``"ffmpeg"`` / ``"cv2"`` force one."""
    if prefer == "ffmpeg" or (prefer == "auto" and is_ffmpeg_available()):
        return VideoWriterFFmpeg(path, fps=fps, size=size, **kwargs)
    return VideoWriterCV(path, fps=fps, size=size)
