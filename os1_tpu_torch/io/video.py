"""Video input: webcam/file capture with the reference Video thread's
semantics (Video.cpp: stream modes NEGRO/CAM/VIDEO/VIDEO_RT, pause, reverse,
seek, producer-consumer handover). Port of os1_tpu/io/video.py; OpenCV is
imported only when a camera or a file is opened.

A background thread pumps frames into a 1-slot latest-frame mailbox for the
real-time modes (CAM / VIDEO_RT overwrite the latest image, Video.cpp:60-73)
or a blocking queue for lossless VIDEO mode (condition-variable gate so
non-realtime processing never drops frames, Video.cpp:40-48).
"""
from __future__ import annotations

import enum
import threading
import time

import numpy as np


class StreamMode(enum.Enum):
    NEGRO = 0  # black frames (idle), Video.h modo NEGRO
    CAM = 1  # live camera, realtime (latest frame wins)
    VIDEO = 2  # file, lossless (every frame delivered)
    VIDEO_RT = 3  # file, realtime pacing (frames may drop)


class VideoSource:
    """Frame source with pause / reverse / seek controls."""

    def __init__(self, path: str | int | None = None,
                 mode: StreamMode | None = None,
                 width: int = 640, height: int = 480, fps: float = 30.0):
        self.width = width
        self.height = height
        self.fps = fps
        self.paused = False
        self.reversed = False
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._latest = None
        self._latest_id = -1
        self._consumed_id = -1
        self._stop = False
        self._cap = None
        self._pos = 0

        if path is None:
            self.mode = mode or StreamMode.NEGRO
        elif isinstance(path, int):
            self.mode = StreamMode.CAM
        else:
            self.mode = mode or StreamMode.VIDEO

        if path is not None:
            import cv2

            self._cap = cv2.VideoCapture(path)
            if not self._cap.isOpened():
                raise IOError(f"cannot open video source {path!r}")
            self.n_frames = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
            f = self._cap.get(cv2.CAP_PROP_FPS)
            if f and f > 0:
                self.fps = f
        else:
            self.n_frames = 0

        self._thread = threading.Thread(target=self._run, daemon=True, name="Video")
        self._thread.start()

    # -- controls (Viewer keys space/r/trackbar in the reference) -------- #
    def set_pause(self, paused: bool):
        self.paused = paused

    def set_reverse(self, reversed_: bool):
        """Reverse playback (file modes only; os1's 'automatic mode' uses
        this to rewind until relocalized, Viewer.cc:400-405)."""
        self.reversed = reversed_

    def seek(self, frame_pos: int):
        """Jump to a frame (Video::setCuadroPos, Video.cpp:154-159)."""
        with self._lock:
            self._pos = max(0, frame_pos)
            if self._cap is not None:
                import cv2

                self._cap.set(cv2.CAP_PROP_POS_FRAMES, self._pos)

    def stop(self):
        self._stop = True
        self._thread.join(timeout=2.0)
        if self._cap is not None:
            self._cap.release()

    # -- producer -------------------------------------------------------- #
    def _read_frame(self):
        if self._cap is None:  # black mode: no OpenCV needed
            return np.zeros((self.height, self.width), np.float32)
        import cv2

        with self._lock:
            if self.reversed and self.mode in (StreamMode.VIDEO, StreamMode.VIDEO_RT):
                self._pos = max(0, self._pos - 2)
                self._cap.set(cv2.CAP_PROP_POS_FRAMES, self._pos)
        ok, frame = self._cap.read()
        if not ok:
            return None
        self._pos += 1
        if frame.ndim == 3:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        return frame.astype(np.float32)

    def _run(self):
        period = 1.0 / max(self.fps, 1.0)
        while not self._stop:
            if self.paused:
                time.sleep(0.01)
                continue
            if self.mode == StreamMode.VIDEO:
                # Lossless: wait until the consumer took the last frame.
                with self._cv:
                    while (
                        self._latest_id != self._consumed_id and not self._stop
                    ):
                        self._cv.wait(timeout=0.1)
                if self._stop:
                    break
            frame = self._read_frame()
            if frame is None:
                self._stop = True
                with self._cv:
                    self._cv.notify_all()
                break
            with self._cv:
                self._latest = frame
                self._latest_id += 1
                self._cv.notify_all()
            if self.mode in (StreamMode.CAM, StreamMode.VIDEO_RT):
                time.sleep(period * 0.25)

    # -- consumer (Video::getImagen, Video.cpp:60-73) -------------------- #
    def get_image(self, timeout: float = 5.0):
        """Next frame, or None at end of stream."""
        deadline = time.time() + timeout
        with self._cv:
            while self._latest_id == self._consumed_id:
                if self._stop:
                    return None
                remaining = deadline - time.time()
                if remaining <= 0:
                    return None
                self._cv.wait(timeout=min(remaining, 0.1))
            self._consumed_id = self._latest_id
            frame = self._latest
            self._cv.notify_all()
            return frame

    @property
    def position(self) -> int:
        return self._pos
