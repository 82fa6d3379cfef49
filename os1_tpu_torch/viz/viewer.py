"""Viewer: live windows and/or periodic snapshots of the frame overlay + 3D
map — the reference Viewer thread (Viewer.cc:77-473) minus Pangolin's 3D
mouse navigation.

Interaction parity with the reference's key table (Viewer.cc:171-249) and
menu panel (Viewer.cc:92-104), keys standing in for Pangolin's buttons:

  t      cycle display scale 1 / 0.5 / 0.25            (Viewer.cc:174-184)
  r      reverse video playback (file inputs)          (Viewer.cc:187-191)
  space  pause / resume                                (Viewer.cc:194-196)
  u      toggle undistorted input view                 (Viewer.cc:199-202)
  e      show / hide the raw input window              (Viewer.cc:205-207)
  a      automatic mode: auto-reverse while LOST       (Viewer.cc:210-212,400-405)
  i      seek jump (debug; here: back one second)      (Viewer.cc:215-219)
  c      cycle map-save option bits                    (Viewer.cc:222-233)
  p      print the current pose to the console         (Viewer.cc:237-239)
  v      verbose relocalization (one-shot)             (Viewer.cc:247-248)
  1      toggle map points          (menu.Puntos del mapa)
  2      toggle keyframe frusta     (menu.KeyFrames)
  3      toggle covisibility graph  (menu.Grafo)
  l      toggle localization mode   (menu.Tracking, sin mapeo)
  g      save map                   (menu.Guardar mapa)
  o      load map                   (menu.Cargar mapa)
  b      start/stop view recording  (menu.Grabar, Viewer.cc:352-376)
  R      reset the system           (menu.Reset)
  q/ESC  quit                       (menu.Salir)

A time trackbar mirrors and drives the video position (Viewer.cc:128,
379-394 -> VideoSource.seek, Video.cpp:154-159). Headless mode (no display)
writes PNG snapshots instead; ``Viewer(live=False, snapshot_dir=None)`` draws
nothing and only drives the automatic mode, with no OpenCV needed.

Port of os1_tpu/viz/viewer.py. The playback position is read as
``VideoSource.position``, a property (the JAX package calls it, which raises
once a video trackbar exists).
"""
from __future__ import annotations

import os

import numpy as np

from .frame_drawer import FrameDrawer
from .map_drawer import draw_map

_FRAME_WIN = "os1-tpu: frame"
_MAP_WIN = "os1-tpu: map"
_INPUT_WIN = "os1-tpu: input"


class Viewer:
    def __init__(self, system, live: bool = False,
                 snapshot_dir: str | None = None, snapshot_every: int = 30,
                 video_source=None):
        self.system = system
        self.live = live
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = snapshot_every
        self.video = video_source  # VideoSource | None: seek/pause/reverse
        self.frame_count = 0
        self.quit_requested = False
        self.pause_requested = False
        # Menu state (reference menu booleans, Viewer.cc:92-104).
        self.show_points = True
        self.show_keyframes = True
        self.show_graph = True
        self.show_input = False
        self.show_undistorted = False
        self.auto_mode = False  # auto-reverse while LOST (Viewer.cc:400-405)
        self._auto_forward = True  # direction when tracking is OK
        self.display_scale = 1.0  # 't' cycles 1 -> 0.5 -> 0.25
        self.map_save_options = 0  # 'c' cycles the Osmap option bits
        self._recorder = None  # cv2.VideoWriter when recording ('b')
        self._trackbar_ready = False
        self._trackbar_last = -1
        self.frame_drawer = FrameDrawer(system)
        if snapshot_dir:
            os.makedirs(snapshot_dir, exist_ok=True)

    # ------------------------------------------------------------------ #
    def update(self, img: np.ndarray, state, Tcw) -> None:
        self.frame_count += 1
        want_snapshot = (
            self.snapshot_dir is not None
            and self.frame_count % self.snapshot_every == 0
        )
        if not (self.live or want_snapshot or self._recorder is not None):
            self._drive_auto_mode(state)
            return

        st = self.system.store
        self.frame_drawer.update(img, state)
        frame_img = self.frame_drawer.draw()
        map_img = draw_map(
            st, Tcw, show_points=self.show_points,
            show_keyframes=self.show_keyframes, show_graph=self.show_graph,
        )

        if want_snapshot:
            import cv2

            cv2.imwrite(
                os.path.join(self.snapshot_dir, f"frame_{self.frame_count:06d}.png"),
                frame_img,
            )
            cv2.imwrite(
                os.path.join(self.snapshot_dir, f"map_{self.frame_count:06d}.png"),
                map_img,
            )
        if self._recorder is not None:
            self._record(frame_img, map_img)
        if self.live:
            self._show_live(img, frame_img, map_img, state)
        self._drive_auto_mode(state)

    # ------------------------------------------------------------------ #
    def _show_live(self, img, frame_img, map_img, state):
        import cv2

        s = self.display_scale
        if s != 1.0:
            frame_img = cv2.resize(frame_img, None, fx=s, fy=s)
        if not self._trackbar_ready and self.video is not None and \
                getattr(self.video, "n_frames", 0):
            cv2.imshow(_FRAME_WIN, frame_img)
            cv2.createTrackbar(
                "tiempo", _FRAME_WIN, 0, max(self.video.n_frames, 1),
                self._on_trackbar,
            )
            # Far-point parallax parameter (reference 'Parámetro' trackbar,
            # Viewer.cc:133 -> LocalMapping::param).
            cv2.createTrackbar(
                "Parametro", _FRAME_WIN, 1000, 1000,
                self.system.set_far_parallax_param,
            )
            # Map-point inspection on click (FrameDrawer::onMouse).
            cv2.setMouseCallback(_FRAME_WIN, self._on_mouse)
            self._trackbar_ready = True
        cv2.imshow(_FRAME_WIN, frame_img)
        cv2.imshow(_MAP_WIN, map_img)
        if self.show_input:
            shown = img
            if self.show_undistorted:
                shown = self._undistort_input(img)
            if s != 1.0:
                shown = cv2.resize(shown, None, fx=s, fy=s)
            cv2.imshow(_INPUT_WIN, shown)
        # Reflect playback position on the trackbar (Viewer.cc:385-394).
        if self._trackbar_ready and not self.video.paused:
            pos = self.video.position
            if pos != self._trackbar_last:
                self._trackbar_last = pos
                cv2.setTrackbarPos("tiempo", _FRAME_WIN, pos)
        self._handle_key(cv2.waitKey(1) & 0xFF)

    def _on_trackbar(self, pos: int):
        """User moved the time trackbar -> video seek (Video.cpp:154-159)."""
        if self.video is not None and abs(pos - self._trackbar_last) > 1:
            self._trackbar_last = pos
            self.video.seek(pos)

    def _on_mouse(self, event, x, y, flags=None, userdata=None):
        """Click -> map-point inspection report (FrameDrawer::onMouse,
        FrameDrawer.cc:271-313), display-scale corrected."""
        import cv2

        if event != cv2.EVENT_LBUTTONDOWN:
            return
        s = self.display_scale
        self.frame_drawer.inspect(x / s, y / s, radius=2.0 / s)

    def _undistort_input(self, img):
        import cv2

        cam = self.system.cfg.camera
        K = np.array(
            [[float(cam.fx), 0, float(cam.cx)],
             [0, float(cam.fy), float(cam.cy)], [0, 0, 1]]
        )
        dist = cam.dist.detach().cpu().numpy()[:5]
        return cv2.undistort(img, K, dist)

    # ------------------------------------------------------------------ #
    def _handle_key(self, key: int) -> None:
        import cv2

        if key in (ord("q"), 27):
            self.quit_requested = True
        elif key == ord(" "):
            self.pause_requested = not self.pause_requested
            if self.video is not None:
                self.video.set_pause(self.pause_requested)
        elif key == ord("t"):
            self.display_scale = {1.0: 0.5, 0.5: 0.25}.get(self.display_scale, 1.0)
        elif key == ord("r"):
            if self.video is not None:
                self.video.set_reverse(not self.video.reversed)
                self._auto_forward = not self.video.reversed
        elif key == ord("u"):
            self.show_undistorted = not self.show_undistorted
            self.show_input = True
        elif key == ord("e"):
            self.show_input = not self.show_input
            if not self.show_input:
                cv2.destroyWindow(_INPUT_WIN)
        elif key == ord("a"):
            self.auto_mode = not self.auto_mode
        elif key == ord("i"):
            if self.video is not None:
                self.video.seek(max(0, self.video.position - int(self.video.fps)))
        elif key == ord("c"):
            self.map_save_options = (self.map_save_options + 1) % 4
            names = {0: "normal", 1: "ONLY_MAPPOINTS_FEATURES",
                     2: "NO_FEATURES_DESCRIPTORS",
                     3: "ONLY_MAPPOINTS_FEATURES|NO_FEATURES_DESCRIPTORS"}
            print(f"map save option: {names[self.map_save_options]}")
        elif key == ord("p"):
            tr = self.system.tracker
            pose = tr.last.Tcw if tr.last is not None else None
            print(f"current frame pose:\n{pose}")
        elif key == ord("v"):
            reloc = self.system.tracker.relocalizer
            if reloc is not None:
                reloc.verbose = True  # one-shot console detail
        elif key == ord("1"):
            self.show_points = not self.show_points
        elif key == ord("2"):
            self.show_keyframes = not self.show_keyframes
        elif key == ord("3"):
            self.show_graph = not self.show_graph
        elif key == ord("l"):
            if self.system.tracker.only_tracking:
                self.system.deactivate_localization_mode()
            else:
                self.system.activate_localization_mode()
        elif key == ord("g"):
            self.system.save_map("viewer_saved_map", self.map_save_options)
        elif key == ord("o"):
            if os.path.exists("viewer_saved_map.yaml"):
                self.system.load_map("viewer_saved_map")
        elif key == ord("b"):
            self._toggle_recording()
        elif key == ord("R"):
            self.system.reset()

    # ------------------------------------------------------------------ #
    def _toggle_recording(self):
        """Record the composited frame+map view (menu.Grabar,
        Viewer.cc:352-376)."""
        import cv2

        if self._recorder is None:
            self._rec_size = None
            self._recorder = cv2.VideoWriter()
            print("recording to os1_view.avi")
        else:
            self._recorder.release()
            self._recorder = None
            print("recording stopped")

    def _record(self, frame_img, map_img):
        import cv2

        h = 720
        fscale = h / frame_img.shape[0]
        mscale = h / map_img.shape[0]
        f = cv2.resize(frame_img, None, fx=fscale, fy=fscale)
        m = cv2.resize(map_img, None, fx=mscale, fy=mscale)
        composite = cv2.hconcat([f, m])
        if not self._recorder.isOpened():
            self._rec_size = (composite.shape[1], composite.shape[0])
            self._recorder.open(
                "os1_view.avi", cv2.VideoWriter_fourcc(*"MJPG"), 30.0,
                self._rec_size, True,
            )
        if composite.shape[:2][::-1] != self._rec_size:
            composite = cv2.resize(composite, self._rec_size)
        self._recorder.write(composite)

    # ------------------------------------------------------------------ #
    def _drive_auto_mode(self, state):
        """Automatic mode: reverse the video while LOST, restore direction
        once relocalized (Viewer.cc:400-405)."""
        if not self.auto_mode or self.video is None:
            return
        from ..pipeline import TrackingState

        if state == TrackingState.OK:
            self.video.set_reverse(not self._auto_forward)
        elif state == TrackingState.LOST:
            self.video.set_reverse(self._auto_forward)

    def close(self):
        if self._recorder is not None:
            self._recorder.release()
            self._recorder = None
        if self.live:
            import cv2

            cv2.destroyAllWindows()
