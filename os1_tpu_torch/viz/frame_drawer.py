"""Frame overlay rendering: the reference FrameDrawer (FrameDrawer.cc:52-322).

Parity features:
  * NOT_INITIALIZED: yellow optical-flow lines from the init reference
    frame's keypoints to their current matches (FrameDrawer.cc:104-108).
  * OK: per-point health-colored filled markers — the MapPoint::color()
    taxonomy (MapPoint.cc:382-399): normal points turn from green to yellow
    with observation count; far-point classes render turquoise / violet /
    red-orange; weakly-observed "VO-class" matches draw the blue square
    (FrameDrawer.cc:119-139); unmatched keypoints draw orange circles
    (FrameDrawer.cc:141-144).
  * LOST: red circles + "PERDIDO... Candidatos: N" with the live
    relocalization candidate count (FrameDrawer.cc:197).
  * Status bar with state, KF/MP/match counts, pending-keyframe queue and
    VO-match count (DrawTextInfo, FrameDrawer.cc:162-216), over the os1
    health tint (greenness ~ match count).
  * Mouse map-point inspection: :meth:`FrameDrawer.inspect` reports id /
    distance / world position / origin class of the clicked point(s)
    (FrameDrawer::onMouse, FrameDrawer.cc:271-313) — wired to cv2 mouse
    events by the Viewer in live mode, callable directly headless.

Port of os1_tpu/viz/frame_drawer.py: numpy and OpenCV (imported inside the
drawing functions) over the host map store and the tracker's state; the
tracker's device tensors are read to the host only when a frame is drawn.
The far-point classes are the local mapper's.
"""
from __future__ import annotations

import numpy as np

from ..pipeline.local_mapping import FAR_CLASS_NAMES, FAR_COS, FAR_LOWCOS, FAR_NORMAL


def _host(a) -> np.ndarray:
    """A numpy array of a tensor (read from the device) or an array."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def _point_color(n_obs: int, far_class: int, quasi_inf: bool):
    """MapPoint::color() (MapPoint.cc:382-399), BGR."""
    g = int(np.clip(32 * (n_obs - 3), 0, 255))
    if far_class == FAR_NORMAL:
        return (0, 255, g)  # yellow greening with observations
    if far_class == FAR_LOWCOS:
        return (255, 255, g)  # turquoise whitening with observations
    if far_class == FAR_COS:
        return (255, 128, 255 if quasi_inf else 0)  # violet -> blue
    return (0, 0 if quasi_inf else 128, 255)  # svdInf: red -> orange


class FrameDrawer:
    """Stateful drawer fed by :meth:`update` each frame (the reference's
    FrameDrawer::Update snapshot-under-mutex, FrameDrawer.cc:222-269)."""

    def __init__(self, system):
        self.system = system
        self._img = None
        self._state_name = "NO_IMAGES_YET"
        self._xy = np.zeros((0, 2), np.float32)
        self._valid = np.zeros(0, bool)
        self._bind = np.full(0, -1, np.int64)
        self._init_xy = None  # init reference keypoints (flow-line origins)
        self._init_match = None  # [N] ref feature -> current feature (-1)
        self._cam_center = np.zeros(3, np.float32)
        self.n_tracked = 0
        self.n_vo = 0

    # ------------------------------------------------------------------ #
    def update(self, img: np.ndarray, state) -> None:
        """Snapshot the tracker's per-frame view state (host arrays)."""
        tr = self.system.tracker
        self._img = np.asarray(img)
        self._state_name = state.name
        if tr.last is not None:
            self._xy = _host(tr.last.data.feats.xy)
            self._valid = _host(tr.last.data.feats.valid)
            self._bind = tr.last.bind
            T = tr.last.Tcw
            self._cam_center = (-T[:3, :3].T @ T[:3, 3]).astype(np.float32)
        if state.name == "NOT_INITIALIZED" and tr.init_ref is not None:
            self._init_xy = _host(tr.init_ref.data.feats.xy)
            self._init_match = tr.last_init_match
            cur = tr._init_cur_frame
            if cur is not None:
                self._xy = _host(cur.feats.xy)
                self._valid = _host(cur.feats.valid)
        else:
            self._init_xy = None
            self._init_match = None

    # ------------------------------------------------------------------ #
    def draw(self, radio: float = 1.0) -> np.ndarray:
        """Compose the overlay. Returns a BGR uint8 image with the status
        bar appended (DrawFrame, FrameDrawer.cc:52-160)."""
        import cv2

        st = self.system.store
        g = np.clip(self._img if self._img is not None
                    else np.zeros((16, 16)), 0, 255).astype(np.uint8)
        out = cv2.cvtColor(g, cv2.COLOR_GRAY2BGR)
        state = self._state_name
        self.n_tracked = 0
        self.n_vo = 0
        n_candidatos = 0

        if state == "NOT_INITIALIZED" and self._init_xy is not None \
                and self._init_match is not None:
            # Init optical-flow lines (FrameDrawer.cc:104-108).
            m = np.asarray(self._init_match)
            for i in np.nonzero(m >= 0)[0]:
                p0 = tuple(np.int32(self._init_xy[i]))
                p1 = tuple(np.int32(self._xy[m[i]]))
                cv2.line(out, p0, p1, (0, 255, 255), max(int(radio), 1))
        elif state == "OK":
            far_class = getattr(st, "pt_far_class", None)
            r = 5
            for i in range(len(self._xy)):
                if not self._valid[i]:
                    continue
                p = (int(self._xy[i, 0]), int(self._xy[i, 1]))
                pid = int(self._bind[i]) if i < len(self._bind) else -1
                if pid >= 0 and st.pt_valid[pid]:
                    n_obs = int(st.pt_n_obs[pid])
                    if n_obs <= 1:
                        # "VO" match: a barely-constrained point
                        # (FrameDrawer.cc:131-137 blue square + dot).
                        cv2.rectangle(out, (p[0] - r, p[1] - r),
                                      (p[0] + r, p[1] + r), (255, 0, 0))
                        cv2.circle(out, p, int(2 * radio), (255, 0, 0), -1)
                        self.n_vo += 1
                    else:
                        fc = int(far_class[pid]) if far_class is not None \
                            else (FAR_LOWCOS if st.pt_far[pid] else FAR_NORMAL)
                        if fc != FAR_NORMAL:
                            n_candidatos += 1
                        qinf = bool(np.linalg.norm(st.pt_xyz[pid]) >= 1e5)
                        cv2.circle(out, p, int(2 * radio),
                                   _point_color(n_obs, fc, qinf), -1)
                        self.n_tracked += 1
                else:
                    # Unmatched keypoint: orange circle (FrameDrawer.cc:143).
                    cv2.circle(out, p, max(int(radio), 1), (0, 128, 255), 1)
        elif state == "LOST":
            for i in range(len(self._xy)):
                if self._valid[i]:
                    p = (int(self._xy[i, 0]), int(self._xy[i, 1]))
                    cv2.circle(out, p, max(int(radio), 1), (0, 0, 255), 1)

        # Health tint (os1 FrameDrawer.cc:181): greener = more matches.
        health = min(self.n_tracked / 150.0, 1.0)
        tint = np.zeros_like(out)
        tint[:, :, 1] = int(60 * health)
        out = cv2.addWeighted(out, 1.0, tint, 0.5, 0)

        return np.concatenate([out, self._text_bar(out.shape[1],
                                                   n_candidatos)], axis=0)

    def _text_bar(self, width: int, n_candidatos: int) -> np.ndarray:
        """DrawTextInfo (FrameDrawer.cc:162-216)."""
        import cv2

        st = self.system.store
        state = self._state_name
        color = (0, 0, 0)
        if state == "NOT_INITIALIZED":
            s = " TRYING TO INITIALIZE "
        elif state == "OK":
            pending = 0
            sched = getattr(self.system, "coop", None)
            if sched is not None:
                pending = sched.queue_size()
            elif self.system.mapping_worker is not None:
                pending = self.system.mapping_worker.queue_size()
            s = (f"SLAM MODE  KFs: {st.n_keyframes()}  MPs: {st.n_points()}"
                 f"  Matches: {self.n_tracked}")
            if n_candidatos:
                s += f", candidatos: {n_candidatos}"
            s += f", KF pendientes: {pending}" if pending else \
                 ", LocalMapping ocioso"
            if self.n_vo > 0:
                s += f", + VO matches: {self.n_vo}"
        elif state == "LOST":
            reloc = self.system.tracker.relocalizer
            n_cand = getattr(reloc, "last_n_candidates", 0) if reloc else 0
            s = f" PERDIDO. INTENTANDO RELOCALIZAR. Candidatos: {n_cand}"
            color = (0, 0, 128)
        else:
            s = " WAITING FOR IMAGES"
        bar = np.zeros((22, width, 3), np.uint8)
        bar[:] = color
        cv2.putText(bar, s, (6, 15), cv2.FONT_HERSHEY_PLAIN, 1.0,
                    (255, 255, 255), 1)
        return bar

    # ------------------------------------------------------------------ #
    def inspect(self, x: float, y: float, radius: float = 3.0) -> list:
        """Map-point inspection at image coords (x, y): the reference's
        FrameDrawer::onMouse click report (FrameDrawer.cc:271-313). Returns
        (and prints) one dict per map-point-bound keypoint within
        `radius` pixels."""
        st = self.system.store
        hits = []
        far_class = getattr(st, "pt_far_class", None)
        for i in range(len(self._xy)):
            pid = int(self._bind[i]) if i < len(self._bind) else -1
            if pid < 0 or not (i < len(self._valid) and self._valid[i]):
                continue
            px, py = self._xy[i]
            if abs(x - px) <= radius and abs(y - py) <= radius \
                    and st.pt_valid[pid]:
                pos = st.pt_xyz[pid]
                fc = int(far_class[pid]) if far_class is not None else 0
                rec = dict(
                    id=pid,
                    distance=float(np.linalg.norm(pos - self._cam_center)),
                    pt=(float(px), float(py)),
                    pos=tuple(float(v) for v in pos),
                    n_obs=int(st.pt_n_obs[pid]),
                    origen=FAR_CLASS_NAMES[fc],
                    far=bool(st.pt_far[pid]),
                )
                hits.append(rec)
                print(f"Id:{rec['id']}, distancia:{rec['distance']:.3f}, "
                      f"pt:({px:.1f},{py:.1f}), pos:{rec['pos']}, "
                      f"obs:{rec['n_obs']}, origen:{rec['origen']}")
        return hits


def draw_frame(
    img: np.ndarray,
    xy: np.ndarray,
    bound: np.ndarray,
    valid: np.ndarray,
    state_name: str = "OK",
    n_kfs: int = 0,
    n_pts: int = 0,
    n_matches: int = 0,
) -> np.ndarray:
    """Stateless one-shot overlay (legacy API kept for snapshot paths that
    have no System handy). Prefer :class:`FrameDrawer` for parity."""
    import cv2

    g = np.clip(img, 0, 255).astype(np.uint8)
    out = cv2.cvtColor(g, cv2.COLOR_GRAY2BGR)
    health = min(n_matches / 150.0, 1.0)
    tint = np.zeros_like(out)
    tint[:, :, 1] = int(60 * health)
    out = cv2.addWeighted(out, 1.0, tint, 0.5, 0)
    for i in range(len(xy)):
        if not valid[i]:
            continue
        p = (int(xy[i, 0]), int(xy[i, 1]))
        if bound[i]:
            cv2.circle(out, p, 3, (0, 255, 0), 1)
        else:
            cv2.circle(out, p, 1, (180, 120, 0), 1)
    bar = np.zeros((22, out.shape[1], 3), np.uint8)
    text = f"{state_name}  KFs: {n_kfs}  MPs: {n_pts}  Matches: {n_matches}"
    cv2.putText(bar, text, (6, 15), cv2.FONT_HERSHEY_PLAIN, 1.0,
                (255, 255, 255), 1)
    return np.concatenate([out, bar], axis=0)
