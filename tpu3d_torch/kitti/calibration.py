"""KITTI camera/lidar calibration and the full projection suite.

The port's copy of ``tpu3d/kitti/calibration.py``, held equal to it by the port's
tests.

Single canonical implementation (the reference keeps two copies:
utils/kitti_util.py:13-250 and pointrcnn/lib/utils/calibration.py).

Coordinate frames:
- velodyne: x forward, y left, z up
- ref / rect camera: x right, y down, z forward
- image2: u right, v down

Chain:  x_rect = R0 @ (Tr_velo_to_cam @ x_velo);  y_image2 = P2 @ x_rect.
"""

from __future__ import annotations

import numpy as np


def inverse_rigid_trans(tr: np.ndarray) -> np.ndarray:
    """Invert a 3x4 rigid transform [R|t] -> [R'|-R't] (reference: kitti_util.py:287-294)."""
    inv = np.zeros_like(tr)
    inv[0:3, 0:3] = tr[0:3, 0:3].T
    inv[0:3, 3] = -tr[0:3, 0:3].T @ tr[0:3, 3]
    return inv


def _cart2hom(pts: np.ndarray) -> np.ndarray:
    return np.hstack((pts, np.ones((pts.shape[0], 1), dtype=pts.dtype)))


def read_calib_file(filepath: str) -> dict[str, np.ndarray]:
    """Parse 'key: v0 v1 ...' lines into float arrays (reference: kitti_util.py:80-97)."""
    data: dict[str, np.ndarray] = {}
    with open(filepath) as f:
        for line in f:
            line = line.rstrip()
            if len(line) == 0:
                continue
            key, value = line.split(":", 1)
            try:
                data[key] = np.array([float(x) for x in value.split()])
            except ValueError:
                pass
    return data


class Calibration:
    """Projection utilities between velodyne / rect-camera / image coordinates."""

    def __init__(self, calib: str | dict):
        if isinstance(calib, str):
            calib = read_calib_file(calib)
        self.calibs = calib
        self.P = np.reshape(calib["P2"], (3, 4)).astype(np.float64)
        self.P3 = (
            np.reshape(calib["P3"], (3, 4)).astype(np.float64) if "P3" in calib else None
        )
        self.V2C = np.reshape(calib["Tr_velo_to_cam"], (3, 4)).astype(np.float64)
        self.C2V = inverse_rigid_trans(self.V2C)
        self.R0 = np.reshape(calib["R0_rect"], (3, 3)).astype(np.float64)

        # Intrinsics (reference: kitti_util.py:62-68).
        self.c_u = self.P[0, 2]
        self.c_v = self.P[1, 2]
        self.f_u = self.P[0, 0]
        self.f_v = self.P[1, 1]
        self.b_x = self.P[0, 3] / (-self.f_u)
        self.b_y = self.P[1, 3] / (-self.f_v)

    # aliases matching pointrcnn/lib/utils/calibration.py naming
    @property
    def P2(self) -> np.ndarray:
        return self.P

    def write_calib_file(self, filepath: str | None = None) -> str | None:
        """Serialize in KITTI calib format, %.12E floats (reference: kitti_util.py:70-78)."""
        s = ""
        for key, value in self.calibs.items():
            s += f"{key}: {' '.join('%.12E' % x for x in np.asarray(value).ravel().tolist())}\n"
        if filepath is None:
            return s
        with open(filepath, "w") as f:
            f.write(s)
        return None

    # ---- 3d <-> 3d ----
    def project_velo_to_ref(self, pts_velo: np.ndarray) -> np.ndarray:
        return _cart2hom(pts_velo) @ self.V2C.T

    def project_ref_to_velo(self, pts_ref: np.ndarray) -> np.ndarray:
        return _cart2hom(pts_ref) @ self.C2V.T

    def project_ref_to_rect(self, pts_ref: np.ndarray) -> np.ndarray:
        return pts_ref @ self.R0.T

    def project_rect_to_ref(self, pts_rect: np.ndarray) -> np.ndarray:
        return pts_rect @ np.linalg.inv(self.R0).T

    def project_velo_to_rect(self, pts_velo: np.ndarray) -> np.ndarray:
        return self.project_ref_to_rect(self.project_velo_to_ref(pts_velo))

    def project_rect_to_velo(self, pts_rect: np.ndarray) -> np.ndarray:
        return self.project_ref_to_velo(self.project_rect_to_ref(pts_rect))

    # lidar_to_rect / rect_to_lidar aliases (pointrcnn/lib/utils/calibration.py)
    lidar_to_rect = project_velo_to_rect
    rect_to_lidar = project_rect_to_velo

    # ---- 3d -> 2d ----
    def _project_rect_with_P(self, pts_rect: np.ndarray, P: np.ndarray) -> np.ndarray:
        pts = _cart2hom(pts_rect) @ P.T
        uv = pts[:, 0:2] / pts[:, 2:3]
        return np.concatenate([uv, pts[:, 2:3]], axis=1)

    def project_rect_to_image(self, pts_rect: np.ndarray) -> np.ndarray:
        """(N,3) rect -> (N,2) image2 pixel coords."""
        return self._project_rect_with_P(pts_rect, self.P)[:, 0:2]

    def project_rect_to_image3(self, pts_rect: np.ndarray) -> np.ndarray:
        """(N,3) rect -> (N,3) [u, v, homogeneous depth]."""
        return self._project_rect_with_P(pts_rect, self.P)

    def project_velo_to_image(self, pts_velo: np.ndarray) -> np.ndarray:
        return self.project_rect_to_image(self.project_velo_to_rect(pts_velo))

    def project_rect_to_right_image(self, pts_rect: np.ndarray) -> np.ndarray:
        return self._project_rect_with_P(pts_rect, self.P3)[:, 0:2]

    def rect_to_img(self, pts_rect: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(N,3) rect -> ((N,2) uv, (N,) rect depth). Exact parity with
        pointrcnn/lib/utils/calibration.py:61-71, which (unlike the devkit-style
        ``project_rect_to_image``) divides uv by the RAW rect z, not the
        homogeneous coordinate z + P2[2,3] — a ~0.005/z relative uv shift that
        can flip image-bounds validity at the margin; depth is the homogeneous
        coordinate minus the P2[2,3] correction (i.e. z_rect again)."""
        pts = _cart2hom(pts_rect) @ self.P.T
        z = pts_rect[:, 2:3].copy()
        z[z == 0] = 1e-9
        uv = pts[:, 0:2] / z
        depth = pts[:, 2] - self.P.T[3, 2]
        return uv, depth

    # ---- 2d -> 3d ----
    def project_image_to_rect(self, uv_depth: np.ndarray) -> np.ndarray:
        """(N,3) [u, v, depth] -> (N,3) rect (reference: kitti_util.py:234-246)."""
        x = ((uv_depth[:, 0] - self.c_u) * uv_depth[:, 2]) / self.f_u + self.b_x
        y = ((uv_depth[:, 1] - self.c_v) * uv_depth[:, 2]) / self.f_v + self.b_y
        return np.stack([x, y, uv_depth[:, 2]], axis=1)

    img_to_rect_uvd = project_image_to_rect

    def img_to_rect(self, u: np.ndarray, v: np.ndarray, depth: np.ndarray) -> np.ndarray:
        return self.project_image_to_rect(np.stack([u, v, depth], axis=1))

    def project_image_to_velo(self, uv_depth: np.ndarray) -> np.ndarray:
        return self.project_rect_to_velo(self.project_image_to_rect(uv_depth))

    def corners3d_to_img_boxes(
        self, corners3d: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """(N,8,3) rect corners -> ((N,4) 2D boxes, (N,8,2) projected corners).

        Mirrors pointrcnn/lib/utils/calibration.py:105-123.
        """
        n = corners3d.shape[0]
        hom = np.concatenate(
            [corners3d, np.ones((n, 8, 1), dtype=corners3d.dtype)], axis=2
        )
        img_pts = hom @ self.P.T  # (N, 8, 3)
        x = img_pts[:, :, 0] / img_pts[:, :, 2]
        y = img_pts[:, :, 1] / img_pts[:, :, 2]
        x1, y1 = np.min(x, axis=1), np.min(y, axis=1)
        x2, y2 = np.max(x, axis=1), np.max(y, axis=1)
        boxes = np.stack((x1, y1, x2, y2), axis=1)
        boxes_corner = np.stack((x, y), axis=2)
        return boxes, boxes_corner

    def camera_dis_to_rect(
        self, u: np.ndarray, v: np.ndarray, d: np.ndarray
    ) -> np.ndarray:
        """Euclidean camera distance + pixel -> rect 3D point
        (reference: pointrcnn/lib/utils/calibration.py:125-139)."""
        assert self.f_u == self.f_v, f"{self.f_u} != {self.f_v}"
        fd = np.sqrt((u - self.c_u) ** 2 + (v - self.c_v) ** 2 + self.f_u ** 2)
        x = ((u - self.c_u) * d) / fd + self.b_x
        y = ((v - self.c_v) * d) / fd + self.b_y
        z = np.sqrt(d ** 2 - x ** 2 - y ** 2)
        return np.stack([x, y, z], axis=1)


def load_velo_scan(velo_filename: str) -> np.ndarray:
    """(N, 4) [x, y, z, intensity] float32 (reference: kitti_util.py:299-302)."""
    return np.fromfile(velo_filename, dtype=np.float32).reshape(-1, 4)


def save_velo_scan(velo_filename: str, scan: np.ndarray) -> None:
    scan.astype(np.float32).tofile(velo_filename)


def get_road_plane(plane_file: str) -> np.ndarray:
    """Load a KITTI `planes/xxxxxx.txt` ground plane; normal forced to point up
    (negative y in rect coords), norm 1 (reference: lib/datasets/kitti_dataset.py:72-85)."""
    with open(plane_file) as f:
        lines = f.readlines()
    plane = np.asarray([float(i) for i in lines[3].split()])
    if plane[1] > 0:
        plane = -plane
    return plane / np.linalg.norm(plane[0:3])
