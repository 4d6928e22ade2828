"""KITTI 3D object labels.

The port's copy of ``tpu3d/kitti/object3d.py``, held equal to it by the port's
tests.

One canonical implementation of the KITTI label data model (the reference keeps three
divergent copies: utils/object_3d.py, pointrcnn/lib/utils/object3d.py and
evaluate/kitti_common.py).

A KITTI label line is
  type truncated occluded alpha  x1 y1 x2 y2  h w l  x y z  ry  [score]
with the 3D location (x, y, z) in *rect camera* coordinates (x right, y down, z forward),
(h, w, l) the box height/width/length and ry the rotation around the camera y axis.
"""

from __future__ import annotations

import numpy as np

# Reference parity: utils/object_3d.py:5-9.
CLS_TYPE_TO_ID = {"Car": 1, "Pedestrian": 2, "Cyclist": 3, "Van": 4}


def cls_type_to_id(cls_type: str) -> int:
    return CLS_TYPE_TO_ID.get(cls_type, -1)


def get_level(height: float, truncation: float, occlusion: float) -> int:
    """KITTI difficulty from 2D box height (+1 px), truncation and occlusion.

    Returns 1=Easy, 2=Moderate, 3=Hard, 4=Unknown.
    Reference parity: utils/object_3d.py:42-56 (thresholds 40/25/25 px,
    trunc 0.15/0.3/0.5, occ 0/1/2; note the reference's +1 on pixel height).
    """
    if height >= 40 and truncation <= 0.15 and occlusion <= 0:
        return 1
    if height >= 25 and truncation <= 0.3 and occlusion <= 1:
        return 2
    if height >= 25 and truncation <= 0.5 and occlusion <= 2:
        return 3
    return 4


LEVEL_STR = {1: "Easy", 2: "Moderate", 3: "Hard", 4: "UnKnown"}


class Object3d:
    """A single KITTI label. Field names follow the reference (`t` position, `ry` yaw)."""

    __slots__ = (
        "src", "cls_type", "cls_id", "truncation", "occlusion", "alpha", "box2d",
        "h", "w", "l", "t", "dis_to_cam", "ry", "score", "track_id", "level",
        "level_str",
    )

    def __init__(self, line: str):
        label = line.strip().split(" ")
        self.src = line
        self.cls_type = label[0]
        self.cls_id = cls_type_to_id(self.cls_type)
        self.truncation = float(label[1])
        # 0: fully visible, 1: partly occluded, 2: largely occluded, 3: unknown
        self.occlusion = float(label[2])
        self.alpha = float(label[3])
        self.box2d = np.array(
            (float(label[4]), float(label[5]), float(label[6]), float(label[7])),
            dtype=np.float32,
        )
        self.h = float(label[8])
        self.w = float(label[9])
        self.l = float(label[10])
        self.t = np.array(
            (float(label[11]), float(label[12]), float(label[13])), dtype=np.float32
        )
        self.dis_to_cam = float(np.linalg.norm(self.t))
        self.ry = float(label[14])
        self.score = None
        self.track_id = None
        if len(label) == 16:
            # Detection results carry a score; tracking labels carry a track id
            # (reference: utils/object_3d.py:31-37).
            try:
                self.score = float(label[15])
            except ValueError:
                self.track_id = label[15]
        self.level = self.get_obj_level()
        self.level_str = LEVEL_STR[self.level]

    # `pos` alias for compatibility with the reference's lib/utils/object3d.py naming.
    @property
    def pos(self) -> np.ndarray:
        return self.t

    def get_obj_level(self) -> int:
        height = float(self.box2d[3]) - float(self.box2d[1]) + 1
        return get_level(height, self.truncation, self.occlusion)

    def generate_corners3d(self) -> np.ndarray:
        """(8, 3) corners in rect camera coords.

        Corner order (reference parity: utils/object_3d.py:58-76): the first four
        corners are the bottom face (y = t_y), the last four the top face (y = t_y - h).
        """
        from .boxes import corners_from_boxes3d

        box = np.array(
            [[self.t[0], self.t[1], self.t[2], self.h, self.w, self.l, self.ry]],
            dtype=np.float32,
        )
        return corners_from_boxes3d(box)[0]

    def to_box3d(self) -> np.ndarray:
        """(7,) [x, y, z, h, w, l, ry]."""
        return np.array(
            [self.t[0], self.t[1], self.t[2], self.h, self.w, self.l, self.ry],
            dtype=np.float32,
        )

    def to_kitti_format(self) -> str:
        """Bit-compatible KITTI label line (reference: utils/object_3d.py:117-127)."""
        base = (
            "%s %.2f %d %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f"
            % (
                self.cls_type, self.truncation, int(self.occlusion), self.alpha,
                self.box2d[0], self.box2d[1], self.box2d[2], self.box2d[3],
                self.h, self.w, self.l, self.t[0], self.t[1], self.t[2], self.ry,
            )
        )
        if self.score is not None:
            return base + " %.2f" % self.score
        return base

    def __repr__(self) -> str:
        return (
            f"Object3d({self.cls_type}, t={self.t.tolist()}, hwl=({self.h}, {self.w}, "
            f"{self.l}), ry={self.ry})"
        )


def read_label(label_filename: str) -> list[Object3d]:
    """Parse a KITTI label file into a list of Object3d (reference: object_3d.py:141-144)."""
    with open(label_filename) as f:
        lines = [line.rstrip() for line in f if line.strip()]
    return [Object3d(line) for line in lines]


def write_label(label_filename: str, objects: list[Object3d]) -> None:
    with open(label_filename, "w") as f:
        for obj in objects:
            f.write(obj.to_kitti_format() + "\n")


def objs_to_boxes3d(obj_list: list[Object3d]) -> np.ndarray:
    """(N, 7) [x, y, z, h, w, l, ry] (reference: lib/utils/kitti_utils.py:180-185)."""
    boxes3d = np.zeros((len(obj_list), 7), dtype=np.float32)
    for k, obj in enumerate(obj_list):
        boxes3d[k, 0:3] = obj.t
        boxes3d[k, 3], boxes3d[k, 4], boxes3d[k, 5], boxes3d[k, 6] = (
            obj.h, obj.w, obj.l, obj.ry,
        )
    return boxes3d


def objs_to_scores(obj_list: list[Object3d]) -> np.ndarray:
    return np.array([obj.score for obj in obj_list], dtype=np.float32)
