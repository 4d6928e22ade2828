"""tpu3d_torch.models — PointRCNN's RPN eval path in PyTorch."""

from .point_rcnn import PointRCNN
from .proposal import proposal_layer
from .rpn import RPN

__all__ = ["PointRCNN", "RPN", "proposal_layer"]
