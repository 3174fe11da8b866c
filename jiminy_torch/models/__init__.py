"""Robot model: joint metadata, the RobotModel container and the URDF loader."""

from jiminy_torch.models.joints import JointType
from jiminy_torch.models.model import RobotModel, build_model

__all__ = ["JointType", "RobotModel", "build_model"]
