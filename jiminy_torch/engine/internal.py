"""Internal dynamics: the flexibility joints' spring-damper torques (port of
`jiminy_tpu.engine.internal.flexibility_torque`; reference
`Engine::computeInternalDynamics`, `engine.cc:3340-3392`).

A flexibility joint is a spherical joint whose deflection, the rotation
vector log3(q), is pulled back by a spring through the inverse Jacobian of
log3 and damped by a viscous term on its angular velocity. Plain torch on
every device: the engine adds these torques to the motors' before the
dynamics, on the core (`cdyn_accel` on the card) and on the generic path.
"""

from __future__ import annotations

import torch

from jiminy_torch.ops import lie


def flexibility_torque(robot, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The spring-damper torque of every flexibility joint, scattered into a
    (..., nv) vector (zeros without flexibility)."""
    u = q.new_zeros(torch.broadcast_shapes(q.shape[:-1], v.shape[:-1]) + (robot.nv,))
    flex = robot.flexibility
    if flex is None or not flex.joint_indices:
        return u
    model = robot.model
    stiffness = flex.tensor("stiffness", q.device, q.dtype)
    damping = flex.tensor("damping", q.device, q.dtype)
    for k, j in enumerate(flex.joint_indices):
        qi, vi = model.idx_q[j], model.idx_v[j]
        angle_axis = lie.log3_quat(q[..., qi : qi + 4])
        tau = -lie.mv(lie.jlog3(angle_axis), stiffness[k] * angle_axis)
        tau = tau - damping[k] * v[..., vi : vi + 3]
        u[..., vi : vi + 3] = u[..., vi : vi + 3] + tau
    return u
