"""Ground contact on the generic path (port of `jiminy_tpu.engine.contact`,
the spring-damper ground forces): flat ground, the reference's
Kelvin-Voigt normal force with regularized friction, and the forces of
every contact frame as per-joint wrenches.

The component core (`ops/cdyn.py::ComponentDynamics._contact_fext`)
evaluates the same formula per scalar component; this array form feeds the
generic dynamics (`Engine.dynamics_full`) and its sensor outputs. The
body-to-body narrowphase (collision pairs) is ROADMAP.md queue 1 item 10.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from jiminy_torch.engine.config import ContactOptions
from jiminy_torch.models.model import RobotModel
from jiminy_torch.ops import lie
from jiminy_torch.ops.kinematics import KinData, frame_placement, frame_velocity_local


def flat_ground(xy: torch.Tensor):
    """The default ground profile: height 0, normal +z."""
    h = xy.new_zeros(xy.shape[:-1])
    n = xy.new_zeros(xy.shape[:-1] + (3,))
    n[..., 2] = 1.0
    return h, n


def spring_damper_force_world(opts: ContactOptions, normal: torch.Tensor, depth: torch.Tensor,
                              v_contact: torch.Tensor) -> torch.Tensor:
    """The reference's contact force in world axes: a Kelvin-Voigt normal
    force, viscous friction saturated at the transition velocity, blended in
    by tanh of the depth. `depth` < 0 penetrates."""
    v_depth = torch.sum(v_contact * normal, dim=-1)
    f_normal = -torch.clamp(opts.stiffness * depth + opts.damping * v_depth, max=0.0)
    f = f_normal[..., None] * normal
    v_tang = v_contact - v_depth[..., None] * normal
    # Guarded norm, as the component core's `_contact_fext`
    v_norm = torch.sqrt(torch.clamp(torch.sum(v_tang * v_tang, dim=-1), min=1e-24))
    v_ratio = torch.clamp(v_norm / opts.transition_velocity, max=1.0)
    f = f - (opts.friction * v_ratio * f_normal / v_norm)[..., None] * v_tang
    if opts.transition_eps > 1e-12:
        blend = torch.tanh(2.0 * (-depth) / opts.transition_eps)
        f = f * blend[..., None]
    return torch.where((depth < 0.0)[..., None], f, torch.zeros_like(f))


def compute_contact_forces(model: RobotModel, opts: ContactOptions, ground_fn: Optional[Callable],
                           kin: KinData, contact_frame_indices: tuple, contact_radii: tuple = ()):
    """Spring-damper ground forces at every contact frame.

    Returns (fext, f_world, w_local, depth): (..., nj, 6) per-joint LOCAL
    wrenches (ang, lin); (..., nc, 3) the force at each contact point in
    world axes; (..., nc, 6) the wrench in the LOCAL contact frame; (..., nc)
    the signed gap. A radius > 0 makes the contact a sphere whose lowest
    point touches the ground."""
    if ground_fn is None:
        ground_fn = flat_ground
    batch = kin.vel.shape[:-2]
    like = kin.vel
    nc = len(contact_frame_indices)
    fext = like.new_zeros(batch + (model.njoints, 6))
    if nc == 0:
        return (fext, like.new_zeros(batch + (0, 3)), like.new_zeros(batch + (0, 6)),
                like.new_zeros(batch + (0,)))
    if not contact_radii:
        contact_radii = (0.0,) * nc
    f_world_list, w_local_list, depth_list = [], [], []
    for fidx, radius in zip(contact_frame_indices, contact_radii):
        rot, pos = frame_placement(model, kin, fidx)
        v_local = frame_velocity_local(model, kin, fidx)
        v_world = lie.mv(rot, v_local[..., 3:])
        h, n = ground_fn(pos[..., :2])
        n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
        # First-order gap projection
        depth = (pos[..., 2] - h) * n[..., 2]
        if radius > 0.0:
            depth = depth - radius
            d_off = -radius * n
            w_world = lie.mv(rot, v_local[..., :3])
            v_world = v_world + lie.cross(w_world, d_off)
        f_w = spring_damper_force_world(opts, n, depth, v_world)

        # The wrench in the LOCAL contact frame (force sensors)
        rot_t = rot.transpose(-1, -2)
        f_local = lie.mv(rot_t, f_w)
        n_local = lie.mv(rot_t, lie.cross(d_off, f_w)) if radius > 0.0 else torch.zeros_like(f_local)
        w_local = torch.cat([n_local, f_local], dim=-1)

        # Moved to the parent joint's origin, LOCAL joint frame
        parent = model.frame_parents[fidx]
        rot_j = kin.rot[..., parent, :, :]
        pos_j = kin.pos[..., parent, :]
        lever = pos - pos_j
        if radius > 0.0:
            lever = lever + d_off
        tau_w = lie.cross(lever, f_w)
        rjt = rot_j.transpose(-1, -2)
        fext[..., parent, 0:3] += lie.mv(rjt, tau_w)
        fext[..., parent, 3:6] += lie.mv(rjt, f_w)

        f_world_list.append(f_w)
        w_local_list.append(w_local)
        depth_list.append(depth)
    return (fext, torch.stack(f_world_list, dim=-2), torch.stack(w_local_list, dim=-2),
            torch.stack(depth_list, dim=-1))
