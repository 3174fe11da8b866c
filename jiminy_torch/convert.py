"""Carry a simulator's "weights" across: the model arrays (every joint type:
free-flyer, revolute, continuous, prismatic, spherical), the motor bank, a
motorized robot assembled from both (with its flexibility joints, backlash
joints and theoretical model), the PD block constants, a trained
policy's parameters and a simulation state (with its solver carry: the
warm-start multipliers, active sets, loop lengths and rolling heights),
given as plain numpy dictionaries.

A caller dumps the fields of a `jiminy_tpu` RobotModel / MotorBank /
PDController to numpy (this package imports nothing of jiminy_tpu) and
builds the port's objects from them, so both packages compute with
identical constants.
"""

from __future__ import annotations

import numpy as np
import torch

from jiminy_torch.engine.hardware import MOTOR_ARRAY_FIELDS, MotorBank
from jiminy_torch.engine.robot import FlexibilityConfig, Robot
from jiminy_torch.engine.state import SimState, StepperState
from jiminy_torch.models.model import ARRAY_FIELDS, META_FIELDS, RobotModel
from jiminy_torch.ops.cdyn import PDComponents

MOTOR_META_FIELDS = ("names", "joint_indices", "v_indices", "q_indices")


def _meta(value):
    if isinstance(value, (list, tuple, np.ndarray)):
        return tuple(value.tolist() if isinstance(value, np.ndarray) else value)
    return value


def model_from_arrays(arrays: dict, device=None, dtype=None) -> RobotModel:
    """RobotModel from `{field: value}` with every field of `ARRAY_FIELDS`
    and `META_FIELDS`. With `device`, the arrays are also placed there in
    `dtype` (float32 by default)."""
    missing = [f for f in META_FIELDS + ARRAY_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"model arrays lack {missing}")
    kw = {f: _meta(arrays[f]) for f in META_FIELDS}
    for f in ("nq", "nv", "njoints"):
        kw[f] = int(kw[f])
    kw["name"] = str(kw["name"])
    kw.update({f: np.array(arrays[f], dtype=np.float64) for f in ARRAY_FIELDS})
    model = RobotModel(**kw)
    if device is not None:
        for f in ARRAY_FIELDS:
            model.tensor(f, device, dtype or torch.float32)
    return model


def motor_bank_from_arrays(arrays: dict) -> MotorBank:
    """MotorBank from `{field: value}` (`MOTOR_META_FIELDS` + the arrays)."""
    kw = {f: _meta(arrays[f]) for f in MOTOR_META_FIELDS}
    kw.update({f: np.array(arrays[f], dtype=np.float64) for f in MOTOR_ARRAY_FIELDS})
    return MotorBank(**kw)


def robot_from_arrays(model_arrays: dict, motor_arrays=None, name=None, contact_frames=(),
                      loop_pairs=(), contact_radii=None, rolling_specs=(), flexibility=None,
                      backlash_joint_indices=(), theoretical_arrays=None) -> Robot:
    """A sensor-free Robot from a motorized model's arrays and its motor
    bank's (a robot built with `Robot.build(model, motors=...)`, as the toys
    build theirs), with its contact frames (indices or names: a Cassie's or
    Digit's collision points are frames of the model) and their radii (0 by
    default; an ant's spheres), its loop closures ((frame_a, frame_b) pairs)
    and its rolling constraints ((frame, radius, axis or None), jiminy_tpu's
    `rolling_specs`). The model's arrays already hold the motors' armature,
    so nothing is folded again. An extended model (a robot with flexibility
    or backlash joints) comes with its `flexibility` ({"joint_indices",
    "stiffness", "damping", "inertia"}: jiminy_tpu's FlexibilityConfig as
    numbers), its `backlash_joint_indices` and the `theoretical_arrays` of
    the model before the extension (None: the model itself)."""
    model = model_from_arrays(model_arrays)
    bank = motor_bank_from_arrays(motor_arrays) if motor_arrays is not None else None
    contacts = tuple(model.frame_index(f) if isinstance(f, str) else int(f) for f in contact_frames)
    radii = (0.0,) * len(contacts) if contact_radii is None else tuple(map(float, contact_radii))
    flex = None
    if flexibility is not None:
        flex = FlexibilityConfig(
            joint_indices=tuple(int(j) for j in flexibility["joint_indices"]),
            **{f: np.array(flexibility[f], dtype=np.float64).reshape(-1, 3)
               for f in ("stiffness", "damping", "inertia")})
    theoretical = model_from_arrays(theoretical_arrays) if theoretical_arrays is not None else None
    return Robot(name=name or model.name, model=model, theoretical_model=theoretical, motors=bank,
                 flexibility=flex, backlash_joint_indices=tuple(map(int, backlash_joint_indices)),
                 contact_frame_indices=contacts, contact_radii=radii,
                 loop_pairs=tuple(tuple(p) for p in loop_pairs),
                 rolling_specs=tuple((f, float(r), None if a is None else tuple(map(float, a)))
                                     for f, r, a in rolling_specs))


SIM_FIELDS = ("t", "q", "v", "a", "command", "u_motor", "contact_forces", "tick")
SOLVER_FIELDS = ("contact_active", "bound_active", "lam", "distance_ref", "rolling_ref")
STEPPER_FIELDS = ("dt", "iterations", "iter_failed", "successive_iter_failed", "diverged")


def sim_state_from_arrays(arrays: dict, device=None, dtype=torch.float64) -> SimState:
    """A SimState from `{field: value}`: the fields of `SIM_FIELDS`, the
    stepper's `STEPPER_FIELDS` under "stepper" (a dict), optionally the
    solver carry's `SOLVER_FIELDS` (a jiminy_tpu state's `lam`,
    `distance_ref`, `rolling_ref` ...) and "measurements" ({group:
    array}). Floats take `dtype`, counters int32, active sets bool."""

    def conv(name, x):
        x = np.asarray(x)
        if name in ("tick", "iterations", "iter_failed", "successive_iter_failed"):
            return torch.as_tensor(x.astype(np.int32), device=device)
        if name in ("contact_active", "bound_active", "diverged"):
            return torch.as_tensor(x.astype(bool), device=device)
        return torch.as_tensor(x.astype(np.float64), device=device).to(dtype)

    stepper = StepperState(**{f: conv(f, arrays["stepper"][f]) for f in STEPPER_FIELDS})
    solver = {f: conv(f, arrays[f]) for f in SOLVER_FIELDS if arrays.get(f) is not None}
    meas = {k: conv(k, x) for k, x in arrays.get("measurements", {}).items()}
    return SimState(stepper=stepper, measurements=meas,
                    **{f: conv(f, arrays[f]) for f in SIM_FIELDS}, **solver)


def pd_components_from_arrays(arrays: dict) -> PDComponents:
    """The PD block's in-kernel form from its constants: `kp`, `kd` (nm,),
    `state_min`, `state_max` (3, nm), `effort_limit` (nm,), `dt`, and the
    encoder read-out `reduction`, `q_indices`, `v_indices`, `joint_side`."""
    nm = len(np.atleast_1d(arrays["effort_limit"]))

    def floats(x):
        return tuple(float(v) for v in np.broadcast_to(np.asarray(x, np.float64), (nm,)))

    return PDComponents(
        dt=float(arrays["dt"]),
        kp=floats(arrays["kp"]),
        kd=floats(arrays["kd"]),
        smin=tuple(floats(row) for row in np.asarray(arrays["state_min"])),
        smax=tuple(floats(row) for row in np.asarray(arrays["state_max"])),
        eff=floats(arrays["effort_limit"]),
        red=floats(arrays["reduction"]),
        q_indices=tuple(int(i) for i in arrays["q_indices"]),
        v_indices=tuple(int(i) for i in arrays["v_indices"]),
        joint_side=tuple(bool(b) for b in arrays["joint_side"]),
    )


def actor_critic_from_flax(params: dict) -> dict:
    """The `rl.networks.ActorCritic` state dict of a jiminy_tpu
    `ActorCritic.init(...)` pytree given as numpy arrays (with or without
    its top `"params"` level). Flax kernels are (in, out) and are
    transposed; every parameter keeps its dtype."""
    params = params.get("params", params)
    out = {}
    for torso in ("actor", "critic"):
        layers = params[torso]
        n_hidden = sum(1 for k in layers if k.startswith("dense_"))
        names = [(f"dense_{i}", f"hidden.{i}") for i in range(n_hidden)] + [("out", "out")]
        for flax_name, name in names:
            kernel, bias = layers[flax_name]["kernel"], layers[flax_name]["bias"]
            out[f"{torso}.{name}.weight"] = torch.from_numpy(np.array(kernel).T.copy())
            out[f"{torso}.{name}.bias"] = torch.from_numpy(np.array(bias))
    out["log_std"] = torch.from_numpy(np.array(params["log_std"]))
    return out


def fourier_process_from_jax(a, b, freqs, period: float):
    """`utils.terrain.PeriodicFourierProcess` from a jiminy_tpu process's
    arrays (`proc.a`, `proc.b`, `proc.freqs`, `proc.period`): its threefry
    draws, carried across as numbers."""
    from jiminy_torch.utils.terrain import PeriodicFourierProcess

    return PeriodicFourierProcess.from_coefficients(a, b, freqs, period)
