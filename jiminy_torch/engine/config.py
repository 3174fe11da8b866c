"""Engine options (port of `jiminy_tpu.engine.config`): the fields the
spring-damper fixed-step path reads, under the JAX package's names. The
engine raises `NotImplementedError` for the values whose code paths are not
ported yet (constraint contacts and bounds, DOPRI, terrain).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional, Tuple


class ContactModel(enum.Enum):
    SPRING_DAMPER = "spring_damper"
    CONSTRAINT = "constraint"


class IntegratorType(enum.Enum):
    EULER_EXPLICIT = "euler_explicit"
    RUNGE_KUTTA_4 = "runge_kutta_4"
    RUNGE_KUTTA_DOPRI = "runge_kutta_dopri"


@dataclasses.dataclass(frozen=True)
class ContactOptions:
    model: ContactModel = ContactModel.SPRING_DAMPER
    stiffness: float = 1.0e6
    damping: float = 2.0e3
    friction: float = 1.0
    transition_eps: float = 1.0e-3  # [m] blending depth
    transition_velocity: float = 1.0e-2  # [m/s] tangential regularization speed


@dataclasses.dataclass(frozen=True)
class WorldOptions:
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    ground_profile: Optional[Callable[..., Any]] = None  # None = flat ground z=0


@dataclasses.dataclass(frozen=True)
class StepperOptions:
    integrator: IntegratorType = IntegratorType.RUNGE_KUTTA_4
    dt_max: float = 0.02  # fixed-step substep: ceil(period / dt_max) per period


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    contacts: ContactOptions = dataclasses.field(default_factory=ContactOptions)
    world: WorldOptions = dataclasses.field(default_factory=WorldOptions)
    stepper: StepperOptions = dataclasses.field(default_factory=StepperOptions)
    controller_update_period: float = 1.0e-3
    sensor_update_period: float = 1.0e-3
    # "penalty" = stable spring-damper bounds with inertia-scaled gains,
    # "none" = unconstrained, "constraint" = PGS (not ported yet).
    joint_bounds_mode: str = "constraint"
    joint_bounds_freq: float = 20.0  # [Hz] penalty natural frequency
    # The port always runs the component-dynamics core; False asks for the
    # generic ops path, which is not ported yet.
    use_fast_dynamics: object = True

    def replace(self, **kw) -> "EngineOptions":
        return dataclasses.replace(self, **kw)
