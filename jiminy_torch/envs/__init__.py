"""Preconfigured environments (port of `jiminy_tpu.envs`: the toys, the
ant, the ANYmal, Cassie, Digit and the Atlas entries).

`make(env_id, device=None, dtype=None)` builds an env on the card unless
`device` says otherwise; with no device and no card it raises.
"""

from jiminy_torch.envs.ant import AntEnv
from jiminy_torch.envs.anymal import ANYmalEnv, ANYmalPDControlEnv
from jiminy_torch.envs.bipeds import (
    AtlasEnv,
    AtlasPDControlEnv,
    AtlasReducedEnv,
    AtlasReducedPDControlEnv,
    CassieEnv,
    CassiePDControlEnv,
    DigitEnv,
    DigitPDControlEnv,
)
from jiminy_torch.envs.locomotion import WalkerEnv
from jiminy_torch.envs.toys import AcrobotEnv, CartPoleEnv, PendulumEnv

_REGISTRY = {
    "cartpole": CartPoleEnv,
    "acrobot": AcrobotEnv,
    "pendulum": PendulumEnv,
    "ant": AntEnv,
    "anymal": ANYmalEnv,
    "anymal-pid": ANYmalPDControlEnv,
    "atlas": AtlasEnv,
    "atlas-reduced": AtlasReducedEnv,
    "atlas-pid": AtlasPDControlEnv,
    "atlas-reduced-pid": AtlasReducedPDControlEnv,
    "cassie": CassieEnv,
    "cassie-pid": CassiePDControlEnv,
    "digit": DigitEnv,
    "digit-pid": DigitPDControlEnv,
}

# jiminy_tpu's other ids and the ROADMAP.md queue 1 item that ports them
_NOT_PORTED: dict = {}


def make(name: str, device=None, dtype=None, **kwargs):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"env '{name}' is not ported yet (ROADMAP.md queue 1 item {_NOT_PORTED[name]})"
        )
    try:
        ctor = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown env '{name}'; available: {sorted(_REGISTRY)}") from None
    return ctor(device=device, dtype=dtype, **kwargs)


__all__ = [
    "AcrobotEnv",
    "CartPoleEnv",
    "PendulumEnv",
    "AntEnv",
    "ANYmalEnv",
    "ANYmalPDControlEnv",
    "AtlasEnv",
    "AtlasPDControlEnv",
    "AtlasReducedEnv",
    "AtlasReducedPDControlEnv",
    "CassieEnv",
    "CassiePDControlEnv",
    "DigitEnv",
    "DigitPDControlEnv",
    "WalkerEnv",
    "make",
]
