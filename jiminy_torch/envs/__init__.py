"""Preconfigured environments (port of `jiminy_tpu.envs`, the ANYmal entries).

`make(env_id, device=None, dtype=None)` builds an env on the card unless
`device` says otherwise; with no device and no card it raises.
"""

from jiminy_torch.envs.anymal import ANYmalEnv, ANYmalPDControlEnv
from jiminy_torch.envs.locomotion import WalkerEnv

_REGISTRY = {
    "anymal": ANYmalEnv,
    "anymal-pid": ANYmalPDControlEnv,
}


def make(name: str, device=None, dtype=None, **kwargs):
    try:
        ctor = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown env '{name}'; available: {sorted(_REGISTRY)}") from None
    return ctor(device=device, dtype=dtype, **kwargs)


__all__ = ["ANYmalEnv", "ANYmalPDControlEnv", "WalkerEnv", "make"]
