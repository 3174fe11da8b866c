"""Random processes and procedural terrain (port of `jiminy_tpu.utils.terrain`).

A ground profile is a callable `fn(xy) -> (height, unit normal)`, with
`fn.height_components(x, y) -> (h, (nx, ny, nz))` (normal not normalized)
built from elementwise ops only, exactly as in jiminy_tpu. jiminy_tpu takes
the normal from `jax.jvp` of the height function; here the derivatives are
explicit forward-mode arithmetic on `Dual`, a value with its partial
derivatives along x and y, one op for each op of jiminy_tpu's primal, under
JAX's differentiation rules: `floor` and the lattice hash have tangent 0,
`mod` tangent 1, and `minimum` / `maximum` (so `clip`) split a tie evenly
(0.5 each side, where `torch.clamp` would give 1).

The lattice hash is unsigned 32-bit arithmetic, computed on int64 tensors
masked to 32 bits after each step, each product split in 16-bit halves so
that none exceeds 2^53.

Packed form. Each generator and the sum and merge of grounds that have one
carry a postfix program (`fn.terrain_program`): leaves (the four generators
with their parameters) and `SUM` / `MERGE` nodes. `pack_ground(fn)` folds it
into an int buffer and a float buffer (parameters computed in float64 on the
host, rounded once to the run's dtype), which the CUDA kernels evaluate per
contact (`csrc/terrain.cuh`); `eval_packed` is the plain version of that
device function, step for step. A ground without a packed form (a user
callable, `discretize_heightmap`'s query, a sum or merge with such a term)
runs on the CPU on every path; on the card it is refused (`ground_route`).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

# --------------------------------------------------------------------------- #
# Forward-mode arithmetic: a value with its derivatives along x and y
# --------------------------------------------------------------------------- #


class Dual:
    """`(v, dx, dy)`: a value and its partial derivatives. Operands may be
    Duals, tensors or Python floats (constants: tangent 0)."""

    __slots__ = ("v", "dx", "dy")

    def __init__(self, v, dx, dy):
        self.v, self.dx, self.dy = v, dx, dy

    def __add__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v + o.v, self.dx + o.dx, self.dy + o.dy)
        return Dual(self.v + o, self.dx, self.dy)

    def __radd__(self, o):
        return Dual(o + self.v, self.dx, self.dy)

    def __sub__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v - o.v, self.dx - o.dx, self.dy - o.dy)
        return Dual(self.v - o, self.dx, self.dy)

    def __rsub__(self, o):
        return Dual(o - self.v, -self.dx, -self.dy)

    def __mul__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v * o.v, self.dx * o.v + self.v * o.dx,
                        self.dy * o.v + self.v * o.dy)
        return Dual(self.v * o, self.dx * o, self.dy * o)

    def __rmul__(self, o):
        return Dual(o * self.v, o * self.dx, o * self.dy)

    def __truediv__(self, o):
        if isinstance(o, Dual):
            raise TypeError("Dual / Dual is not used by the terrain generators")
        return Dual(self.v / o, self.dx / o, self.dy / o)

    def __neg__(self):
        return Dual(-self.v, -self.dx, -self.dy)


def _value(a):
    return a.v if isinstance(a, Dual) else a


def _floor(a):
    """Tangent 0: a plain tensor."""
    return torch.floor(_value(a))


def _cos(a):
    if isinstance(a, Dual):
        s = torch.sin(a.v)
        return Dual(torch.cos(a.v), -(a.dx * s), -(a.dy * s))
    return torch.cos(a)


def _sin(a):
    if isinstance(a, Dual):
        c = torch.cos(a.v)
        return Dual(torch.sin(a.v), a.dx * c, a.dy * c)
    return torch.sin(a)


def _mod(a, period: float):
    """`jnp.mod`: `fmod` with the sign fixed to the divisor's; tangent 1."""
    v = _value(a)
    r = torch.fmod(v, period)
    r = torch.where((r != 0) & ((r < 0) != (period < 0)), r + period, r)
    return Dual(r, a.dx, a.dy) if isinstance(a, Dual) else r


def _balanced(x, ans, y):
    """JAX's tie rule for `min` / `max`: the weight of operand x, 1 where it
    alone is the answer, 0.5 where both are."""
    return torch.where(x == ans, torch.where(y == ans, 0.5, 1.0), 0.0).to(ans.dtype)


def _extremum(a, b, pick_max: bool):
    av, bv = _value(a), _value(b)
    if isinstance(av, torch.Tensor) and isinstance(bv, torch.Tensor):
        v = torch.maximum(av, bv) if pick_max else torch.minimum(av, bv)
    elif isinstance(av, torch.Tensor):
        v = torch.clamp(av, min=bv) if pick_max else torch.clamp(av, max=bv)
    else:
        v = torch.clamp(bv, min=av) if pick_max else torch.clamp(bv, max=av)
    if not isinstance(a, Dual) and not isinstance(b, Dual):
        return v
    dx = dy = None
    for p, q in ((a, bv), (b, av)):
        if isinstance(p, Dual):
            w = _balanced(p.v, v, q)
            tx, ty = p.dx * w, p.dy * w
            dx = tx if dx is None else dx + tx
            dy = ty if dy is None else dy + ty
    return Dual(v, dx, dy)


def _minimum(a, b):
    return _extremum(a, b, False)


def _maximum(a, b):
    return _extremum(a, b, True)


def _clip(a, lo, hi):
    """`jnp.clip`: `minimum(maximum(a, lo), hi)`, ties split evenly."""
    return _minimum(_maximum(a, lo), hi)


def _zeros_like(a):
    return torch.zeros_like(_value(a))


def _float_dtype(x) -> torch.dtype:
    v = _value(x)
    return v.dtype if torch.is_floating_point(v) else torch.float32


# --------------------------------------------------------------------------- #
# Stationary scalar processes (reference `PeriodicGaussianProcess`,
# `PeriodicFourierProcess`)
# --------------------------------------------------------------------------- #


class PeriodicFourierProcess:
    """Periodic random process as a truncated random Fourier series:
    `f(t) = sum_k a_k cos(w_k t) + b_k sin(w_k t)`, w_k = 2 pi k / period."""

    def __init__(self, generator: Optional[torch.Generator], wavelength: float, period: float,
                 num_harmonics: int = 8):
        self.period = period
        n = num_harmonics
        freqs = 2.0 * np.pi * np.arange(1, n + 1) / period
        decay = torch.as_tensor(np.exp(-0.5 * (freqs * wavelength / (2 * np.pi)) ** 2))
        self.freqs = torch.as_tensor(freqs)
        a = torch.randn(n, generator=generator, dtype=torch.float64) * decay
        b = torch.randn(n, generator=generator, dtype=torch.float64) * decay
        norm = torch.sqrt(torch.sum(decay**2) + 1e-12)
        self.a, self.b = a / norm, b / norm

    @classmethod
    def from_coefficients(cls, a, b, freqs, period: float) -> "PeriodicFourierProcess":
        """A process with given coefficients and frequencies (jiminy_tpu's
        draws: `convert.fourier_process_from_jax`)."""
        proc = cls.__new__(cls)
        proc.period = period
        proc.a, proc.b, proc.freqs = (torch.tensor(np.asarray(x, np.float64))
                                      for x in (a, b, freqs))
        return proc

    def __call__(self, t):
        t = torch.as_tensor(t)
        dtype = t.dtype if torch.is_floating_point(t) else torch.get_default_dtype()
        a, b, w = (x.to(device=t.device, dtype=dtype) for x in (self.a, self.b, self.freqs))
        t = t.to(dtype)[..., None]
        return torch.sum(a * torch.cos(w * t) + b * torch.sin(w * t), dim=-1)


class PeriodicGaussianProcess(PeriodicFourierProcess):
    """Periodic Gaussian process with squared-exponential kernel, realized by
    spectral sampling (the same construction)."""


# --------------------------------------------------------------------------- #
# Perlin noise (hash-gradient lattice)
# --------------------------------------------------------------------------- #

_U32 = 0xFFFFFFFF


def _mul_u32(h, m: int):
    """(h * m) mod 2^32 for h in [0, 2^32) and a constant m < 2^32, from
    16-bit halves of h (no product past 2^48)."""
    lo, hi = h & 0xFFFF, h >> 16
    return (lo * m + (((hi * m) & 0xFFFF) << 16)) & _U32


def _u32(i):
    """An int32 lattice index (int64 tensor) as its uint32 bit pattern."""
    return i & _U32


def _hash2(ix, iy, seed: int):
    """Integer lattice hash -> uint32 (int64 tensor in [0, 2^32))."""
    h = _mul_u32(_u32(ix), 374761393) ^ _mul_u32(_u32(iy), 668265263) ^ (seed & _U32)
    h = _mul_u32(h ^ (h >> 13), 1274126177)
    return h ^ (h >> 16)


def _hash3(ix, iy, iz, seed: int):
    h = (_mul_u32(_u32(ix), 374761393) ^ _mul_u32(_u32(iy), 668265263)
         ^ _mul_u32(_u32(iz), 2246822519) ^ (seed & _U32))
    h = _mul_u32(h ^ (h >> 13), 1274126177)
    return h ^ (h >> 16)


def _u32_to_float(h, dtype):
    """uint32 -> float as two 16-bit halves recombined (one rounding of the
    integer value, jiminy_tpu's Mosaic-lowerable form)."""
    hi = (h >> 16).to(dtype)
    lo = (h & 0xFFFF).to(dtype)
    return hi * 65536.0 + lo


def _gradient2(ix, iy, seed: int, dtype):
    ang = _u32_to_float(_hash2(ix, iy, seed), dtype) * (2.0 * np.pi / 4294967296.0)
    return torch.cos(ang), torch.sin(ang)


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _lattice(x):
    """(floor, int64 index) of a coordinate: jiminy_tpu's int32 index."""
    x0 = _floor(x)
    return x0, x0.to(torch.int64)


def perlin2(x, y, seed: int = 0):
    """Single-octave 2D Perlin gradient noise, C2-smooth. `x`, `y`: tensors
    or Duals."""
    x, y = (a if isinstance(a, Dual) else torch.as_tensor(a) for a in (x, y))
    dtype = _float_dtype(x)
    x0, ix0 = _lattice(x)
    y0, iy0 = _lattice(y)
    fx = x - x0
    fy = y - y0

    def dot_grad(ix, iy, dx, dy):
        gx, gy = _gradient2(ix, iy, seed, dtype)
        return gx * dx + gy * dy

    n00 = dot_grad(ix0, iy0, fx, fy)
    n10 = dot_grad(ix0 + 1, iy0, fx - 1.0, fy)
    n01 = dot_grad(ix0, iy0 + 1, fx, fy - 1.0)
    n11 = dot_grad(ix0 + 1, iy0 + 1, fx - 1.0, fy - 1.0)
    u, v = _fade(fx), _fade(fy)
    nx0 = n00 + u * (n10 - n00)
    nx1 = n01 + u * (n11 - n01)
    return nx0 + v * (nx1 - nx0)


def octave_perlin2(x, y, octaves: int = 4, persistence: float = 0.5, seed: int = 0):
    total, amp, freq, norm = 0.0, 1.0, 1.0, 0.0
    for o in range(octaves):
        total = total + amp * perlin2(x * freq, y * freq, seed=seed + o)
        norm += amp
        amp *= persistence
        freq *= 2.0
    return total / norm


def perlin1(x, seed: int = 0):
    """Single-octave 1D Perlin gradient noise (the reference's 1D
    `PerlinProcess`)."""
    x = torch.as_tensor(x)
    dtype = _float_dtype(x)
    x0, ix0 = _lattice(x)
    fx = x - x0

    def grad(ix):
        h = _hash2(ix, torch.zeros_like(ix), seed)
        return _u32_to_float(h, dtype) * (2.0 / 4294967296.0) - 1.0

    n0 = grad(ix0) * fx
    n1 = grad(ix0 + 1) * (fx - 1.0)
    return n0 + _fade(fx) * (n1 - n0)


def octave_perlin1(x, octaves: int = 4, persistence: float = 0.5, seed: int = 0):
    total, amp, freq, norm = 0.0, 1.0, 1.0, 0.0
    for o in range(octaves):
        total = total + amp * perlin1(x * freq, seed=seed + o)
        norm += amp
        amp *= persistence
        freq *= 2.0
    return total / norm


def perlin3(x, y, z, seed: int = 0):
    """Single-octave 3D Perlin gradient noise."""
    x, y, z = (torch.as_tensor(a) for a in (x, y, z))
    dtype = _float_dtype(x)
    (x0, ix0), (y0, iy0), (z0, iz0) = _lattice(x), _lattice(y), _lattice(z)
    fx, fy, fz = x - x0, y - y0, z - z0

    def dot_grad(ix, iy, iz, dx, dy, dz):
        h1 = _u32_to_float(_hash3(ix, iy, iz, seed), dtype) * (2.0 * np.pi / 4294967296.0)
        h2 = _u32_to_float(_hash3(ix, iy, iz, seed + 0x9E37), dtype) * (2.0 / 4294967296.0) - 1.0
        st = torch.sqrt(torch.clamp(1.0 - h2 * h2, min=0.0))
        gx, gy, gz = st * torch.cos(h1), st * torch.sin(h1), h2
        return gx * dx + gy * dy + gz * dz

    n000 = dot_grad(ix0, iy0, iz0, fx, fy, fz)
    n100 = dot_grad(ix0 + 1, iy0, iz0, fx - 1.0, fy, fz)
    n010 = dot_grad(ix0, iy0 + 1, iz0, fx, fy - 1.0, fz)
    n110 = dot_grad(ix0 + 1, iy0 + 1, iz0, fx - 1.0, fy - 1.0, fz)
    n001 = dot_grad(ix0, iy0, iz0 + 1, fx, fy, fz - 1.0)
    n101 = dot_grad(ix0 + 1, iy0, iz0 + 1, fx - 1.0, fy, fz - 1.0)
    n011 = dot_grad(ix0, iy0 + 1, iz0 + 1, fx, fy - 1.0, fz - 1.0)
    n111 = dot_grad(ix0 + 1, iy0 + 1, iz0 + 1, fx - 1.0, fy - 1.0, fz - 1.0)
    u, v, w = _fade(fx), _fade(fy), _fade(fz)
    nx00 = n000 + u * (n100 - n000)
    nx10 = n010 + u * (n110 - n010)
    nx01 = n001 + u * (n101 - n001)
    nx11 = n011 + u * (n111 - n011)
    nxy0 = nx00 + v * (nx10 - nx00)
    nxy1 = nx01 + v * (nx11 - nx01)
    return nxy0 + w * (nxy1 - nxy0)


def octave_perlin3(x, y, z, octaves: int = 4, persistence: float = 0.5, seed: int = 0):
    total, amp, freq, norm = 0.0, 1.0, 1.0, 0.0
    for o in range(octaves):
        total = total + amp * perlin3(x * freq, y * freq, z * freq, seed=seed + o)
        norm += amp
        amp *= persistence
        freq *= 2.0
    return total / norm


# --------------------------------------------------------------------------- #
# The four ground generators' height functions. Each takes its parameters as
# arguments, so the generators' closures and `eval_packed` (parameters read
# from the packed float buffer) run the same ops.
# --------------------------------------------------------------------------- #


def _octave_norm(octaves: int, persistence: float = 0.5) -> float:
    norm, amp = 0.0, 1.0
    for _ in range(octaves):
        norm += amp
        amp *= persistence
    return norm


def _octaves2(x, y, octaves: int, seed: int, norm):
    """`octave_perlin2` at persistence 0.5 with its normalizer given: the
    amplitudes and frequencies are powers of two, exact in any dtype."""
    total, amp, freq = 0.0, 1.0, 1.0
    for o in range(octaves):
        total = total + amp * perlin2(x * freq, y * freq, seed=seed + o)
        amp *= 0.5
        freq *= 2.0
    return total / norm


def _stairs_height(x, y, c, s, period, step_width, step_number, step_height):
    u = c * x + s * y
    phase = _mod(u, period) / step_width
    up = _minimum(phase, step_number)
    down = _maximum(phase - step_number, 0.0)

    def stairs(p):  # floor + smoothstep over the riser (1 % of the step)
        k = _floor(p)
        frac = p - k
        eps = 0.01
        riser = _clip((frac - (1 - eps)) / eps, 0.0, 1.0)
        return k + riser * riser * (3.0 - 2.0 * riser)

    return step_height * (stairs(up) - stairs(down))


def _perlin_height(x, y, wavelength, height_max, norm, octaves: int, seed: int):
    return height_max * _octaves2(x / wavelength, y / wavelength, octaves, seed, norm)


def _periodic_perlin_height(x, y, two_pi, period, r, height_max, norm, octaves: int,
                            seed: int):
    tx = two_pi * x / period
    ty = two_pi * y / period
    return height_max * _octaves2(r * _cos(tx) + 31.7, r * _sin(ty) + 17.3, octaves, seed, norm)


def _unidirectional_height(x, y, c, s, wavelength, height_max, norm, octaves: int, seed: int):
    u = (c * x + s * y) / wavelength
    return height_max * _octaves2(u, _zeros_like(u) + 0.5, octaves, seed, norm)


# Opcodes of the postfix program (csrc/terrain.cuh)
T_SUM, T_MERGE, T_STAIRS, T_PERLIN, T_PERIODIC_PERLIN, T_UNIDIRECTIONAL = range(6)
TI_HEADER, TI_OP = 2, 4  # [n_ops, depth]; per op (opcode, float offset, octaves, seed)
TERRAIN_STACK = 4  # the kernels' stack of partial results
_LEAVES = {
    T_STAIRS: (_stairs_height, 6, False),
    T_PERLIN: (_perlin_height, 3, True),
    T_PERIODIC_PERLIN: (_periodic_perlin_height, 5, True),
    T_UNIDIRECTIONAL: (_unidirectional_height, 5, True),
}


def _leaf_height(op: int, params, octaves: int, seed: int) -> Callable:
    fn, n_params, noise = _LEAVES[op]
    assert len(params) == n_params
    if noise:
        return lambda x, y: fn(x, y, *params, octaves, seed)
    return lambda x, y: fn(x, y, *params)


def _components(height_xy: Callable) -> Callable:
    """`(x, y) -> (h, (-dh/dx, -dh/dy, 1))` by forward-mode arithmetic."""

    def components(x, y):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        h = height_xy(Dual(x, torch.ones_like(x), torch.zeros_like(x)),
                      Dual(y, torch.zeros_like(y), torch.ones_like(y)))
        return h.v, (-h.dx, -h.dy, torch.ones_like(h.v))

    return components


def _height_with_normal(height_xy: Callable, program: tuple) -> Callable:
    """Lift an elementwise height `h(x, y)` to `f(xy) -> (h, unit normal)`,
    with `f.height_components` and the postfix program of its packed form."""
    components = _components(height_xy)

    def fn(xy):
        xy = torch.as_tensor(xy)
        h, (nx, ny, nz) = components(xy[..., 0], xy[..., 1])
        n = torch.stack(torch.broadcast_tensors(nx, ny, nz), dim=-1)
        n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
        return torch.broadcast_to(h, xy.shape[:-1]), n

    fn.height_components = components
    fn.terrain_program = program
    return fn


def _leaf(op: int, params: tuple, octaves: int = 0, seed: int = 0) -> Callable:
    params = tuple(float(p) for p in params)
    return _height_with_normal(_leaf_height(op, params, octaves, seed),
                               ((op, params, int(octaves), int(seed)),))


# --------------------------------------------------------------------------- #
# Ground generators (reference `geometry.cc`: periodicStairs,
# randomPerlinGround, periodicPerlinGround, unidirectionalRandomPerlinGround)
# --------------------------------------------------------------------------- #


def periodic_stairs_ground(step_width: float, step_height: float, step_number: int,
                           orientation: float = 0.0) -> Callable:
    """Periodic staircase: `step_number` steps up then down, repeating. The
    profile is smoothed over 1 % of the step width so the normal stays
    defined."""
    c, s = np.cos(orientation), np.sin(orientation)
    period = 2.0 * step_number * step_width
    return _leaf(T_STAIRS, (c, s, period, step_width, step_number, step_height))


def random_perlin_ground(wavelength: float, height_max: float, seed: int = 0,
                         octaves: int = 4) -> Callable:
    """Isotropic octave-Perlin terrain."""
    return _leaf(T_PERLIN, (wavelength, height_max, _octave_norm(octaves)), octaves, seed)


def periodic_perlin_ground(wavelength: float, period: float, height_max: float,
                           seed: int = 0, octaves: int = 4) -> Callable:
    """Perlin terrain periodized by sampling noise on a torus embedding."""
    r = period / (2 * np.pi * wavelength)
    return _leaf(T_PERIODIC_PERLIN, (2 * np.pi, period, r, height_max, _octave_norm(octaves)),
                 octaves, seed)


def unidirectional_random_perlin_ground(wavelength: float, height_max: float,
                                        orientation: float = 0.0, seed: int = 0,
                                        octaves: int = 4) -> Callable:
    """1D Perlin ripples along a direction."""
    c, s = np.cos(orientation), np.sin(orientation)
    return _leaf(T_UNIDIRECTIONAL, (c, s, wavelength, height_max, _octave_norm(octaves)),
                 octaves, seed)


# --------------------------------------------------------------------------- #
# Heightmap algebra (reference `sumHeightmaps`, `mergeHeightmaps`,
# `discretizeHeightmap`)
# --------------------------------------------------------------------------- #


def _program_of(grounds: Sequence[Callable], op: int) -> Optional[tuple]:
    """The left fold of the terms' programs under a binary node, or None
    when a term has no packed form."""
    programs = [getattr(g, "terrain_program", None) for g in grounds]
    if not programs or any(p is None for p in programs):
        return None
    out = programs[0]
    for p in programs[1:]:
        out = out + p + ((op, (), 0, 0),)
    return out


def _sum_components(a, b):
    """One term of `sum_heightmaps`' component sum: (h, (gx, gy, 1))."""
    h1, (x1, y1, z1) = a
    h2, (x2, y2, z2) = b
    return h1 + h2, (x1 / z1 + x2 / z2, y1 / z1 + y2 / z2, torch.ones_like(h1 + h2))


def _merge_components(a, b):
    """One term of `merge_heightmaps`' running `where`."""
    h_out, n_out = a
    h, n = b
    take = h > h_out
    return torch.where(take, h, h_out), tuple(torch.where(take, p, q) for p, q in zip(n, n_out))


def sum_heightmaps(grounds: Sequence[Callable]) -> Callable:
    """Sum of ground profiles; normals re-derived from the summed gradients."""

    def fn(xy):
        h_total, grad = 0.0, 0.0
        for g in grounds:
            h, n = g(xy)
            h_total = h_total + h
            # the gradient from the normal: n = normalize([-gx, -gy, 1])
            grad = grad + (-n[..., 0:2] / torch.clamp(n[..., 2:3], min=1e-9))
        n = torch.cat([-grad, torch.ones(grad.shape[:-1] + (1,), dtype=grad.dtype,
                                         device=grad.device)], dim=-1)
        n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
        return h_total, n

    cfns = [getattr(g, "height_components", None) for g in grounds]
    if all(c is not None for c in cfns):

        def components(x, y):
            h_total, gx, gy = 0.0, 0.0, 0.0
            for c in cfns:
                h, (nx, ny, nz) = c(x, y)
                h_total = h_total + h
                gx = gx + nx / nz
                gy = gy + ny / nz
            return h_total, (gx, gy, torch.ones_like(h_total))

        fn.height_components = components
    fn.terrain_program = _program_of(grounds, T_SUM)
    return fn


def merge_heightmaps(grounds: Sequence[Callable]) -> Callable:
    """Pointwise maximum of ground profiles (the first of equal heights)."""

    def fn(xy):
        hs, ns = zip(*[g(xy) for g in grounds])
        h = torch.stack(hs, dim=0)
        n = torch.stack(ns, dim=0)
        idx = torch.argmax(h, dim=0)
        h_out = torch.take_along_dim(h, idx[None], dim=0)[0]
        n_out = torch.take_along_dim(n, idx[None, ..., None], dim=0)[0]
        return h_out, n_out

    cfns = [getattr(g, "height_components", None) for g in grounds]
    if all(c is not None for c in cfns):

        def components(x, y):
            out = cfns[0](x, y)
            for c in cfns[1:]:
                out = _merge_components(out, c(x, y))
            return out

        fn.height_components = components
    fn.terrain_program = _program_of(grounds, T_MERGE)
    return fn


def discretize_heightmap(ground: Callable, x_range, y_range, resolution: float):
    """Sample a ground profile to a regular grid: `(grid, query)`, the grid a
    numpy array, `query(xy) -> (h, unit normal)` its bilinear interpolation
    (no packed form: it runs on the CPU)."""
    xs = np.arange(x_range[0], x_range[1] + resolution / 2, resolution)
    ys = np.arange(y_range[0], y_range[1] + resolution / 2, resolution)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    xy = torch.as_tensor(np.stack([gx.ravel(), gy.ravel()], axis=-1))
    h, _ = ground(xy)
    grid = np.asarray(h.cpu()).reshape(len(xs), len(ys))

    def query(xy_q):
        xy_q = torch.as_tensor(xy_q)
        fx = (xy_q[..., 0] - x_range[0]) / resolution
        fy = (xy_q[..., 1] - y_range[0]) / resolution
        ix = torch.clamp(torch.floor(fx).to(torch.int64), 0, len(xs) - 2)
        iy = torch.clamp(torch.floor(fy).to(torch.int64), 0, len(ys) - 2)
        tx = torch.clamp(fx - ix, 0.0, 1.0)
        ty = torch.clamp(fy - iy, 0.0, 1.0)
        g = torch.as_tensor(grid, dtype=xy_q.dtype, device=xy_q.device)
        h00, h10 = g[ix, iy], g[ix + 1, iy]
        h01, h11 = g[ix, iy + 1], g[ix + 1, iy + 1]
        h0 = h00 + tx * (h10 - h00)
        h1 = h01 + tx * (h11 - h01)
        h_q = h0 + ty * (h1 - h0)
        gx_q = ((h10 - h00) + ty * ((h11 - h01) - (h10 - h00))) / resolution
        gy_q = ((h01 - h00) + tx * ((h11 - h10) - (h01 - h00))) / resolution
        n = torch.stack([-gx_q, -gy_q, torch.ones_like(gx_q)], dim=-1)
        n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
        return h_q, n

    return grid, query


# --------------------------------------------------------------------------- #
# The packed form and its plain evaluation
# --------------------------------------------------------------------------- #

UNPACKED_GROUND_ITEM = "ROADMAP.md queue 2 item 6"


def ground_route(fn: Optional[Callable], device) -> str:
    """Where a ground runs on `device`: "flat" (no ground), "packed" (the
    kernels evaluate its program) or "plain" (a callable on the CPU). A
    ground without a packed form is refused off the CPU: no path there
    evaluates a Python callable in place of a kernel."""
    device = torch.device(device)
    if fn is None:
        return "flat"
    if getattr(fn, "terrain_program", None) is not None:
        return "packed"
    if device.type == "cpu":
        return "plain"
    raise NotImplementedError(
        "a ground profile without a packed form (a user callable, a sampled "
        "heightmap's query, or a sum or merge with such a term) runs on the CPU only; "
        f"on the card it is not ported yet ({UNPACKED_GROUND_ITEM})"
    )


def _stack_depth(program: tuple) -> int:
    depth = peak = 0
    for op, _, _, _ in program:
        depth += -1 if op in (T_SUM, T_MERGE) else 1
        if depth < 1:
            raise ValueError("terrain program: a node lacks operands")
        peak = max(peak, depth)
    if depth != 1:
        raise ValueError("terrain program leaves more than one result")
    return peak


def pack_ground(fn: Callable, device="cpu", dtype=torch.float64):
    """The packed form of a ground: `(ti, tf)`, an int32 buffer `[n_ops,
    stack depth, (opcode, float offset, octaves, seed) per op]` and a float
    buffer of the leaves' parameters (float64 on the host, rounded once to
    `dtype`). Raises for a ground without a packed form and for a program
    deeper than the kernels' stack (`TERRAIN_STACK`)."""
    program = getattr(fn, "terrain_program", None) if fn is not None else None
    if program is None:
        raise NotImplementedError(
            f"this ground profile has no packed form ({UNPACKED_GROUND_ITEM})"
        )
    depth = _stack_depth(program)
    if depth > TERRAIN_STACK:
        raise ValueError(f"terrain program needs a stack of {depth} > {TERRAIN_STACK}")
    ti, tf = [len(program), depth], []
    for op, params, octaves, seed in program:
        ti += [op, len(tf), octaves, seed & _U32]  # the seed's bits, as int32
        tf += list(params)
    return (torch.tensor(ti, dtype=torch.int64).to(torch.int32).to(device),
            torch.tensor(tf or [0.0], dtype=torch.float64).to(device=device, dtype=dtype))


def eval_packed(ti: torch.Tensor, tf: torch.Tensor, x, y):
    """The plain version of the kernels' `terrain_eval` (csrc/terrain.cuh):
    run the postfix program on a stack of `(h, (nx, ny, nz))` entries.
    Parameters are read from `tf` (already in the run's dtype)."""
    ints = [int(i) for i in ti.tolist()]
    floats = tf.tolist()
    n_ops = ints[0]
    stack = []
    for k in range(n_ops):
        op, off, octaves, seed = ints[TI_HEADER + TI_OP * k:TI_HEADER + TI_OP * (k + 1)]
        if op in (T_SUM, T_MERGE):
            b, a = stack.pop(), stack.pop()
            stack.append(_sum_components(a, b) if op == T_SUM else _merge_components(a, b))
            continue
        n_params = _LEAVES[op][1]
        params = floats[off:off + n_params]
        stack.append(_components(_leaf_height(op, params, octaves, seed & _U32))(x, y))
    return stack[0]
