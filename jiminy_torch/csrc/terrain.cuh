// Procedural terrain evaluated per contact in device code: the CUDA
// counterpart of `eval_packed` (jiminy_torch/utils/terrain.py), which mirrors
// the `height_components` closures of jiminy_tpu/utils/terrain.py that
// jiminy_tpu's Pallas kernels trace per contact point.
//
// A ground is a postfix program packed once per model (`pack_ground`, the
// terrain section of `pack_model`'s buffers): leaves (the four generators
// with their parameters, folded in float64 on the host and rounded once to
// T) and SUM / MERGE nodes. The program is tiny and the same for every env:
// it is read through the read-only data cache (__ldg) from the model's
// global buffers, never copied into an env's shared-memory slice.
//
// The normal is the surface gradient, taken by forward-mode arithmetic on
// `Dual` (a value and its derivatives along x and y), one operation for each
// of the primal's, under JAX's rules: floor and the lattice hash have
// tangent 0, mod tangent 1, and min / max (so clip) split a tie evenly. The
// lattice hash wraps natively in unsigned 32-bit arithmetic. sincos gives
// both of an angle's values; no fast-math intrinsic is used.
//
// The stack of partial results (h, nx, ny, nz) holds TERRAIN_STACK entries
// in registers: a push or a pop selects over its slots with a run-time
// index through `select_if`, never an indexed access.
#pragma once

namespace cdyn {

// Opcodes and layout of the packed program (`pack_ground`): int buffer
// [n_ops, depth, (opcode, float offset, octaves, seed) per op], float buffer
// of the leaves' parameters.
enum TerrainOp {
  T_SUM = 0,
  T_MERGE = 1,
  T_STAIRS = 2,            // c s period step_width step_number step_height
  T_PERLIN = 3,            // wavelength height_max norm
  T_PERIODIC_PERLIN = 4,   // two_pi period r height_max norm
  T_UNIDIRECTIONAL = 5     // c s wavelength height_max norm
};
constexpr int TI_HEADER = 2, TI_OP = 4, TERRAIN_STACK = 4;
// The int header's slots with the terrain section's offsets in ci and cf
// (`pack_model`; 0 on flat ground).
constexpr int CI_TERRAIN = 10;

template <typename T>
struct Dual {
  T v, x, y;
};

template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) {
  return {a.v + b.v, a.x + b.x, a.y + b.y};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, T c) {
  return {a.v + c, a.x, a.y};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator+(T c, Dual<T> a) {
  return {c + a.v, a.x, a.y};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) {
  return {a.v - b.v, a.x - b.x, a.y - b.y};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, T c) {
  return {a.v - c, a.x, a.y};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(T c, Dual<T> a) {
  return {c - a.v, -a.x, -a.y};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, a.x * b.v + a.v * b.x, a.y * b.v + a.v * b.y};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, T c) {
  return {a.v * c, a.x * c, a.y * c};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(T c, Dual<T> a) {
  return {c * a.v, c * a.x, c * a.y};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, T c) {
  return {a.v / c, a.x / c, a.y / c};
}

__device__ __forceinline__ void tsincos(float a, float* s, float* c) { sincosf(a, s, c); }
__device__ __forceinline__ void tsincos(double a, double* s, double* c) { sincos(a, s, c); }

template <typename T>
__device__ __forceinline__ Dual<T> dual_cos(Dual<T> a) {
  T s, c;
  tsincos(a.v, &s, &c);
  return {c, -(a.x * s), -(a.y * s)};
}
template <typename T>
__device__ __forceinline__ Dual<T> dual_sin(Dual<T> a) {
  T s, c;
  tsincos(a.v, &s, &c);
  return {s, a.x * c, a.y * c};
}

// jnp.mod: fmod with the sign fixed to the divisor's; tangent 1
template <typename T>
__device__ __forceinline__ Dual<T> dual_mod(Dual<T> a, T period) {
  T r = fmod(a.v, period);
  if (r != T(0) && ((r < T(0)) != (period < T(0)))) r = r + period;
  return {r, a.x, a.y};
}

// min / max against a constant, a tie's tangent halved (JAX's _balanced_eq)
template <typename T>
__device__ __forceinline__ Dual<T> dual_min(Dual<T> a, T c) {
  const T v = (c < a.v) ? c : a.v;
  const T w = (a.v == v) ? ((c == v) ? T(0.5) : T(1)) : T(0);
  return {v, a.x * w, a.y * w};
}
template <typename T>
__device__ __forceinline__ Dual<T> dual_max(Dual<T> a, T c) {
  const T v = (a.v < c) ? c : a.v;
  const T w = (a.v == v) ? ((c == v) ? T(0.5) : T(1)) : T(0);
  return {v, a.x * w, a.y * w};
}
template <typename T>
__device__ __forceinline__ Dual<T> dual_clip(Dual<T> a, T lo, T hi) {
  return dual_min(dual_max(a, lo), hi);
}

// The lattice hash (`_hash2`), native unsigned 32-bit wrap-around
__device__ __forceinline__ unsigned terrain_hash2(int ix, int iy, unsigned seed) {
  unsigned h = (static_cast<unsigned>(ix) * 374761393u) ^ (static_cast<unsigned>(iy) * 668265263u) ^
               seed;
  h = (h ^ (h >> 13)) * 1274126177u;
  return h ^ (h >> 16);
}

// uint32 -> T as two 16-bit halves (`_u32_to_float`)
template <typename T>
__device__ __forceinline__ T u32_to_float(unsigned h) {
  const T hi = static_cast<T>(static_cast<int>(h >> 16));
  const T lo = static_cast<T>(static_cast<int>(h & 0xFFFFu));
  return hi * T(65536.0) + lo;
}

template <typename T>
__device__ __forceinline__ Dual<T> fade(Dual<T> t) {
  return t * t * t * (t * (t * T(6.0) - T(15.0)) + T(10.0));
}

// The gradient at a lattice corner dotted with the offset (`dot_grad`)
template <typename T>
__device__ __forceinline__ Dual<T> dot_grad(int ix, int iy, unsigned seed, Dual<T> dx,
                                            Dual<T> dy) {
  const T ang = u32_to_float<T>(terrain_hash2(ix, iy, seed)) *
                T(2.0 * 3.141592653589793 / 4294967296.0);
  T gy, gx;
  tsincos(ang, &gy, &gx);
  return gx * dx + gy * dy;
}

// Single-octave 2D Perlin noise (`perlin2`)
template <typename T>
__device__ __forceinline__ Dual<T> perlin2(Dual<T> x, Dual<T> y, unsigned seed) {
  const T x0 = floor(x.v), y0 = floor(y.v);
  const int ix0 = static_cast<int>(x0), iy0 = static_cast<int>(y0);
  const Dual<T> fx = x - x0, fy = y - y0;
  const Dual<T> n00 = dot_grad(ix0, iy0, seed, fx, fy);
  const Dual<T> n10 = dot_grad(ix0 + 1, iy0, seed, fx - T(1.0), fy);
  const Dual<T> n01 = dot_grad(ix0, iy0 + 1, seed, fx, fy - T(1.0));
  const Dual<T> n11 = dot_grad(ix0 + 1, iy0 + 1, seed, fx - T(1.0), fy - T(1.0));
  const Dual<T> u = fade(fx), v = fade(fy);
  const Dual<T> nx0 = n00 + u * (n10 - n00);
  const Dual<T> nx1 = n01 + u * (n11 - n01);
  return nx0 + v * (nx1 - nx0);
}

// Octave Perlin noise at persistence 0.5 with its normalizer given
// (`_octaves2`): amplitudes and frequencies are powers of two, exact
template <typename T>
__device__ __forceinline__ Dual<T> octaves2(Dual<T> x, Dual<T> y, int octaves, unsigned seed,
                                            T norm) {
  Dual<T> total = {T(0), T(0), T(0)};
  T amp = T(1), freq = T(1);
#pragma unroll 1
  for (int o = 0; o < octaves; ++o) {
    total = total + amp * perlin2(x * freq, y * freq, seed + static_cast<unsigned>(o));
    amp = amp * T(0.5);
    freq = freq * T(2.0);
  }
  return total / norm;
}

// The smoothed staircase of `_stairs_height`: floor + smoothstep over the
// riser (1 % of a step)
template <typename T>
__device__ __forceinline__ Dual<T> stairs_of(Dual<T> p) {
  const T k = floor(p.v);
  const Dual<T> frac = p - k;
  const Dual<T> riser = dual_clip((frac - T(1.0 - 0.01)) / T(0.01), T(0), T(1));
  return k + riser * riser * (T(3.0) - T(2.0) * riser);
}

// One leaf's height at (x, y), parameters at f (read-only cache)
template <typename T>
__device__ __forceinline__ Dual<T> terrain_leaf(int op, const T* __restrict__ f, int octaves,
                                                unsigned seed, Dual<T> x, Dual<T> y) {
  if (op == T_STAIRS) {
    const T c = __ldg(f), s = __ldg(f + 1), period = __ldg(f + 2), width = __ldg(f + 3);
    const T number = __ldg(f + 4), height = __ldg(f + 5);
    const Dual<T> u = c * x + s * y;
    const Dual<T> phase = dual_mod(u, period) / width;
    const Dual<T> up = dual_min(phase, number);
    const Dual<T> down = dual_max(phase - number, T(0));
    return height * (stairs_of(up) - stairs_of(down));
  }
  if (op == T_PERLIN) {
    const T wavelength = __ldg(f), height_max = __ldg(f + 1), norm = __ldg(f + 2);
    return height_max * octaves2(x / wavelength, y / wavelength, octaves, seed, norm);
  }
  if (op == T_PERIODIC_PERLIN) {
    const T two_pi = __ldg(f), period = __ldg(f + 1), r = __ldg(f + 2);
    const T height_max = __ldg(f + 3), norm = __ldg(f + 4);
    const Dual<T> tx = two_pi * x / period;
    const Dual<T> ty = two_pi * y / period;
    return height_max * octaves2(r * dual_cos(tx) + T(31.7), r * dual_sin(ty) + T(17.3), octaves,
                                 seed, norm);
  }
  // T_UNIDIRECTIONAL
  const T c = __ldg(f), s = __ldg(f + 1), wavelength = __ldg(f + 2);
  const T height_max = __ldg(f + 3), norm = __ldg(f + 4);
  const Dual<T> u = (c * x + s * y) / wavelength;
  const Dual<T> half = {T(0) + T(0.5), T(0), T(0)};
  return height_max * octaves2(u, half, octaves, seed, norm);
}

// A ground's height and (not normalized) normal at a point.
template <typename T>
struct GroundPoint {
  T h, nx, ny, nz;
};

// The ground at (x, y): the program of the terrain section of (ci, cf) run
// on a register stack. Not inlined: one copy serves every contact site.
template <typename T>
__device__ __noinline__ GroundPoint<T> terrain_eval(const int* __restrict__ ci,
                                                    const T* __restrict__ cf, T x, T y) {
  const int* __restrict__ ti = ci + __ldg(ci + CI_TERRAIN);
  const T* __restrict__ tf = cf + __ldg(ci + CI_TERRAIN + 1);
  const int n_ops = __ldg(ti);
  T sh[TERRAIN_STACK], sx[TERRAIN_STACK], sy[TERRAIN_STACK], sz[TERRAIN_STACK];
#pragma unroll
  for (int i = 0; i < TERRAIN_STACK; ++i) sh[i] = sx[i] = sy[i] = sz[i] = T(0);
  int sp = 0;  // entries on the stack
  const Dual<T> X = {x, T(1), T(0)}, Y = {y, T(0), T(1)};
#pragma unroll 1
  for (int k = 0; k < n_ops; ++k) {
    const int* op = ti + TI_HEADER + TI_OP * k;
    const int code = __ldg(op);
    T h, nx, ny, nz;
    if (code == T_SUM || code == T_MERGE) {
      // pop b (top) and a (below it)
      T ah = sh[0], ax = sx[0], ay = sy[0], az = sz[0];
      T bh = sh[0], bx = sx[0], by = sy[0], bz = sz[0];
#pragma unroll
      for (int i = 1; i < TERRAIN_STACK; ++i) {
        ah = select_if(i == sp - 2, sh[i], ah);
        ax = select_if(i == sp - 2, sx[i], ax);
        ay = select_if(i == sp - 2, sy[i], ay);
        az = select_if(i == sp - 2, sz[i], az);
        bh = select_if(i == sp - 1, sh[i], bh);
        bx = select_if(i == sp - 1, sx[i], bx);
        by = select_if(i == sp - 1, sy[i], by);
        bz = select_if(i == sp - 1, sz[i], bz);
      }
      sp -= 2;
      if (code == T_SUM) {  // `_sum_components`
        h = ah + bh;
        nx = ax / az + bx / bz;
        ny = ay / az + by / bz;
        nz = T(1);
      } else {  // `_merge_components`: b where strictly higher
        const bool take = bh > ah;
        h = select_if(take, bh, ah);
        nx = select_if(take, bx, ax);
        ny = select_if(take, by, ay);
        nz = select_if(take, bz, az);
      }
    } else {
      const Dual<T> d = terrain_leaf(code, tf + __ldg(op + 1), __ldg(op + 2),
                                     static_cast<unsigned>(__ldg(op + 3)), X, Y);
      h = d.v;
      nx = -d.x;
      ny = -d.y;
      nz = T(1);
    }
#pragma unroll
    for (int i = 0; i < TERRAIN_STACK; ++i) {  // push
      sh[i] = select_if(i == sp, h, sh[i]);
      sx[i] = select_if(i == sp, nx, sx[i]);
      sy[i] = select_if(i == sp, ny, sy[i]);
      sz[i] = select_if(i == sp, nz, sz[i]);
    }
    ++sp;
  }
  return {sh[0], sx[0], sy[0], sz[0]};
}

}  // namespace cdyn
