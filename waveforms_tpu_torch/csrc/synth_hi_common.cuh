// Shared device code of the double-tier kernels (synth_dense_hi.cu,
// synth_panel_hi.cu): the float64 opcode bodies and segment walker.
//
// The TPU kernels of this tier (waveforms_tpu/ops/hi_synth.py: op_builders_hi,
// _tile_walker_hi) compute in double-f32, pairs of f32 values combined through
// error-free transforms, because the TPU's vector unit has no f64 datapath.
// The H100 has one, so every df pair here is one double: args + args_lo,
// amp + amp_lo and the f64 ext buffer arrive as float64, and each df32
// transcendental is the CUDA double function on the same reduced argument.
// With no error-free transforms there is nothing for FMA contraction to break.
// The integer phase steps stay exactly as in the f32 kernels: int32 turns
// (wrapping, computed in uint32_t), the chirp's 11-bit split, the constant
// phase's cturns split and the quadrant reduction.  Every formula follows
// the plain version waveforms_tpu_torch/ops/reference_hi.py step by step.
//
// The f32 code of synth_common.cuh is included for its constants and integer
// helpers and is not changed.
#pragma once

#include "synth_common.cuh"

namespace wfsynth {

// double-tier output kinds: one f64 plane, or the f32 (hi, lo) planes
enum HiOutKind : int { OUT_F64 = 0, OUT_DF32 = 1 };

constexpr double PHASE_D = 0x1.921fb54442d18p-30;      // 2*pi / 2^32
constexpr double TWO_PI_D = 0x1.921fb54442d18p+2;
constexpr double INV_TWO_PI_D = 0x1.45f306dc9c883p-3;  // 1 / (2*pi)
constexpr double PI_D = 0x1.921fb54442d18p+1;
constexpr double EXP_CLAMP_D = 80.0;

// Descriptor tensors of one HiSchedule: the int32 layout of Desc, with amp
// (C, NB, S, T), args (..., W_ARGS) and ext (E,) in float64.
struct DescHi {
  const int* seg_lo;
  const int* seg_hi;
  const int* seg_hmax;
  const int* nterm;
  const int* nfac;
  const double* amp;
  const int* op;
  const int* power;
  const int* shift_hi;
  const int* q32;
  const double* args;
  const double* ext;
  const float* clip;
  int C, NB, S, T, F;
  long long n_samples;
  long long bucket_samples;
};

// (sin, cos) of turns * 2pi/2^32 + resid: quadrant from the top two bits of
// the rounded turns, f64 sincos of the remainder
__device__ __forceinline__ void sincos_turns_hi(int turns, double resid,
                                                double* s_out, double* c_out) {
  int q = wrap_add(turns, 1 << 29);
  int quad = (q >> 30) & 3;
  int r = (q & 0x3FFFFFFF) - (1 << 29);
  double x = (double)r * PHASE_D + resid;
  double s, c;
  sincos(x, &s, &c);
  bool swap = (quad & 1) == 1;
  double csign = (quad == 1 || quad == 2) ? -1.0 : 1.0;
  double ssign = (quad >= 2) ? -1.0 : 1.0;
  *c_out = (swap ? s : c) * csign;
  *s_out = (swap ? c : s) * ssign;
}

// carrier: turns = q0 * di + q1 (wrapping), resid = eps * di + ceps
__device__ __forceinline__ void carrier_hi(int di, const int* q, double eps,
                                           double ceps, double* s,
                                           double* c) {
  sincos_turns_hi(wrap_add(wrap_mul(q[0], di), q[1]), eps * (double)di + ceps,
                  s, c);
}

// jnp.clip semantics: NaN stays NaN
__device__ __forceinline__ double clamp_hi(double x, double lo, double hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// descending Horner over ascending coefficients a[first .. first+count)
__device__ __forceinline__ double polyval_asc_hi(double x, const double* a,
                                                 int first, int count) {
  double acc = a[first + count - 1];
  for (int k = count - 2; k >= 0; --k) acc = acc * x + a[first + k];
  return acc;
}

// The multi-tone DRAG bodies.  The sample walker (K4) calls them out of
// line (drag_sin_like_hi below): their coefficient loops and the blend's
// four 40-term Horner chains would otherwise set the register count of the
// whole walker.  The tile walker (K3) inlines them: there the out-of-line
// call's saved state cost a spill at three blocks per SM, and inline they
// fit in the same 168 registers.
__device__ __forceinline__ double drag_sin_like_hi_inl(int di,
                                                       const double* a,
                                                       const int* q,
                                                       const double* ext,
                                                       bool with_blend) {
  const double* e = ext + (int)a[7];      // eread(k) == e[k]
  const double uu = (double)di - a[0];
  const double lh = a[5] * 0.5;
  const double rl = lh + a[6];
  const bool rise = uu <= lh;
  const bool flat = !rise && (uu < rl);
  double s, c;
  sincos(a[1] * (rise ? uu : uu - a[6]), &s, &c);
  double ox = 0.0, oy = 0.0, sp = 1.0;
  for (int p = 0; p < DRAG_SIN_NC; ++p) {
    double basis = (p % 2) ? sp * c : sp;
    ox = ox + e[1 + p] * basis;
    oy = oy + e[1 + DRAG_SIN_NC + p] * basis;
    sp = sp * s;
  }
  if (flat) {
    ox = e[1 + 2 * DRAG_SIN_NC];
    oy = e[2 + 2 * DRAG_SIN_NC];
  }
  if (with_blend) {
    const int b0 = 3 + 2 * DRAG_SIN_NC;
    const int stride = 1 + DRAG_SINX_MAXQ;
    const double bh = e[b0];
    const double dl = uu - lh;
    const double dr = uu - rl;
    if (-bh <= dl && dl <= 0.0) {
      ox = polyval_asc_hi(dl, e, b0 + 2, DRAG_SINX_MAXQ);
      oy = polyval_asc_hi(dl, e, b0 + 2 + stride, DRAG_SINX_MAXQ);
    }
    if (0.0 <= dr && dr <= bh) {
      ox = polyval_asc_hi(dr, e, b0 + 2 + 2 * stride, DRAG_SINX_MAXQ);
      oy = polyval_asc_hi(dr, e, b0 + 2 + 3 * stride, DRAG_SINX_MAXQ);
    }
  }
  double sin_t, cos_t;
  carrier_hi(di, q, a[3], a[4], &sin_t, &cos_t);
  return ox * cos_t + oy * sin_t;
}

static __device__ __noinline__ double drag_sin_like_hi(int di, const double* a,
                                                       const int* q,
                                                       const double* ext,
                                                       bool with_blend) {
  return drag_sin_like_hi_inl(di, a, q, ext, with_blend);
}

// LINEARCHIRP: exact int32 quadratic turns, f64 residual polynomial, and the
// constant phase split into int32 turns (from the f32 rounding of phi/2pi)
// plus an f64 residual
__device__ __forceinline__ double linearchirp_hi(int di, const double* a,
                                                 const int* q) {
  const int dh = di >> 11;            // arithmetic shift
  const int dl = di & 2047;           // == di - (dh << 11)
  int t = wrap_mul(wrap_mul(q[0], dh), dh);
  t = wrap_add(t, wrap_mul(wrap_mul(q[1], dh), dl));
  t = wrap_add(t, wrap_mul(wrap_mul(q[2], dl), dl));
  t = wrap_add(t, wrap_mul(q[3], di));
  const double dhf = (double)dh, dlf = (double)dl;
  double r = (a[2] * dhf + a[3] * dlf) * dhf;
  r = r + (a[4] * dlf) * dlf;
  r = r + a[5] * (double)di;
  const double ph = a[6];
  const double c = (double)(float)(ph * INV_TWO_PI_D);
  const int ci = (int)rint((c - rint(c)) * 2147483648.0);
  const int cturns = wrap_mul(ci, 2);
  double cr = ph - (double)cturns * 0x1.0p-32 * TWO_PI_D;
  cr = cr - rint(cr * INV_TWO_PI_D) * TWO_PI_D;
  double s, co;
  sincos_turns_hi(wrap_add(t, cturns), r + cr, &s, &co);
  return s;
}

// One factor's value at sample delta di (op_builders_hi).  a: the factor's
// W_ARGS f64 args; q: its four int32 phase slots.  Inlined, so that a call
// with a constant opcode compiles to that opcode's body alone.
__device__ __forceinline__ double op_value_hi_inl(int op, int di,
                                                  const double* a,
                                                  const int* q,
                                                  const double* ext) {
  const double u = (double)di - a[0];
  const double x = a[1] * u;
  switch (op) {
    case OP_LINEAR:
      return x;
    case OP_GAUSSIAN: {
      double n = -(x * x);
      return exp(n < -EXP_CLAMP_D ? -EXP_CLAMP_D : n);
    }
    case OP_ERF:
      return erf(x);
    case OP_COS: {
      double s, c;
      carrier_hi(di, q, a[2], a[3], &s, &c);
      return c;
    }
    case OP_SINC: {
      const double p = x * PI_D;
      if (fabs(p) < 1e-6) return 1.0;
      return sin(p) / p;
    }
    case OP_EXP:
      return exp(clamp_hi(x, -EXP_CLAMP_D, EXP_CLAMP_D));
    case OP_LINEARCHIRP:
      return linearchirp_hi(di, a, q);
    case OP_COSH: {
      const double e = exp(clamp_hi(x, -EXP_CLAMP_D, EXP_CLAMP_D));
      return (e + 1.0 / e) * 0.5;
    }
    case OP_SINH: {
      const double e = exp(clamp_hi(x, -EXP_CLAMP_D, EXP_CLAMP_D));
      return (e - 1.0 / e) * 0.5;
    }
    case OP_DRAG: {
      double sx, cx, sin_t, cos_t;
      sincos(x, &sx, &cx);
      const double env_x = sx * sx;
      const double env_y = a[5] * ((sx * cx) * 2.0);   // sin 2x
      carrier_hi(di, q, a[3], a[4], &sin_t, &cos_t);
      return env_x * cos_t + env_y * sin_t;
    }
    case OP_POLY_GAUSS: {
      double n = -(x * x);
      const double g = exp(n < -EXP_CLAMP_D ? -EXP_CLAMP_D : n);
      return a[2] * (polyval_asc_hi(x, a, 3, 9) * g);
    }
    case OP_MOLLIFIER: {
      // bump exp(1/(x^2-1) + 1) inside |x| < 1, or bump / (x^2-1)^(2d) *
      // P_d(x) for d <= 3; the deep edge (exp argument below -80) is 0
      const double v = x * x - 1.0;
      if (!(v < 0.0)) return 0.0;
      const double qv = 1.0 / v + 1.0;
      if (qv < -EXP_CLAMP_D) return 0.0;
      double out = exp(qv);
      const double d = a[2];
      const double inv = 1.0 / (v * v);
      if (d >= 1.0) out = out * inv;
      if (d >= 2.0) out = out * inv;
      if (d >= 3.0) out = out * inv;
      if (d > 0.0) out = out * polyval_asc_hi(x, a, 3, 9);
      return out;
    }
    case OP_DRAG_SIN:
      return drag_sin_like_hi(di, a, q, ext, false);
    case OP_DRAG_SINX:
      return drag_sin_like_hi(di, a, q, ext, true);
    default:
      // an opcode outside HI_OPS: HiSchedule refuses it in live slots
      return __longlong_as_double(0x7ff8000000000000LL);
  }
}

// op_value_hi_inl for the sample walker, which switches per sample
static __device__ double op_value_hi(int op, int di, const double* a,
                                     const int* q, const double* ext) {
  return op_value_hi_inl(op, di, a, q, ext);
}

// v ** p by repeated multiplication; p == 1 passes v through, a negative p
// inverts the product
__device__ __forceinline__ double raise_power_hi(double v, int p) {
  if (p == 1) return v;
  int ap = p < 0 ? -p : p;
  double out = v;
  for (int i = 1; i < ap; ++i) out = out * v;
  return p < 0 ? 1.0 / out : out;
}

// The segment walker (_tile_walker_hi) for one sample: the f64 sum over slots
// [s0, s1) of (channel c, bucket b) that contain idx of
// clip(sum_t amp_t * prod_f factor_f), added in slot order.  The clip is at
// the f32 rails: a segment whose value rounds past a rail in f32 takes the
// rail exactly (the JAX tier's clip_df, which zeroes the lo part there).
static __device__ double walk_sample_hi(const DescHi& d, int c, int b, int s0,
                                        int s1, long long idx) {
  const long long row = ((long long)c * d.NB + b) * d.S;
  const float cmin = d.clip[2 * c];
  const float cmax = d.clip[2 * c + 1];
  double acc = 0.0;
  for (int s = s0; s < s1; ++s) {
    const int nt = d.nterm[row + s];
    if (nt <= 0 || idx < (long long)d.seg_lo[row + s] ||
        idx >= (long long)d.seg_hi[row + s])
      continue;
    double seg = 0.0;
    for (int t = 0; t < nt; ++t) {
      const long long tf = (row + s) * d.T + t;
      double prod = d.amp[tf];
      const int nf = d.nfac[tf];
      for (int f = 0; f < nf; ++f) {
        const long long ff = tf * d.F + f;
        const int di = (int)((uint32_t)idx - (uint32_t)d.shift_hi[ff]);
        prod = prod * raise_power_hi(
            op_value_hi(d.op[ff], di, d.args + ff * W_ARGS, d.q32 + ff * 4,
                        d.ext),
            d.power[ff]);
      }
      seg = seg + prod;
    }
    const float h = (float)seg;
    if (h > cmax) seg = (double)cmax;
    else if (h < cmin) seg = (double)cmin;
    acc = acc + seg;
  }
  return acc;
}

// f64 store, or the split into the f32 planes hi = f32(acc), lo = f32(acc -
// hi)
__device__ __forceinline__ void store_hi(void* out, float* lo, long long pos,
                                         double acc, int out_kind) {
  if (out_kind == OUT_DF32) {
    const float h = (float)acc;
    static_cast<float*>(out)[pos] = h;
    lo[pos] = (float)(acc - (double)h);
  } else {
    static_cast<double*>(out)[pos] = acc;
  }
}

}  // namespace wfsynth
