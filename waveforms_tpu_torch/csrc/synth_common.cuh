// Shared device code of the synthesis kernels (synth_dense.cu, synth_panel.cu,
// synth_sparse.cu, synth_stack.cu).
//
// The descriptor program is the one lowered by waveforms_tpu_torch/ops/lowering.py
// and interpreted by the TPU kernels of waveforms_tpu/ops/pallas_synth.py
// (op_builders, _tile_walker and the phase helpers _carrier_parts,
// _quadratic_parts, _const_phase_turns, _sincos_turns).  Every formula here
// follows those term by term, in f32, so that the kernels agree with the
// plain PyTorch versions (waveforms_tpu_torch/ops/reference.py) to f32 noise.
//
// int32 wraparound is the phase design: phases are int32 fixed-point turns
// (2^32 == one turn) whose multiply-adds wrap modulo one turn.  Signed
// overflow is undefined in C++, so every such product and sum runs in
// uint32_t and is reinterpreted as int32.  Right shifts of negative values
// stay arithmetic (signed >> on nvcc), as in JAX.
//
// Built without --use_fast_math: expf/sinf/division keep their IEEE
// accuracy and denormals are kept.  Rounding is half-to-even (rintf).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace wfsynth {

constexpr int W_ARGS = 12;
constexpr int DRAG_SIN_NC = 13;       // lowering.DRAG_SIN_MAXM + 1
constexpr int DRAG_SINX_MAXQ = 40;    // lowering.DRAG_SINX_MAXQ

enum Opcode : int {
  OP_LINEAR = 0, OP_GAUSSIAN = 1, OP_ERF = 2, OP_COS = 3, OP_SINC = 4,
  OP_EXP = 5, OP_LINEARCHIRP = 6, OP_EXPCHIRP = 7, OP_HYPCHIRP = 8,
  OP_COSH = 9, OP_SINH = 10, OP_DRAG = 11, OP_POLY_GAUSS = 12,
  OP_MOLLIFIER = 13, OP_INTERP = 14, OP_DRAG_SIN = 15, OP_DRAG_SINX = 16,
};

// f32; int16 DAC codes; complex64 (pair mode), stored as (re, im) f32 pairs;
// bf16 and f16, the f32 sum rounded once to nearest even
enum OutKind : int {
  OUT_F32 = 0, OUT_I16 = 1, OUT_C64 = 2, OUT_BF16 = 3, OUT_F16 = 4
};

// f32 constants, bit-exact with the np.float32 values of the JAX kernel
constexpr float PHASE = 0x1.921fb6p-30f;        // 2*pi / 2^32
constexpr float INV_TWO_PI = 0x1.45f306p-3f;    // 1 / (2*pi)
constexpr float TWO_PI = 0x1.921fb6p+2f;
constexpr float PI_F = 0x1.921fb6p+1f;
constexpr float TWO31 = 0x1.0p+31f;
constexpr float EXP_CLAMP = 80.0f;
constexpr float C2 = -0x1.0p-1f, C4 = 0x1.555556p-5f, C6 = -0x1.6c16c2p-10f,
                C8 = 0x1.a01a02p-16f, C10 = -0x1.27e4fcp-22f;
constexpr float S3 = -0x1.555556p-3f, S5 = 0x1.111112p-7f,
                S7 = -0x1.a01a02p-13f, S9 = 0x1.71de3ap-19f;
constexpr float ERF_P = 0x1.4f740ap-2f, ERF_A1 = 0x1.04f20cp-2f,
                ERF_A2 = -0x1.23531cp-2f, ERF_A3 = 0x1.6be1c6p+0f,
                ERF_A4 = -0x1.7401c6p+0f, ERF_A5 = 0x1.0fb844p+0f;

// Descriptor tensors of one schedule, as laid out by DeviceSchedule
// (row-major, int32 / f32): seg_* and nterm (C, NB, S); nfac and amp
// (C, NB, S, T); op, power, shift_hi (C, NB, S, T, F); q32 (..., 4);
// args (..., W_ARGS); ext (E,); clip (C, 2); amp_im (C, NB, S, T), the
// second amplitude plane of a pair-mode schedule, else null.
struct Desc {
  const int* seg_lo;
  const int* seg_hi;
  const int* seg_hmax;
  const int* nterm;
  const int* nfac;
  const float* amp;
  const int* op;
  const int* power;
  const int* shift_hi;
  const int* q32;
  const float* args;
  const float* ext;
  const float* clip;
  const float* amp_im;
  int C, NB, S, T, F;
  long long n_samples;
  long long bucket_samples;
};

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

// _carrier_parts: turns = q32 * di + cq32 (wrapping), resid = eps*di + ceps
__device__ __forceinline__ void carrier_parts(int di, int q, int cq, float eps,
                                              float ceps, int* turns,
                                              float* resid) {
  *turns = wrap_add(wrap_mul(q, di), cq);
  *resid = eps * (float)di + ceps;
}

// _quadratic_parts: A*di^2 + B*di with di = dh*2^11 + dl, dh = di >> 11
__device__ __forceinline__ void quadratic_parts(int di, const int* q,
                                                const float* a, int* turns,
                                                float* resid) {
  int dh = di >> 11;            // arithmetic shift
  int dl = di & 2047;           // == di - (dh << 11), in [0, 2048)
  int t = wrap_mul(wrap_mul(q[0], dh), dh);
  t = wrap_add(t, wrap_mul(wrap_mul(q[1], dh), dl));
  t = wrap_add(t, wrap_mul(wrap_mul(q[2], dl), dl));
  t = wrap_add(t, wrap_mul(q[3], di));
  *turns = t;
  float dhf = (float)dh, dlf = (float)dl, dif = (float)di;
  // e_hh = a[2], e_hl = a[3], e_ll = a[4], e_lin = a[5]
  *resid = ((a[2] * dhf + a[3] * dlf) * dhf + a[4] * dlf * dlf) + a[5] * dif;
}

// _const_phase_turns: f32 radians -> (int32 turns, f32 residual)
__device__ __forceinline__ void const_phase_turns(float phi, int* turns,
                                                  float* resid) {
  float c = phi * INV_TWO_PI;
  int ci = (int)rintf((c - rintf(c)) * TWO31);
  int tr = wrap_mul(ci, 2);
  float r = phi - (float)tr * PHASE;
  *turns = tr;
  *resid = r - TWO_PI * rintf(r * INV_TWO_PI);
}

// _sincos_turns: quadrant from the top two bits of the rounded turns,
// Taylor polynomials on [-pi/4, pi/4)
__device__ __forceinline__ void sincos_turns(int turns, float resid,
                                             float* s_out, float* c_out) {
  int q = wrap_add(turns, 1 << 29);
  int quad = (q >> 30) & 3;
  int r = (q & 0x3FFFFFFF) - (1 << 29);
  float x = (float)r * PHASE + resid;
  float x2 = x * x;
  float cosx = 1.0f + x2 * (C2 + x2 * (C4 + x2 * (C6 + x2 * (C8 + x2 * C10))));
  float sinx = x * (1.0f + x2 * (S3 + x2 * (S5 + x2 * (S7 + x2 * S9))));
  bool swap = (quad & 1) == 1;
  float csign = (quad == 1 || quad == 2) ? -1.0f : 1.0f;
  float ssign = (quad >= 2) ? -1.0f : 1.0f;
  *c_out = (swap ? sinx : cosx) * csign;
  *s_out = (swap ? cosx : sinx) * ssign;
}

__device__ __forceinline__ float clamp_exp_arg(float x) {
  // jnp.clip semantics: NaN stays NaN
  return x < -EXP_CLAMP ? -EXP_CLAMP : (x > EXP_CLAMP ? EXP_CLAMP : x);
}

// ascending coefficients a[first .. first+count)
__device__ __forceinline__ float polyval_asc(float x, const float* a,
                                             int first, int count) {
  float acc = 0.0f;
  for (int k = count - 1; k >= 0; --k) acc = acc * x + a[first + k];
  return acc;
}

__device__ __forceinline__ float horner(const float* e, int base, float x) {
  float acc = 0.0f;
  for (int k = DRAG_SINX_MAXQ - 1; k >= 0; --k) acc = acc * x + e[base + k];
  return acc;
}

static __device__ float drag_sin_like(int di, const float* a, const int* q,
                                      const float* ext, bool with_blend) {
  const float* e = ext + (int)a[7];      // eread(k) == e[k]
  float o_dt = a[1];
  float uu = (float)di - a[0];
  float left_hi = a[5] * 0.5f;
  float right_lo = left_hi + a[6];
  bool rise = uu <= left_hi;
  bool flat = !rise && (uu < right_lo);
  float bt = rise ? uu : uu - a[6];
  float s = sinf(o_dt * bt);
  float c = cosf(o_dt * bt);
  float ox = 0.0f, oy = 0.0f, sp = 1.0f;
  for (int p = 0; p < DRAG_SIN_NC; ++p) {
    float basis = (p % 2) ? sp * c : sp;
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
    float bh = e[b0];
    float dl = uu - left_hi;
    float dr = uu - right_lo;
    bool in_l = (uu >= left_hi - bh) && (uu <= left_hi);
    bool in_r = (uu >= right_lo) && (uu <= right_lo + bh);
    if (in_l) {
      ox = horner(e, b0 + 2, dl);
      oy = horner(e, b0 + 2 + stride, dl);
    }
    if (in_r) {
      ox = horner(e, b0 + 2 + 2 * stride, dr);
      oy = horner(e, b0 + 2 + 3 * stride, dr);
    }
  }
  int turns;
  float resid, sin_t, cos_t;
  carrier_parts(di, q[0], q[1], a[3], a[4], &turns, &resid);
  sincos_turns(turns, resid, &sin_t, &cos_t);
  return ox * cos_t + oy * sin_t;
}

// The multi-tone DRAG bodies out of line, for the tile walker: their
// coefficient loops and blend Horner chains would otherwise set the register
// count of the whole walk (the sample walker keeps them inline).
static __device__ __noinline__ float drag_sin_like_ool(int di, const float* a,
                                                       const int* q,
                                                       const float* ext,
                                                       bool with_blend) {
  return drag_sin_like(di, a, q, ext, with_blend);
}

// One factor's basis value at sample delta di (op_builders).  a: the
// factor's W_ARGS f32 args; q: its four int32 phase slots.  Inlined, so that
// a call with a constant opcode compiles to that opcode's body alone.
__device__ __forceinline__ float op_value_inl(int op, int di, const float* a,
                                              const int* q,
                                              const float* ext) {
  float u = (float)di - a[0];
  switch (op) {
    case OP_LINEAR:
    case OP_INTERP:                     // reserved: never emitted
      return a[1] * u;
    case OP_GAUSSIAN: {
      float x = a[1] * u;
      return expf(-(x * x));
    }
    case OP_ERF: {                      // Abramowitz-Stegun 7.1.26
      float x = a[1] * u;
      float sign = (x > 0.0f) ? 1.0f : ((x < 0.0f) ? -1.0f : x);
      float ax = fabsf(x);
      float t = 1.0f / (1.0f + ERF_P * ax);
      float poly = t * (ERF_A1 + t * (ERF_A2 + t * (ERF_A3 + t * (ERF_A4 +
                                                               t * ERF_A5))));
      return sign * (1.0f - poly * expf(-(ax * ax)));
    }
    case OP_COS: {
      int turns;
      float resid, s, c;
      carrier_parts(di, q[0], q[1], a[2], a[3], &turns, &resid);
      sincos_turns(turns, resid, &s, &c);
      return c;
    }
    case OP_SINC: {
      float px = PI_F * (a[1] * u);
      bool small = fabsf(px) < 1e-6f;
      float safe = small ? 1.0f : px;
      return small ? 1.0f : sinf(safe) / safe;
    }
    case OP_EXP:
      return expf(clamp_exp_arg(a[1] * u));
    case OP_LINEARCHIRP: {
      int turns, cturns;
      float resid, ceps, s, c;
      quadratic_parts(di, q, a, &turns, &resid);
      const_phase_turns(a[6], &cturns, &ceps);
      sincos_turns(wrap_add(turns, cturns), resid + ceps, &s, &c);
      return s;
    }
    case OP_EXPCHIRP: {
      float x = clamp_exp_arg(a[2] * u);
      return sinf(a[3] + a[1] * expf(x));
    }
    case OP_HYPCHIRP: {
      float x = 1.0f + a[2] * u;
      x = (x < 1e-30f) ? 1e-30f : x;    // jnp.maximum: NaN stays NaN
      return sinf(a[3] + a[1] * logf(x));
    }
    case OP_COSH: {
      float e = expf(clamp_exp_arg(a[1] * u));
      return 0.5f * (e + 1.0f / e);
    }
    case OP_SINH: {
      float e = expf(clamp_exp_arg(a[1] * u));
      return 0.5f * (e - 1.0f / e);
    }
    case OP_DRAG: {
      float x = a[1] * u;
      float s = sinf(x);
      float env_x = s * s;
      int turns;
      float resid, sin_t, cos_t;
      carrier_parts(di, q[0], q[1], a[3], a[4], &turns, &resid);
      sincos_turns(turns, resid, &sin_t, &cos_t);
      float env_y = a[5] * sinf(2.0f * x);
      return env_x * cos_t + env_y * sin_t;
    }
    case OP_POLY_GAUSS: {
      float x = a[1] * u;
      return a[2] * polyval_asc(x, a, 3, 9) * expf(-(x * x));
    }
    case OP_MOLLIFIER: {
      float x = a[1] * u;
      float xx1 = x * x - 1.0f;
      bool inside = xx1 < 0.0f;
      float safe = inside ? xx1 : -1.0f;
      float bump = expf(1.0f / safe + 1.0f);
      float d = a[2];
      float denom = inside ? powf(-safe, 2.0f * d) : 1.0f;
      float poly = (d > 0.0f) ? polyval_asc(x, a, 3, 9) : 1.0f;
      return inside ? bump / denom * poly : 0.0f;
    }
    case OP_DRAG_SIN:
      return drag_sin_like(di, a, q, ext, false);
    case OP_DRAG_SINX:
      return drag_sin_like(di, a, q, ext, true);
    default:
      return __int_as_float(0x7fc00000);   // NaN: an opcode the lowering never emits
  }
}

// op_value_inl for the sample walker, which switches on the opcode per sample
static __device__ float op_value(int op, int di, const float* a,
                                 const int* q, const float* ext) {
  return op_value_inl(op, di, a, q, ext);
}

// raise_power: v ** p by repeated multiplication; p == 1 passes v through,
// a negative p inverts the product
__device__ __forceinline__ float raise_power(float v, int p) {
  if (p == 1) return v;
  int ap = p < 0 ? -p : p;
  float out = v;
  for (int i = 1; i < ap; ++i) out = out * v;
  return p < 0 ? 1.0f / out : out;
}

// One factor's value raised to its power: factor ff of the flat factor
// arrays at sample idx (di wraps as int32, as the JAX kernel's idx - shift).
__device__ __forceinline__ float factor_value(int op, int power, int shift,
                                              const float* args,
                                              const int* q32,
                                              const float* ext,
                                              long long idx) {
  const int di = (int)((uint32_t)idx - (uint32_t)shift);
  return raise_power(op_value(op, di, args, q32, ext), power);
}

// The segment walker (_tile_walker) for one sample: the sum over slots
// [s0, s1) of (channel c, bucket b) that contain idx of
// clip(sum_t amp_t * prod_f factor_f).  Slots are added in order, so the
// f32 sum has the same order as the plain version's.
//
// PAIR (pair mode, part='complex'): the factor product of each term is
// computed once, starting from 1.0 and not from amp, and scaled by both
// amplitude planes: .x = clip(sum_t amp_t * prod), .y = clip(sum_t
// amp_im_t * prod), each clipped on its own, in the JAX kernel's order.
// Otherwise .x is the sample and .y is 0.
template <bool PAIR>
static __device__ float2 walk_sample(const Desc& d, int c, int b, int s0,
                                     int s1, long long idx) {
  const long long row = ((long long)c * d.NB + b) * d.S;
  const float cmin = d.clip[2 * c];
  const float cmax = d.clip[2 * c + 1];
  float acc = 0.0f, acc_im = 0.0f;
  for (int s = s0; s < s1; ++s) {
    const int nt = d.nterm[row + s];
    if (nt <= 0 || idx < (long long)d.seg_lo[row + s] ||
        idx >= (long long)d.seg_hi[row + s])
      continue;
    float seg = 0.0f, seg_im = 0.0f;
    for (int t = 0; t < nt; ++t) {
      const long long tf = (row + s) * d.T + t;
      float prod = PAIR ? 1.0f : d.amp[tf];
      const int nf = d.nfac[tf];
      for (int f = 0; f < nf; ++f) {
        const long long ff = tf * d.F + f;
        prod = prod * factor_value(d.op[ff], d.power[ff], d.shift_hi[ff],
                                   d.args + ff * W_ARGS, d.q32 + ff * 4,
                                   d.ext, idx);
      }
      if (PAIR) {
        seg = seg + d.amp[tf] * prod;
        seg_im = seg_im + d.amp_im[tf] * prod;
      } else {
        seg = seg + prod;
      }
    }
    // clip with NaN propagation, as jnp.minimum(jnp.maximum(v, lo), hi)
    seg = seg < cmin ? cmin : seg;
    seg = seg > cmax ? cmax : seg;
    acc = acc + seg;
    if (PAIR) {
      seg_im = seg_im < cmin ? cmin : seg_im;
      seg_im = seg_im > cmax ? cmax : seg_im;
      acc_im = acc_im + seg_im;
    }
  }
  return make_float2(acc, acc_im);
}

// Fewest blocks a dense launch (K1, K3) should have: about eight per SM of
// the H100's 132, or tiles shrink
constexpr long long MIN_DENSE_BLOCKS = 1024;

// The slots of a dense tile [base, stop): range[0] = the number of hmax[i]
// <= base, range[1] = the number of lo[i] < stop, over i < S -- the
// searchsorted indices s0 (side='right') and s1 (side='left') of the two
// non-decreasing lists (hmax the running max of hi, lo sorted), counted by
// the calling warp (every lane of it calls) in rounds of one load per lane,
// not by a binary search's chain of dependent loads.  Once a lo reaches
// stop, both counts are done (hmax[i] >= hi[i] > lo[i]).
__device__ __forceinline__ void segment_range(const int* hmax, const int* lo,
                                              int S, long long base,
                                              long long stop, int* range) {
  const int first = threadIdx.x & ~31;
  const int lanes = min(32, (int)blockDim.x - first);
  const int lane = threadIdx.x - first;
  const unsigned all = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
  int n0 = 0, n1 = 0;
  for (int i0 = 0; i0 < S; i0 += lanes) {
    const int i = i0 + lane;
    const unsigned m0 =
        __ballot_sync(all, i < S && (long long)hmax[i] <= base);
    const unsigned m1 = __ballot_sync(all, i < S && (long long)lo[i] < stop);
    n0 += __popc(m0);
    n1 += __popc(m1);
    if (m1 != all) break;
  }
  if (lane == 0) {
    range[0] = n0;
    range[1] = n1;
  }
}

// the DAC code clip(round_half_even(acc * scale))
__device__ __forceinline__ short dac_code(float acc, float scale) {
  float code = rintf(acc * scale);
  code = code < -32768.0f ? -32768.0f : (code > 32767.0f ? 32767.0f : code);
  return (short)code;
}

// The 16-bit word of a narrowed store: acc rounded once, to nearest even
__device__ __forceinline__ unsigned short narrow_bits(float acc,
                                                      int out_kind) {
  return out_kind == OUT_BF16 ? __bfloat16_as_ushort(__float2bfloat16_rn(acc))
                              : __half_as_ushort(__float2half_rn(acc));
}

// f32 store, the DAC code, or the narrowed float
__device__ __forceinline__ void store_sample(void* out, long long pos,
                                             float acc, int out_kind,
                                             float scale) {
  if (out_kind == OUT_I16) {
    static_cast<short*>(out)[pos] = dac_code(acc, scale);
  } else if (out_kind == OUT_BF16 || out_kind == OUT_F16) {
    static_cast<unsigned short*>(out)[pos] = narrow_bits(acc, out_kind);
  } else {
    static_cast<float*>(out)[pos] = acc;
  }
}

// A walked sample's store: the (re, im) pair in pair mode, else
// store_sample of .x
template <bool PAIR>
__device__ __forceinline__ void store_walk(void* out, long long pos,
                                           float2 acc, int out_kind,
                                           float scale) {
  if (PAIR)
    static_cast<float2*>(out)[pos] = acc;
  else
    store_sample(out, pos, acc.x, out_kind, scale);
}

}  // namespace wfsynth
