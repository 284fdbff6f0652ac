// One factor over N consecutive samples: the span evaluation shared by the
// tile walkers, the dense kernel K1 (synth_dense.cu), the worklist kernel K7
// and its probe P1 (synth_item.cuh) and the pulse-instance kernels K5 and K6
// (synth_stack_common.cuh); and the segment tile walker of K1, K7 and P1
// (walk_tile), which evaluates N consecutive samples with factor_span.
//
// A walker that reads a factor's descriptors once for N samples calls
// factor_span<N>: one switch on the opcode, then N independent chains of that
// opcode's math (op_value_inl with a constant opcode), which overlap.  Each
// value is op_value's at the same sample delta, bit for bit.  The multi-tone
// DRAG bodies stay out of line (drag_sin_like_ool).
#pragma once

#include "synth_common.cuh"

namespace wfsynth {

// One opcode over N consecutive samples: v[j] = op(di0 + j), di wrapping as
// int32 (the sample walker's idx - shift)
template <int OP, int N>
__device__ __forceinline__ void op_span(float* v, int di0, const float* a,
                                        const int* q, const float* ext) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    v[j] = op_value_inl(OP, wrap_add(di0, j), a, q, ext);
}

// One factor over N samples: a single switch on its opcode
template <int N>
__device__ __forceinline__ void factor_span(float* v, int op, int di0,
                                            const float* a, const int* q,
                                            const float* ext) {
  switch (op) {
    case OP_LINEAR:
    case OP_INTERP: op_span<OP_LINEAR, N>(v, di0, a, q, ext); break;
    case OP_GAUSSIAN: op_span<OP_GAUSSIAN, N>(v, di0, a, q, ext); break;
    case OP_ERF: op_span<OP_ERF, N>(v, di0, a, q, ext); break;
    case OP_COS: op_span<OP_COS, N>(v, di0, a, q, ext); break;
    case OP_SINC: op_span<OP_SINC, N>(v, di0, a, q, ext); break;
    case OP_EXP: op_span<OP_EXP, N>(v, di0, a, q, ext); break;
    case OP_LINEARCHIRP: op_span<OP_LINEARCHIRP, N>(v, di0, a, q, ext); break;
    case OP_EXPCHIRP: op_span<OP_EXPCHIRP, N>(v, di0, a, q, ext); break;
    case OP_HYPCHIRP: op_span<OP_HYPCHIRP, N>(v, di0, a, q, ext); break;
    case OP_COSH: op_span<OP_COSH, N>(v, di0, a, q, ext); break;
    case OP_SINH: op_span<OP_SINH, N>(v, di0, a, q, ext); break;
    case OP_DRAG: op_span<OP_DRAG, N>(v, di0, a, q, ext); break;
    case OP_POLY_GAUSS: op_span<OP_POLY_GAUSS, N>(v, di0, a, q, ext); break;
    case OP_MOLLIFIER: op_span<OP_MOLLIFIER, N>(v, di0, a, q, ext); break;
    case OP_DRAG_SIN:
    case OP_DRAG_SINX:
#pragma unroll
      for (int j = 0; j < N; ++j)
        v[j] = drag_sin_like_ool(wrap_add(di0, j), a, q, ext,
                                 op == OP_DRAG_SINX);
      break;
    default:
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = __int_as_float(0x7fc00000);
  }
}

// The tile walker for samples [idx0, idx0 + N) of (channel c, bucket b) over
// slots [s0, s1): acc[j] (and acc_im[j] in pair mode) is what walk_sample
// returns for sample idx0 + j, bit for bit.
template <bool PAIR, int N>
__device__ __forceinline__ void walk_tile(const Desc& d, int c, int b, int s0,
                                          int s1, long long idx0, float* acc,
                                          float* acc_im) {
  const long long row = ((long long)c * d.NB + b) * d.S;
  const float cmin = d.clip[2 * c];
  const float cmax = d.clip[2 * c + 1];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = acc_im[j] = 0.0f;
  for (int s = s0; s < s1; ++s) {
    const int nt = d.nterm[row + s];
    const long long lo = d.seg_lo[row + s], hi = d.seg_hi[row + s];
    if (nt <= 0 || idx0 >= hi || idx0 + N <= lo) continue;
    unsigned in = 0;                       // bit j: sample idx0 + j is in
#pragma unroll
    for (int j = 0; j < N; ++j)
      in |= (unsigned)(idx0 + j >= lo && idx0 + j < hi) << j;
    float seg[N], seg_im[N];
#pragma unroll
    for (int j = 0; j < N; ++j) seg[j] = seg_im[j] = 0.0f;
    for (int t = 0; t < nt; ++t) {
      const long long tf = (row + s) * d.T + t;
      const float amp = d.amp[tf];
      float prod[N];
#pragma unroll
      for (int j = 0; j < N; ++j) prod[j] = PAIR ? 1.0f : amp;
      const int nf = d.nfac[tf];
      for (int f = 0; f < nf; ++f) {
        const long long ff = tf * d.F + f;
        const int di0 = (int)((uint32_t)idx0 - (uint32_t)d.shift_hi[ff]);
        const int p = d.power[ff];
        float v[N];
        factor_span<N>(v, d.op[ff], di0, d.args + ff * W_ARGS, d.q32 + ff * 4,
                       d.ext);
#pragma unroll
        for (int j = 0; j < N; ++j) prod[j] = prod[j] * raise_power(v[j], p);
      }
      if (PAIR) {
        const float amp_im = d.amp_im[tf];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          seg[j] = seg[j] + amp * prod[j];
          seg_im[j] = seg_im[j] + amp_im * prod[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) seg[j] = seg[j] + prod[j];
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      // the sample walker's `continue`: a sample outside the segment adds
      // nothing (a select, so a NaN or inf evaluated there cannot leak)
      const bool inj = (in >> j) & 1u;
      // clip with NaN propagation, as jnp.minimum(jnp.maximum(v, lo), hi)
      float x = seg[j] < cmin ? cmin : seg[j];
      x = x > cmax ? cmax : x;
      acc[j] = inj ? acc[j] + x : acc[j];
      if (PAIR) {
        float y = seg_im[j] < cmin ? cmin : seg_im[j];
        y = y > cmax ? cmax : y;
        acc_im[j] = inj ? acc_im[j] + y : acc_im[j];
      }
    }
  }
}

// shared-memory word of tile sample i: one pad word per 32
__device__ __forceinline__ int staged(int i) { return i + (i >> 5); }

}  // namespace wfsynth
