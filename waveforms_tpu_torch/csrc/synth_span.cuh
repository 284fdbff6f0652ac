// One factor over N consecutive samples: the span evaluation shared by the
// tile walkers, the dense kernel K1 (synth_dense.cu) and the pulse-instance
// kernels K5 and K6 (synth_stack_common.cuh).
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

}  // namespace wfsynth
