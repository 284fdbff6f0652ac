// Shared device code of the pulse-instance kernels: the stack kernel K5
// (synth_stack.cu) and its sequenced twin K6 (synth_stack_seq.cu).
//
// Both walk a CSR block list of instance tables (ops/stack_synth.StackTables)
// into one (channel, chunk of CHUNK_ROWS 128-sample rows) tile in shared
// memory, then store the tile once.  The functions are force-inlined, so each
// kernel compiles to the code it would have with the loops written in place.
#pragma once

#include "synth_common.cuh"

namespace wfsynth {

constexpr int CHUNK_ROWS = 64;      // == ops/stack_synth.CHUNK_ROWS
constexpr int LANES = 128;          // samples per block == threads per block

// Instance tables as laid out by ops/stack_synth.build_stack_tables:
// inst (M, 4) = (channel, lo, hi, n_terms); amp, term_nfac (M, NT); op,
// power, shift_hi (M, TF); q32 (M, TF, 4); args (M, TF, W_ARGS); ext (E,).
struct StackDesc {
  const int* inst;
  const float* amp;
  const int* term_nfac;
  const int* op;
  const int* power;
  const int* shift_hi;
  const int* q32;
  const float* args;
  const float* ext;
  const int* blk_inst;
  const int* blk_row;
  int NT, TF;
};

// Zero this thread's column of the tile and add blocks [k0, k1) into it:
// thread `lane` evaluates sample `lane` of each block, the sum over its
// instance's terms of amp_t * prod_f factor_f ** power_f (the JAX
// _eval_blocks order), masked to [lo, hi).  Every tile sample has one owner
// thread, so there is no race and the sum order is the table's.  The caller
// puts a __syncthreads() between this walk and stack_store.
__device__ __forceinline__ void stack_walk(const StackDesc& t, float* acc,
                                           int k0, int k1, long long row0,
                                           int lane) {
  for (int r = 0; r < CHUNK_ROWS; ++r) acc[r * LANES + lane] = 0.0f;
  for (int k = k0; k < k1; ++k) {
    const int m = t.blk_inst[k];
    const long long row = t.blk_row[k];
    const long long idx = row * LANES + lane;
    const int* im = t.inst + 4 * m;
    if (idx < im[1] || idx >= im[2]) continue;
    const int nt = im[3];
    float seg = 0.0f;
    int f = 0;
    for (int tt = 0; tt < nt; ++tt) {
      float prod = t.amp[m * t.NT + tt];
      const int nf = t.term_nfac[m * t.NT + tt];
      for (int j = 0; j < nf; ++j, ++f) {
        const long long ff = (long long)m * t.TF + f;
        prod = prod * factor_value(t.op[ff], t.power[ff], t.shift_hi[ff],
                                   t.args + ff * W_ARGS, t.q32 + ff * 4,
                                   t.ext, idx);
      }
      seg = tt == 0 ? prod : seg + prod;
    }
    acc[(row - row0) * LANES + lane] += seg;
  }
}

// Store the tile's first `count` samples at out + base, coalesced (16-byte
// f32 or 8-byte 16-bit vectors where the row length allows), as f32, as
// int16 DAC codes clip(round_half_even(acc * sc)), or as bf16 / f16 (acc
// rounded once to nearest even).
__device__ __forceinline__ void stack_store(const float* acc, void* out,
                                            long long base, long long count,
                                            long long n_samples, int out_kind,
                                            float sc) {
  if ((n_samples & 3) == 0) {
    // rows of a multiple of 4 samples: base and count are multiples of 4
    const float4* a4 = reinterpret_cast<const float4*>(acc);
    for (long long v = threadIdx.x; v < count / 4; v += blockDim.x) {
      const float4 x = a4[v];
      if (out_kind == OUT_I16) {
        reinterpret_cast<short4*>(static_cast<short*>(out) + base)[v] =
            make_short4(dac_code(x.x, sc), dac_code(x.y, sc),
                        dac_code(x.z, sc), dac_code(x.w, sc));
      } else if (out_kind == OUT_BF16 || out_kind == OUT_F16) {
        reinterpret_cast<ushort4*>(static_cast<unsigned short*>(out) +
                                   base)[v] =
            make_ushort4(narrow_bits(x.x, out_kind),
                         narrow_bits(x.y, out_kind),
                         narrow_bits(x.z, out_kind),
                         narrow_bits(x.w, out_kind));
      } else {
        reinterpret_cast<float4*>(static_cast<float*>(out) + base)[v] = x;
      }
    }
  } else {
    for (long long i = threadIdx.x; i < count; i += blockDim.x)
      store_sample(out, base + i, acc[i], out_kind, sc);
  }
}

}  // namespace wfsynth
