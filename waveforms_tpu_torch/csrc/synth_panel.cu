// Panel synthesis kernel (K2).
//
// Replaces the TPU kernel waveforms_tpu/ops/sparse_synth.py:_panel_kernel
// (launched by _run_panels).  It evaluates only the live Rs x 128 subtiles
// of a PanelPlan worklist (start, work_t, work_o, work_s0, work_s1) and
// writes zeros everywhere else, so the fill is fused into the same pass.
//
// Layout: one thread block per (chunk, panel, channel), a chunk being
// CHUNK_SUBTILES consecutive subtiles of the panel.  The block zeroes its
// rows, then walks the panel's items bucket by bucket, in order, and takes
// the items whose output subtile lies in its chunk.  Race freedom: blocks
// own disjoint output rows; inside a block a __syncthreads() separates the
// fill from the walk, and in the walk the thread that reads and writes an
// output sample is fixed by the sample's offset in its subtile, so the
// multi-bucket straddles (read-modify-write, f32 only) of one subtile are
// accumulated by one thread in bucket order -- no atomics.  The plan keeps
// narrowed output (int16 codes, bf16, f16) to single-bucket schedules, so it
// is rounded and stored once.  Pair mode (complex64 output,
// walk_sample<true>) follows the f32 path with an (re, im) pair per sample.
//
// What bounds it on the H100: the output store stream.  A pulse-sparse
// schedule (the flagship: 128 ch x 2M samples, 457 live subtiles) is almost
// all zero fill, 1.02 GB as f32 or 0.51 GB as int16, while the walk touches a
// few MB.  The design splits panels into chunks so that thousands of blocks
// keep every SM storing, stores coalesce (consecutive threads, consecutive
// samples), and int16 codes halve the stream.  The output is written at its
// final (C, window_samples) shape: no padded buffer, no copy.
#include "synth_common.cuh"

namespace wfsynth {

constexpr int CHUNK_SUBTILES = 8;

template <bool PAIR>
__global__ void synth_panel_kernel(Desc d, const int* __restrict__ start,
                                   const int* __restrict__ work_t,
                                   const int* __restrict__ work_o,
                                   const int* __restrict__ work_s0,
                                   const int* __restrict__ work_s1, int Rs,
                                   int P, int NP, long long window, void* out,
                                   int out_kind, const float* scale) {
  const int chunk = blockIdx.x, p = blockIdx.y, c = blockIdx.z;
  const long long tile = (long long)Rs * 128;
  const long long row0 = (long long)p * P + (long long)chunk * CHUNK_SUBTILES * Rs;
  const long long row1 = min(row0 + (long long)CHUNK_SUBTILES * Rs,
                             (long long)(p + 1) * P);
  const long long o0 = row0 * 128;
  const long long o1 = min(row1 * 128, window);
  const long long out_row = (long long)c * window;
  const float sc = out_kind == OUT_I16 ? scale[c] : 1.0f;

  for (long long o = o0 + threadIdx.x; o < o1; o += blockDim.x)
    store_walk<PAIR>(out, out_row + o, make_float2(0.0f, 0.0f), out_kind, sc);
  __syncthreads();

  for (int b = 0; b < d.NB; ++b) {
    const int slot = (c * NP + p) * d.NB + b;
    const int k1 = start[slot + 1];
    for (int k = start[slot]; k < k1; ++k) {
      const long long orow = (long long)work_o[k] * Rs;
      if (orow < row0 || orow >= row1) continue;   // another chunk's item
      const long long base = (long long)work_t[k] * tile;
      const long long obase = orow * 128;
      const int s0 = work_s0[k], s1 = work_s1[k];
      for (long long i = threadIdx.x; i < tile && obase + i < window;
           i += blockDim.x) {
        float2 acc = walk_sample<PAIR>(d, c, b, s0, s1, base + i);
        const long long pos = out_row + obase + i;
        if (d.NB > 1) {
          if (PAIR) {
            const float2 prev = static_cast<float2*>(out)[pos];
            acc = make_float2(prev.x + acc.x, prev.y + acc.y);
          } else {
            acc.x = static_cast<float*>(out)[pos] + acc.x;
          }
        }
        store_walk<PAIR>(out, pos, acc, out_kind, sc);
      }
    }
  }
}

}  // namespace wfsynth

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).
int wf_synth_panel(const int* seg_lo, const int* seg_hi, const int* nterm,
                   const int* nfac, const float* amp, const int* op,
                   const int* power, const int* shift_hi, const int* q32,
                   const float* args, const float* ext, const float* clip,
                   const float* amp_im, int C, int NB, int S, int T, int F,
                   long long n_samples,
                   long long bucket_samples, const int* start,
                   const int* work_t, const int* work_o, const int* work_s0,
                   const int* work_s1, int Rs, int P, int NP,
                   long long window, void* out, int out_kind,
                   const float* scale, void* stream) {
  wfsynth::Desc d{seg_lo, seg_hi, nullptr, nterm, nfac, amp, op, power,
                  shift_hi, q32, args, ext, clip, amp_im, C, NB, S, T, F,
                  n_samples, bucket_samples};
  const int threads = 256;
  const int chunks = (P / Rs + wfsynth::CHUNK_SUBTILES - 1) /
                     wfsynth::CHUNK_SUBTILES;
  if (C > 0 && NP > 0 && chunks > 0) {
    dim3 grid((unsigned)chunks, (unsigned)NP, (unsigned)C);
    cudaStream_t st = (cudaStream_t)stream;
    if (out_kind == wfsynth::OUT_C64)
      wfsynth::synth_panel_kernel<true><<<grid, threads, 0, st>>>(
          d, start, work_t, work_o, work_s0, work_s1, Rs, P, NP, window, out,
          out_kind, scale);
    else
      wfsynth::synth_panel_kernel<false><<<grid, threads, 0, st>>>(
          d, start, work_t, work_o, work_s0, work_s1, Rs, P, NP, window, out,
          out_kind, scale);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
