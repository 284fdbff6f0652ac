// Panel double-tier synthesis kernel (K4).
//
// Replaces the TPU kernel waveforms_tpu/ops/hi_synth.py:_hi_panel_kernel
// (launched by _run_panels_hi): for a single-bucket schedule it evaluates only
// the live Rs x 128 subtiles of a PanelPlan worklist (start, work_t, work_o,
// work_s0, work_s1) with the float64 walker of synth_hi_common.cuh, and
// writes zeros everywhere else, so the fill is fused into the same pass.  It
// stores float64, or the f32 (hi, lo) planes of the TPU kernel.
//
// Layout, as synth_panel.cu: one thread block per (chunk, panel, channel), a
// chunk being CHUNK_SUBTILES consecutive subtiles of the panel.  The block
// zeroes its rows (both planes in the split store), then walks its panel's
// items and takes those whose output subtile lies in its chunk.  Race
// freedom: blocks own disjoint output rows, a __syncthreads() separates the
// fill from the walk, and with one bucket each output sample is written by
// the walk once.
//
// What bounds it on the H100: the output store stream.  A pulse-sparse
// schedule (the flagship: 128 ch x 2M samples, 457 live subtiles) is almost
// all zero fill, 2.05 GB as float64 (twice the f32 panel kernel's), while the
// walk touches a few MB.  Chunks give thousands of blocks, so every SM keeps
// storing, and consecutive threads store consecutive samples.
#include "synth_hi_common.cuh"

namespace wfsynth {

constexpr int CHUNK_SUBTILES_HI = 8;

__global__ void synth_panel_hi_kernel(DescHi d, const int* __restrict__ start,
                                      const int* __restrict__ work_t,
                                      const int* __restrict__ work_o,
                                      const int* __restrict__ work_s0,
                                      const int* __restrict__ work_s1, int Rs,
                                      int P, int NP, long long window,
                                      void* out, float* lo, int out_kind) {
  const int chunk = blockIdx.x, p = blockIdx.y, c = blockIdx.z;
  const long long tile = (long long)Rs * 128;
  const long long row0 =
      (long long)p * P + (long long)chunk * CHUNK_SUBTILES_HI * Rs;
  const long long row1 = min(row0 + (long long)CHUNK_SUBTILES_HI * Rs,
                             (long long)(p + 1) * P);
  const long long o0 = row0 * 128;
  const long long o1 = min(row1 * 128, window);
  const long long out_row = (long long)c * window;

  for (long long o = o0 + threadIdx.x; o < o1; o += blockDim.x)
    store_hi(out, lo, out_row + o, 0.0, out_kind);
  __syncthreads();

  const int slot = c * NP + p;          // one bucket
  const int k1 = start[slot + 1];
  for (int k = start[slot]; k < k1; ++k) {
    const long long orow = (long long)work_o[k] * Rs;
    if (orow < row0 || orow >= row1) continue;   // another chunk's item
    const long long base = (long long)work_t[k] * tile;
    const long long obase = orow * 128;
    const int s0 = work_s0[k], s1 = work_s1[k];
    for (long long i = threadIdx.x; i < tile && obase + i < window;
         i += blockDim.x) {
      const double acc = walk_sample_hi(d, c, 0, s0, s1, base + i);
      store_hi(out, lo, out_row + obase + i, acc, out_kind);
    }
  }
}

}  // namespace wfsynth

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  NB must be
// 1 (the wrapper refuses bucketed schedules).
int wf_synth_panel_hi(const int* seg_lo, const int* seg_hi, const int* nterm,
                      const int* nfac, const double* amp, const int* op,
                      const int* power, const int* shift_hi, const int* q32,
                      const double* args, const double* ext, const float* clip,
                      int C, int NB, int S, int T, int F, long long n_samples,
                      long long bucket_samples, const int* start,
                      const int* work_t, const int* work_o, const int* work_s0,
                      const int* work_s1, int Rs, int P, int NP,
                      long long window, void* out, float* lo, int out_kind,
                      void* stream) {
  wfsynth::DescHi d{seg_lo, seg_hi, nullptr, nterm, nfac, amp, op, power,
                    shift_hi, q32, args, ext, clip, C, NB, S, T, F,
                    n_samples, bucket_samples};
  const int threads = 256;
  const int chunks = (P / Rs + wfsynth::CHUNK_SUBTILES_HI - 1) /
                     wfsynth::CHUNK_SUBTILES_HI;
  if (C > 0 && NP > 0 && chunks > 0) {
    dim3 grid((unsigned)chunks, (unsigned)NP, (unsigned)C);
    wfsynth::synth_panel_hi_kernel<<<grid, threads, 0,
                                     (cudaStream_t)stream>>>(
        d, start, work_t, work_o, work_s0, work_s1, Rs, P, NP, window, out,
        lo, out_kind);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
