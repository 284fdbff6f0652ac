// Worklist synthesis kernel (K7).
//
// Replaces the TPU kernel waveforms_tpu/ops/sparse_synth.py:_sparse_kernel
// (launched by _run_sparse).  The worklist of a SparsePlan (work_c, work_b,
// work_t, work_o, work_s0, work_s1) names every live Rs x 128 subtile: its
// channel, descriptor bucket, absolute sample base, output subtile and
// segment range [s0, s1).  Each item's subtile is evaluated with the segment
// walker (the TPU kernel's _tile_walker: mask, clip, f32 accumulation in
// slot order) and stored, as f32, as bf16 or f16 (rounded once), as int16
// DAC codes clip(round_half_even(acc * scale)), or, in pair mode, as
// complex64.
//
// Layout: one thread block per worklist item; consecutive threads own
// consecutive samples of the subtile, so stores coalesce.  Padding items
// (work_o == n_tiles) return at once: the TPU wrote them into a scratch row
// block, the card needs none.  The output is written at its final
// (C, window) shape, masked at the window's end.
//
// Race freedom and the background: the output arrives zeroed (the TPU kernel
// too takes its zero background from outside, _run_sparse), and every item
// only stores.  build_sparse_plan requires buckets that are whole subtiles,
// so no output subtile has two items: no read-modify-write, no atomics, and
// int16 codes are stored once.
//
// What bounds it on the H100: the work is the live subtiles only (457 of
// 62,500 per-channel subtiles on the flagship, 1.9 M samples), so the kernel
// itself is short and launch- and latency-bound; the path's cost is the
// zero fill of the output before it (1.02 GB as f32 on the flagship).
#include "synth_common.cuh"

namespace wfsynth {

template <bool PAIR>
__global__ void synth_sparse_kernel(Desc d, const int* __restrict__ work_c,
                                    const int* __restrict__ work_b,
                                    const int* __restrict__ work_t,
                                    const int* __restrict__ work_o,
                                    const int* __restrict__ work_s0,
                                    const int* __restrict__ work_s1, int Rs,
                                    int n_tiles, long long window, void* out,
                                    int out_kind, const float* scale) {
  const int k = blockIdx.x;
  const int o = work_o[k];
  if (o >= n_tiles) return;                 // padding item
  const int c = work_c[k], b = work_b[k];
  const int s0 = work_s0[k], s1 = work_s1[k];
  const long long tile = (long long)Rs * 128;
  const long long base = (long long)work_t[k] * tile;
  const long long obase = (long long)o * tile;
  const long long out_row = (long long)c * window;
  const float sc = out_kind == OUT_I16 ? scale[c] : 1.0f;
  for (long long i = threadIdx.x; i < tile && obase + i < window;
       i += blockDim.x) {
    const float2 acc = walk_sample<PAIR>(d, c, b, s0, s1, base + i);
    store_walk<PAIR>(out, out_row + obase + i, acc, out_kind, sc);
  }
}

}  // namespace wfsynth

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  K is the
// worklist length, padding included.
int wf_synth_sparse(const int* seg_lo, const int* seg_hi, const int* nterm,
                    const int* nfac, const float* amp, const int* op,
                    const int* power, const int* shift_hi, const int* q32,
                    const float* args, const float* ext, const float* clip,
                    const float* amp_im, int C, int NB, int S, int T, int F,
                    long long n_samples, long long bucket_samples,
                    const int* work_c, const int* work_b, const int* work_t,
                    const int* work_o, const int* work_s0,
                    const int* work_s1, int K, int Rs, int n_tiles,
                    long long window, void* out, int out_kind,
                    const float* scale, void* stream) {
  wfsynth::Desc d{seg_lo, seg_hi, nullptr, nterm, nfac, amp, op, power,
                  shift_hi, q32, args, ext, clip, amp_im, C, NB, S, T, F,
                  n_samples, bucket_samples};
  const int threads = 256;
  if (K > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (out_kind == wfsynth::OUT_C64)
      wfsynth::synth_sparse_kernel<true><<<K, threads, 0, st>>>(
          d, work_c, work_b, work_t, work_o, work_s0, work_s1, Rs, n_tiles,
          window, out, out_kind, scale);
    else
      wfsynth::synth_sparse_kernel<false><<<K, threads, 0, st>>>(
          d, work_c, work_b, work_t, work_o, work_s0, work_s1, Rs, n_tiles,
          window, out, out_kind, scale);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
