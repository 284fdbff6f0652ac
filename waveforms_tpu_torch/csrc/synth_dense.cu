// Dense grid synthesis kernel (K1).
//
// Replaces the TPU kernel waveforms_tpu/ops/pallas_synth.py:_synth_kernel
// (launched by _run_kernel, with its XLA searchsorted prologue).  It computes
// what that kernel computes, not its block structure: every sample of every
// channel is the sum over its bucket's segments that contain it of
// clip(sum_t amp_t * prod_f factor_f), accumulated in f32 and stored as f32
// or as int16 DAC codes clip(round_half_even(acc * scale)), or, in pair mode
// (part='complex', the JAX kernel's pair=True), as complex64: one pass over
// the factor products scaled by both amplitude planes (walk_sample<true>).
//
// Layout: one thread block per (sample tile, channel); the block finds its
// segment range [s0, s1) by binary search over the bucket's running max of
// hi (s0) and lo (s1) -- the prologue that the TPU ran as plain XLA -- and
// each thread walks those segments for its samples, one sample at a time.
// Consecutive threads own consecutive samples, so stores coalesce.
//
// What bounds it on the H100: on an occupancy-1 schedule (every sample in a
// chirp x gaussian product) it is the per-sample transcendental math and the
// descriptor reads of the walk, not the store stream.  The design keeps the
// descriptors in global memory read through L1 (all threads of a warp read
// the same words, so each read is one broadcast) and evaluates exactly one
// opcode per factor per sample.  Tiles never straddle a bucket: the wrapper
// picks a tile that divides bucket_samples.
#include "synth_common.cuh"

namespace wfsynth {

// number of entries of a[0..n) <= key (searchsorted side='right')
__device__ __forceinline__ int upper_bound(const int* a, int n, long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if ((long long)a[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// number of entries of a[0..n) < key (searchsorted side='left')
__device__ __forceinline__ int lower_bound(const int* a, int n, long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if ((long long)a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <bool PAIR>
__global__ void synth_dense_kernel(Desc d, int tile, void* out, int out_kind,
                                   const float* scale) {
  const int c = blockIdx.y;
  const long long base = (long long)blockIdx.x * tile;
  const int b = d.NB > 1
      ? (int)min(base / d.bucket_samples, (long long)(d.NB - 1)) : 0;
  __shared__ int range[2];
  if (threadIdx.x == 0) {
    const long long row = ((long long)c * d.NB + b) * d.S;
    range[0] = upper_bound(d.seg_hmax + row, d.S, base);
    range[1] = lower_bound(d.seg_lo + row, d.S, base + tile);
  }
  __syncthreads();
  const int s0 = range[0], s1 = range[1];
  const float sc = out_kind == OUT_I16 ? scale[c] : 1.0f;
  const long long end = min(base + (long long)tile, d.n_samples);
  for (long long idx = base + threadIdx.x; idx < end; idx += blockDim.x) {
    const float2 acc = walk_sample<PAIR>(d, c, b, s0, s1, idx);
    store_walk<PAIR>(out, (long long)c * d.n_samples + idx, acc, out_kind, sc);
  }
}

}  // namespace wfsynth

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).
int wf_synth_dense(const int* seg_lo, const int* seg_hi, const int* seg_hmax,
                   const int* nterm, const int* nfac, const float* amp,
                   const int* op, const int* power, const int* shift_hi,
                   const int* q32, const float* args, const float* ext,
                   const float* clip, const float* amp_im, int C, int NB,
                   int S, int T, int F, long long n_samples,
                   long long bucket_samples, int tile, void* out,
                   int out_kind, const float* scale, void* stream) {
  wfsynth::Desc d{seg_lo, seg_hi, seg_hmax, nterm, nfac, amp, op, power,
                  shift_hi, q32, args, ext, clip, amp_im, C, NB, S, T, F,
                  n_samples, bucket_samples};
  const int threads = 256;
  const long long n_tiles = (n_samples + tile - 1) / tile;
  if (n_tiles > 0 && C > 0) {
    dim3 grid((unsigned)n_tiles, (unsigned)C);
    cudaStream_t st = (cudaStream_t)stream;
    if (out_kind == wfsynth::OUT_C64)
      wfsynth::synth_dense_kernel<true><<<grid, threads, 0, st>>>(
          d, tile, out, out_kind, scale);
    else
      wfsynth::synth_dense_kernel<false><<<grid, threads, 0, st>>>(
          d, tile, out, out_kind, scale);
  }
  return (int)cudaGetLastError();
}

const char* wf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
