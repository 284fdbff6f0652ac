// Dense double-tier synthesis kernel (K3).
//
// Replaces the TPU kernel waveforms_tpu/ops/hi_synth.py:_hi_kernel (with
// _tile_walker_hi and op_builders_hi, launched by _run_kernel_hi and its XLA
// searchsorted prologue).  It computes what that kernel computes -- every
// sample of every channel is the sum over its bucket's segments that contain
// it of clip(sum_t amp_t * prod_f factor_f), to <= 1e-9 of the float64 oracle
// -- but in native float64 where the TPU used double-f32 pairs, and stores
// float64, or the two f32 planes hi = f32(x), lo = f32(x - hi) that the TPU
// kernel stores.
//
// Layout, as synth_dense.cu: one thread block per (sample tile, channel); the
// block finds its segment range [s0, s1) by binary search over the bucket's
// running max of hi (s0) and lo (s1), and each thread walks those segments
// for its samples, one sample at a time, adding them in lo-sorted order in
// double.  Tiles never straddle a bucket: the wrapper picks a tile that
// divides bucket_samples.  Consecutive threads own consecutive samples, so
// stores coalesce.
//
// What bounds it on the H100: on an occupancy-1 schedule it is the per-sample
// FP64 math -- sincos and exp in double, at the card's FP64 issue rate --
// not the 8-byte store stream.  The design evaluates exactly one opcode per
// factor per sample and keeps the multi-tone DRAG bodies out of line, so the
// common opcodes' register count stays low.
#include "synth_hi_common.cuh"

namespace wfsynth {

// number of entries of a[0..n) <= key (searchsorted side='right')
__device__ __forceinline__ int bisect_right(const int* a, int n,
                                            long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if ((long long)a[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// number of entries of a[0..n) < key (searchsorted side='left')
__device__ __forceinline__ int bisect_left(const int* a, int n, long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if ((long long)a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void synth_dense_hi_kernel(DescHi d, int tile, void* out, float* lo,
                                      int out_kind) {
  const int c = blockIdx.y;
  const long long base = (long long)blockIdx.x * tile;
  const int b = d.NB > 1
      ? (int)min(base / d.bucket_samples, (long long)(d.NB - 1)) : 0;
  __shared__ int range[2];
  if (threadIdx.x == 0) {
    const long long row = ((long long)c * d.NB + b) * d.S;
    range[0] = bisect_right(d.seg_hmax + row, d.S, base);
    range[1] = bisect_left(d.seg_lo + row, d.S, base + tile);
  }
  __syncthreads();
  const int s0 = range[0], s1 = range[1];
  const long long end = min(base + (long long)tile, d.n_samples);
  for (long long idx = base + threadIdx.x; idx < end; idx += blockDim.x) {
    const double acc = walk_sample_hi(d, c, b, s0, s1, idx);
    store_hi(out, lo, (long long)c * d.n_samples + idx, acc, out_kind);
  }
}

}  // namespace wfsynth

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).
int wf_synth_dense_hi(const int* seg_lo, const int* seg_hi,
                      const int* seg_hmax, const int* nterm, const int* nfac,
                      const double* amp, const int* op, const int* power,
                      const int* shift_hi, const int* q32, const double* args,
                      const double* ext, const float* clip, int C, int NB,
                      int S, int T, int F, long long n_samples,
                      long long bucket_samples, int tile, void* out,
                      float* lo, int out_kind, void* stream) {
  wfsynth::DescHi d{seg_lo, seg_hi, seg_hmax, nterm, nfac, amp, op, power,
                    shift_hi, q32, args, ext, clip, C, NB, S, T, F,
                    n_samples, bucket_samples};
  const int threads = 256;
  const long long n_tiles = (n_samples + tile - 1) / tile;
  if (n_tiles > 0 && C > 0) {
    dim3 grid((unsigned)n_tiles, (unsigned)C);
    wfsynth::synth_dense_hi_kernel<<<grid, threads, 0,
                                     (cudaStream_t)stream>>>(
        d, tile, out, lo, out_kind);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
