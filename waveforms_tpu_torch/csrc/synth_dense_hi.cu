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
// Layout, as synth_dense.cu (K1): one thread block per (tile, channel), a
// tile being up to HI_SUBS passes of HI_SUB samples; the warps find every
// pass's segment range first (segment_range), and a pass that no segment
// meets is stored as zeros at once.  Tiles never straddle a bucket.
//
// The tile walker is K1's in FP64 (walk_tile_hi): each thread owns HI_N
// consecutive samples of a pass with their double accumulators in registers
// and walks the segments, terms and factors once for all of them, one
// opcode switch per factor, evaluating that opcode over its HI_N samples;
// samples outside a segment are dropped by a select.  Each sample adds
// exactly what walk_sample_hi (kept for K4) adds, in the same lo-sorted
// order, so the double sums are bit-identical to the per-sample walker's.
// HI_N is half K1's: doubles take two registers.  After the range lookups
// each warp runs on alone through the passes, staging its samples in its
// own part of shared memory and storing them coalesced, as f64 or as the
// split f32 planes: a warp whose samples a segment misses does not wait for
// one whose samples it covers.  The multi-tone DRAG bodies are inlined
// (drag_sin_like_hi_inl): out of line, the call's saved state spilled.
//
// What bounds it on the H100: on an occupancy-1 schedule the FP64 math --
// sincos and exp in double, at the card's FP64 issue rate -- not the 8-byte
// store stream.  The FP64 bodies of HI_N samples need 168 registers to run
// with no spill (__launch_bounds__ of three blocks of 128 threads per SM).
#include "synth_hi_common.cuh"

namespace wfsynth {

// The layout
constexpr int HI_N = 4;                        // samples per thread
constexpr int HI_THREADS = 128;                // threads per block
constexpr int HI_SUB = HI_N * HI_THREADS;      // samples per pass
constexpr int HI_SUBS = 16;                    // passes per tile
constexpr int HI_TILE = HI_SUB * HI_SUBS;      // samples per block
// resident blocks per SM: three blocks of 128 threads leave a thread 168
// registers (65536 / 384, in steps of 8), what the walker needs with no
// spill
constexpr int HI_MINB = 3;
static_assert(HI_N <= 32, "walk_tile_hi's mask is 32 bits");
static_assert(HI_THREADS % 32 == 0, "each warp stages its own samples");

// One opcode over N consecutive samples: v[j] = op(di0 + j), di wrapping as
// int32
template <int OP, int N>
__device__ __forceinline__ void op_span_hi(double* v, int di0,
                                           const double* a, const int* q,
                                           const double* ext) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    v[j] = op_value_hi_inl(OP, wrap_add(di0, j), a, q, ext);
}

// One factor over N samples: a single switch on its opcode (HI_OPS; any
// other opcode is NaN, as in op_value_hi)
template <int N>
__device__ __forceinline__ void factor_span_hi(double* v, int op, int di0,
                                               const double* a, const int* q,
                                               const double* ext) {
  switch (op) {
    case OP_LINEAR: op_span_hi<OP_LINEAR, N>(v, di0, a, q, ext); break;
    case OP_GAUSSIAN: op_span_hi<OP_GAUSSIAN, N>(v, di0, a, q, ext); break;
    case OP_ERF: op_span_hi<OP_ERF, N>(v, di0, a, q, ext); break;
    case OP_COS: op_span_hi<OP_COS, N>(v, di0, a, q, ext); break;
    case OP_SINC: op_span_hi<OP_SINC, N>(v, di0, a, q, ext); break;
    case OP_EXP: op_span_hi<OP_EXP, N>(v, di0, a, q, ext); break;
    case OP_LINEARCHIRP:
      op_span_hi<OP_LINEARCHIRP, N>(v, di0, a, q, ext);
      break;
    case OP_COSH: op_span_hi<OP_COSH, N>(v, di0, a, q, ext); break;
    case OP_SINH: op_span_hi<OP_SINH, N>(v, di0, a, q, ext); break;
    case OP_DRAG: op_span_hi<OP_DRAG, N>(v, di0, a, q, ext); break;
    case OP_POLY_GAUSS: op_span_hi<OP_POLY_GAUSS, N>(v, di0, a, q, ext); break;
    case OP_MOLLIFIER: op_span_hi<OP_MOLLIFIER, N>(v, di0, a, q, ext); break;
    case OP_DRAG_SIN:
    case OP_DRAG_SINX:
#pragma unroll
      for (int j = 0; j < N; ++j)
        v[j] = drag_sin_like_hi_inl(wrap_add(di0, j), a, q, ext,
                                    op == OP_DRAG_SINX);
      break;
    default:
#pragma unroll
      for (int j = 0; j < N; ++j)
        v[j] = __longlong_as_double(0x7ff8000000000000LL);
  }
}

// The tile walker for samples [idx0, idx0 + N) of (channel c, bucket b) over
// slots [s0, s1): acc[j] is what walk_sample_hi returns for sample idx0 + j.
template <int N>
__device__ __forceinline__ void walk_tile_hi(const DescHi& d, int c, int b,
                                             int s0, int s1, long long idx0,
                                             double* acc) {
  const long long row = ((long long)c * d.NB + b) * d.S;
  const float cmin = d.clip[2 * c];
  const float cmax = d.clip[2 * c + 1];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.0;
  for (int s = s0; s < s1; ++s) {
    const int nt = d.nterm[row + s];
    const long long lo = d.seg_lo[row + s], hi = d.seg_hi[row + s];
    if (nt <= 0 || idx0 >= hi || idx0 + N <= lo) continue;
    unsigned in = 0;                       // bit j: sample idx0 + j is in
#pragma unroll
    for (int j = 0; j < N; ++j)
      in |= (unsigned)(idx0 + j >= lo && idx0 + j < hi) << j;
    double seg[N];
#pragma unroll
    for (int j = 0; j < N; ++j) seg[j] = 0.0;
    for (int t = 0; t < nt; ++t) {
      const long long tf = (row + s) * d.T + t;
      double prod[N];
      const double amp = d.amp[tf];
#pragma unroll
      for (int j = 0; j < N; ++j) prod[j] = amp;
      const int nf = d.nfac[tf];
      for (int f = 0; f < nf; ++f) {
        const long long ff = tf * d.F + f;
        const int di0 = (int)((uint32_t)idx0 - (uint32_t)d.shift_hi[ff]);
        const int p = d.power[ff];
        double v[N];
        factor_span_hi<N>(v, d.op[ff], di0, d.args + ff * W_ARGS,
                          d.q32 + ff * 4, d.ext);
#pragma unroll
        for (int j = 0; j < N; ++j)
          prod[j] = prod[j] * raise_power_hi(v[j], p);
      }
#pragma unroll
      for (int j = 0; j < N; ++j) seg[j] = seg[j] + prod[j];
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      // clip at the f32 rails, as walk_sample_hi; outside the segment the
      // sample adds nothing (a select: no NaN or inf leaks)
      const float h = (float)seg[j];
      double x = seg[j];
      if (h > cmax) x = (double)cmax;
      else if (h < cmin) x = (double)cmin;
      acc[j] = (in >> j) & 1u ? acc[j] + x : acc[j];
    }
  }
}

// shared-memory word of tile sample i: one pad word per 32 doubles
__device__ __forceinline__ int staged_hi(int i) { return i + (i >> 5); }

__global__ void __launch_bounds__(HI_THREADS, HI_MINB)
synth_dense_hi_kernel(DescHi d, int tile, int sub, void* out, float* lo,
                      int out_kind) {
  __shared__ double sx[HI_SUB + HI_SUB / 32];
  __shared__ int range[HI_SUBS][2];
  const int c = blockIdx.y;
  const long long base = (long long)blockIdx.x * tile;
  const int b = d.NB > 1
      ? (int)min(base / d.bucket_samples, (long long)(d.NB - 1)) : 0;
  const long long row = ((long long)c * d.NB + b) * d.S;
  // every pass's slots at once, one warp per pass
  const int n_sub = tile / sub, n_warps = (blockDim.x + 31) >> 5;
  for (int k = threadIdx.x >> 5; k < n_sub; k += n_warps)
    segment_range(d.seg_hmax + row, d.seg_lo + row, d.S, base + k * sub,
                  base + (k + 1) * sub, range[k]);
  __syncthreads();
  // From here each warp runs on alone: its lanes' samples of each pass are
  // [w0, w0 + 32 * HI_N), staged in its own part of sx.  (A pass has at
  // least 128 samples, so every warp is whole.)
  const int lane = threadIdx.x & 31, w0 = (threadIdx.x & ~31) * HI_N;
  for (int k = 0; k < n_sub; ++k) {
    const long long sb = base + (long long)k * sub;
    if (sb >= d.n_samples) break;
    const long long end = min(sb + sub, d.n_samples);
    const long long row_out = (long long)c * d.n_samples + sb;
    if (range[k][0] >= range[k][1]) {    // no segment meets the pass: zeros
      for (int i = w0 + lane; i < w0 + 32 * HI_N && sb + i < end; i += 32)
        store_hi(out, lo, row_out + i, 0.0, out_kind);
      continue;
    }
    const int i0 = threadIdx.x * HI_N;
    if (sb + i0 < end) {
      double acc[HI_N];
      walk_tile_hi<HI_N>(d, c, b, range[k][0], range[k][1], sb + i0, acc);
#pragma unroll
      for (int j = 0; j < HI_N; ++j) sx[staged_hi(i0 + j)] = acc[j];
    }
    __syncwarp();
    for (int i = w0 + lane; i < w0 + 32 * HI_N && sb + i < end; i += 32)
      store_hi(out, lo, row_out + i, sx[staged_hi(i)], out_kind);
    __syncwarp();                          // the staging is reused
  }
}

}  // namespace wfsynth

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `tile`, a
// power of two of at least 128 that divides bucket_samples, bounds the
// kernel's own HI_TILE.
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
  if (tile < 128 || (tile & (tile - 1))) return (int)cudaErrorInvalidValue;
  tile = min(tile, wfsynth::HI_TILE);
  // a grid too small to fill the card (a short table's schedule) takes
  // smaller tiles, down to two warps' samples
  while (tile > 64 * wfsynth::HI_N &&
         (n_samples + tile - 1) / tile * C < wfsynth::MIN_DENSE_BLOCKS)
    tile /= 2;
  const int sub = min(tile, wfsynth::HI_SUB);
  const int threads = sub / wfsynth::HI_N;
  const long long n_tiles = (n_samples + tile - 1) / tile;
  if (n_tiles > 0 && C > 0) {
    dim3 grid((unsigned)n_tiles, (unsigned)C);
    wfsynth::synth_dense_hi_kernel<<<grid, threads, 0,
                                     (cudaStream_t)stream>>>(
        d, tile, sub, out, lo, out_kind);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
