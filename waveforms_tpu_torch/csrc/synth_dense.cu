// Dense grid synthesis kernel (K1).
//
// Replaces the TPU kernel waveforms_tpu/ops/pallas_synth.py:_synth_kernel
// (launched by _run_kernel, with its XLA searchsorted prologue).  It computes
// what that kernel computes, not its block structure: every sample of every
// channel is the sum over its bucket's segments that contain it of
// clip(sum_t amp_t * prod_f factor_f), accumulated in f32 and stored as f32,
// as bf16 or f16 (rounded once), or as int16 DAC codes
// clip(round_half_even(acc * scale)), or, in pair mode (part='complex', the
// JAX kernel's pair=True), as complex64: one pass over the factor products
// scaled by both amplitude planes.
//
// The window: the launch writes samples [row0, row0 + n_out) of the
// schedule, sample row0 + i at column i of a (C, n_out) output -- the TPU
// kernel's global offset row0 and its n_rows * 128 (_run_kernel), which a
// time-axis shard or a streamed chunk (ops/streaming.py) takes.  Tiles are
// placed from row0, which the wrapper keeps a multiple of the tile, so a
// tile still never straddles a bucket and each tile's bucket (and so its
// segment lookup) is that of its global samples.  row0 = 0 with n_out =
// n_samples is the whole schedule, as every other caller launches it.  The
// kernel works in the window's coordinates and adds row0 only where a
// global sample index is read (the bucket, the segment lookup, the walk),
// and a launch at row0 = 0 runs the instantiation whose offset is the
// constant 0 (WIN = false): carrying the offset at run time there cost the
// dense occupancy-1 cell 2.3% on the H100, with bit-identical output.
//
// A time shard of a mesh (parallel/mesh.py) holds only its own slice of
// the bucket axis, buckets [bucket0, bucket0 + NB): its tiles read local
// bucket clamp(global bucket - bucket0, 0, NB - 1), as the TPU tile reads
// its local bucket by program id and its time from row0.  bucket0 rides
// with the window (WIN = true); a launch at row0 = 0 and bucket0 = 0 has
// neither.
//
// Layout: one thread block of DENSE_THREADS per (tile, channel), a tile
// being up to DENSE_SUBS passes of N * DENSE_THREADS samples (N samples per
// thread).  Tiles never straddle a bucket: the wrapper picks a tile that
// divides bucket_samples.  The block's warps first find every pass's
// segment range [s0, s1) -- the prologue that the TPU ran as plain XLA --
// one warp per pass, in rounds of one load per lane (segment_range).  A
// pass that no segment meets is stored as zeros at once; so a pulse-sparse
// schedule costs its zero stores and little else, and the range lookups of
// a whole tile overlap.
//
// The tile walker (walk_tile), the TPU kernel's _tile_walker turned inside
// out for this card: each thread owns DENSE_N consecutive samples of a
// pass, holds their accumulators in registers, and walks the pass's
// segments, their terms and their factors in an outer loop, reading each
// descriptor word once per factor for all its samples.  Inside, one switch
// per factor (factor_span, synth_span.cuh, shared with K5 and K6) picks the
// opcode and evaluates it over the DENSE_N samples:
// DENSE_N independent chains of transcendental math that overlap, where
// the per-sample walker (walk_sample, kept for K2 alone) re-read the
// whole dependent descriptor chain (segment -> terms -> factors -> opcode
// -> args) and switched once per sample.  A thread skips a segment that
// none of its samples is in; within one, samples outside [lo, hi) are
// evaluated and then dropped by a select (never a multiply: their values
// may be NaN or inf), so each sample adds exactly what walk_sample adds, in
// the same order -- segments, terms and factors ascending, prod from amp
// (1.0 in pair mode), seg clipped, then added -- and the output is
// bit-identical to the per-sample walker's.  The multi-tone DRAG bodies
// stay out of line (drag_sin_like_ool).
//
// The tile walker lives in synth_span.cuh, shared with the worklist kernel
// K7 and its probe P1 (synth_item.cuh).  A pass's samples go through shared
// memory (padded one word in 32, so neither side has bank conflicts) and are
// stored by consecutive threads at consecutive samples, coalesced, in every
// output kind.
//
// What bounds it on the H100: on an occupancy-1 schedule (every sample in a
// chirp x gaussian product) the per-sample transcendental math, now that the
// descriptor walk is paid once per DENSE_N samples; on a pulse-sparse one,
// the zero stores.  128 threads of 8 samples keep the registers (96) low
// enough for five blocks per SM with no spill.  A launch too small to fill
// the card (a short table's schedule, a few hundred thousand samples) is
// bound by its slowest block's chain instead: it runs with 4 samples per
// thread on smaller tiles (launch_dense).
//
// The shot entry (wf_synth_dense_shots): one launch for a shot vector ks
// over a sequence table of K schedules (ops/sequencer.Sequencer), as the
// TPU ran jax.vmap of play over the schedule index (one batched launch).
// The descriptors are the table's (K, C, NB, S, ...) tensors, read as one
// table of K * C channels: schedule j's channel c is channel j * C + c.
// The shot axis is folded into the grid's x axis, shot-major (gridDim.y is
// the channel, and neither y nor z holds 8 flagship shots' 2,000 tiles, let
// alone a long shot vector): block x = shot * n_tiles + tile.  Each block
// reads ks[shot] from device memory and clamps it to [0, K - 1] itself (the
// JAX gather's mode='clip'), so the host never reads the index, and stores
// into out[shot] of a (n_shots, C, N) output.  The layout (samples a
// thread, tile) is the one a one-shot launch of C channels picks, and each
// tile walks as there, so each shot is bit-identical to a one-shot launch
// of its schedule.
#include "synth_span.cuh"

namespace wfsynth {

// The layout.  A grid of fewer than MIN_DENSE_BLOCKS tiles (a short table's
// schedule: the walker's per-thread chain, not the card's width, sets its
// time) runs with DENSE_N_SMALL samples per thread.
constexpr int DENSE_N = 8;           // samples per thread
constexpr int DENSE_N_SMALL = 4;     // the same, small grids
constexpr int DENSE_THREADS = 128;   // threads per block
constexpr int DENSE_SUBS = 8;        // passes per tile
// samples per block: DENSE_SUBS passes of N * DENSE_THREADS samples
constexpr int DENSE_TILE = DENSE_N * DENSE_THREADS * DENSE_SUBS;
// walk_tile's in-segment mask is one bit per sample of an unsigned; the
// warp-wide range lookups and stores want whole warps
static_assert(DENSE_N <= 32 && DENSE_N_SMALL <= 32, "mask is 32 bits");
static_assert(DENSE_THREADS % 32 == 0, "whole warps");

// One block's tile, walked one pass after another: every pass's segment
// range at once (one warp a pass), then each pass walked into the staging,
// or zero-filled where no segment meets it, and stored.  row0 is the
// window's first sample in the schedule and bucket0 the shard's first
// bucket (WIN); the descriptors' channel dc(), the tile's first sample in
// the window base() and the output row's first element orow() are
// accessors: synth_dense_kernel derives them from blockIdx, the shot
// entry's kernel reads them from shared memory.  A value live across the
// walk (the multi-tone DRAG bodies' out-of-line call) beyond the few
// registers the call preserves is spilled around it.  With RELOAD the
// pass's first sample, end and output row are read from the accessors
// again after the walk's barrier, so none of them is live across it (the
// shot entry's layout); without, they are kept from before the walk (the
// one-shot kernel's, whose accessors cost nothing but at 4 samples a
// thread spill 36 bytes when re-derived).  Each layout is the one for which
// ptxas -v reports no spill (sm_90a, nvcc 12.9).
template <bool PAIR, int N, bool WIN, bool RELOAD, class DescC, class Base,
          class Row>
__device__ __forceinline__ void dense_tile_passes(
    const Desc& d, long long row0, long long bucket0, long long n_out,
    int tile, int sub, void* out, int out_kind, const float* scale, int c,
    DescC dc, Base base, Row orow, float* sx, float* sy, int (*range)[2]) {
  int b = 0;
  if (d.NB > 1) {        // one bucket: no 64-bit division in the prologue
    long long gb = (row0 + base()) / d.bucket_samples;  // the global bucket
    if (WIN) gb = max(gb - bucket0, 0LL);      // the shard's local one
    b = (int)min(gb, (long long)(d.NB - 1));
  }
  {
    const long long gbase = row0 + base();                 // in the schedule
    const long long row = ((long long)(dc()) * d.NB + b) * d.S;
    const int n_sub = tile / sub, n_warps = (blockDim.x + 31) >> 5;
    for (int k = threadIdx.x >> 5; k < n_sub; k += n_warps)
      segment_range(d.seg_hmax + row, d.seg_lo + row, d.S, gbase + k * sub,
                    gbase + (k + 1) * sub, range[k]);
  }
  __syncthreads();
  const float sc = out_kind == OUT_I16 ? scale[c] : 1.0f;
  const int n_sub = tile / sub;
  for (int k = 0; k < n_sub; ++k) {
    const long long sb = (base()) + (long long)k * sub;
    if (sb >= n_out) break;
    const long long end = min(sb + sub, n_out);
    const long long row_out = (orow()) + sb;
    if (range[k][0] >= range[k][1]) {    // no segment meets the pass: zeros
      for (int i = threadIdx.x; sb + i < end; i += blockDim.x)
        store_walk<PAIR>(out, row_out + i, make_float2(0.0f, 0.0f),
                         out_kind, sc);
      continue;
    }
    const int i0 = threadIdx.x * N;
    if (sb + i0 < end) {
      float acc[N], acc_im[N];
      walk_tile<PAIR, N>(d, dc(), b, range[k][0], range[k][1], row0 + sb + i0,
                         acc, acc_im);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        sx[staged(i0 + j)] = acc[j];
        if (PAIR) sy[staged(i0 + j)] = acc_im[j];
      }
    }
    __syncthreads();
    {
      const long long sb2 = RELOAD ? (base()) + (long long)k * sub : sb;
      const long long end2 = RELOAD ? min(sb2 + sub, n_out) : end;
      const long long row2 = RELOAD ? (orow()) + sb2 : row_out;
      for (int i = threadIdx.x; sb2 + i < end2; i += blockDim.x)
        store_walk<PAIR>(out, row2 + i,
                         make_float2(sx[staged(i)],
                                     PAIR ? sy[staged(i)] : 0.0f),
                         out_kind, sc);
    }
    __syncthreads();                       // the staging is reused
  }
}

template <bool PAIR, int N, bool WIN>
__global__ void __launch_bounds__(DENSE_THREADS)
synth_dense_kernel(Desc d, long long row0_arg, long long bucket0,
                   long long n_out, int tile, int sub, void* out, int out_kind,
                   const float* scale) {
  constexpr int SUB = N * DENSE_THREADS;  // samples per pass
  __shared__ float sx[SUB + SUB / 32];
  __shared__ float sy[PAIR ? SUB + SUB / 32 : 1];
  __shared__ int range[DENSE_SUBS][2];
  const int c = blockIdx.y;
  dense_tile_passes<PAIR, N, WIN, false>(
      d, WIN ? row0_arg : 0, bucket0, n_out, tile, sub, out, out_kind, scale,
      c, [=] { return c; }, [=] { return (long long)blockIdx.x * tile; },
      [=] { return (long long)c * n_out; }, sx, sy, range);
}

// The shot entry's index: ks (n_shots,) int32 on the device over a table of
// K schedules, and the tiles of one shot
struct Shots {
  const int* ks;
  int K;
  int n_tiles;
};

// The shot entry's kernel (wf_synth_dense_shots): block x = shot * n_tiles +
// tile, y = channel.  Thread 0 reads ks[shot], clamps it, and puts the
// descriptors' channel, the tile's first sample and the output row's first
// element in shared memory, and the walk reads them back from there after
// each barrier (RELOAD), so that none is live across the walk.  In pair
// mode at DENSE_N samples a thread that spills instead, and the tile's
// first sample and the output row stay in registers (HOLD): each
// instantiation takes the layout for which ptxas -v reports no spill
// (sm_90a, nvcc 12.9).
template <bool PAIR, int N>
__global__ void __launch_bounds__(DENSE_THREADS)
synth_dense_shots_kernel(Desc d, long long n_out, int tile, int sub,
                         void* out, int out_kind, const float* scale,
                         Shots shots) {
  constexpr bool HOLD = PAIR && N == DENSE_N;
  constexpr int SUB = N * DENSE_THREADS;  // samples per pass
  __shared__ float sx[SUB + SUB / 32];
  __shared__ float sy[PAIR ? SUB + SUB / 32 : 1];
  __shared__ int range[DENSE_SUBS][2];
  __shared__ long long shot_at[2];
  __shared__ int shot_dc;
  const int c = blockIdx.y;
  if (threadIdx.x == 0) {
    const int shot = blockIdx.x / shots.n_tiles;
    int sched = shots.ks[shot];
    sched = sched < 0 ? 0 : (sched >= shots.K ? shots.K - 1 : sched);
    shot_dc = sched * d.C + c;
    shot_at[0] = (long long)(blockIdx.x - shot * shots.n_tiles) * tile;
    shot_at[1] = ((long long)shot * d.C + c) * n_out;
  }
  __syncthreads();
  const auto dc = [&] { return shot_dc; };
  if constexpr (HOLD) {
    const long long base = shot_at[0];
    const long long orow = shot_at[1];
    dense_tile_passes<PAIR, N, false, true>(
        d, 0, 0, n_out, tile, sub, out, out_kind, scale, c, dc,
        [=] { return base; }, [=] { return orow; }, sx, sy, range);
  } else {
    dense_tile_passes<PAIR, N, false, true>(
        d, 0, 0, n_out, tile, sub, out, out_kind, scale, c, dc,
        [&] { return shot_at[0]; }, [&] { return shot_at[1]; }, sx, sy,
        range);
  }
}

// Launch K1 with N samples per thread over the window [row0, row0 + n_out)
// of a schedule whose bucket axis starts at bucket0: `tile` (a power of two
// of at least 128 that divides bucket_samples and row0) bounded by N's
// tile, and halved while the grid is too small to fill the card, down to
// two warps' samples.  With shots.ks, the whole of each of n_shots
// schedules of a table (row0 = bucket0 = 0), each laid out as that launch.
template <int N>
static int launch_dense(const Desc& d, long long row0, long long bucket0,
                        long long n_out, int tile, void* out, int out_kind,
                        const float* scale, cudaStream_t st,
                        Shots shots = Shots{nullptr, 0, 0}, int n_shots = 1) {
  tile = min(tile, N * DENSE_THREADS * DENSE_SUBS);
  while (tile > 64 * N && (n_out + tile - 1) / tile * d.C < MIN_DENSE_BLOCKS)
    tile /= 2;
  const int sub = min(tile, N * DENSE_THREADS);
  const long long n_tiles = (n_out + tile - 1) / tile;
  if (n_tiles * n_shots > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0 && d.C > 0 && n_shots > 0) {
    dim3 grid((unsigned)(n_tiles * n_shots), (unsigned)d.C);
    const bool win = row0 || bucket0;
    const int threads = sub / N;
    if (shots.ks) {
      shots.n_tiles = (int)n_tiles;
      if (out_kind == OUT_C64)
        synth_dense_shots_kernel<true, N><<<grid, threads, 0, st>>>(
            d, n_out, tile, sub, out, out_kind, scale, shots);
      else
        synth_dense_shots_kernel<false, N><<<grid, threads, 0, st>>>(
            d, n_out, tile, sub, out, out_kind, scale, shots);
    } else if (out_kind == OUT_C64 && win)
      synth_dense_kernel<true, N, true><<<grid, threads, 0, st>>>(
          d, row0, bucket0, n_out, tile, sub, out, out_kind, scale);
    else if (out_kind == OUT_C64)
      synth_dense_kernel<true, N, false><<<grid, threads, 0, st>>>(
          d, row0, bucket0, n_out, tile, sub, out, out_kind, scale);
    else if (win)
      synth_dense_kernel<false, N, true><<<grid, threads, 0, st>>>(
          d, row0, bucket0, n_out, tile, sub, out, out_kind, scale);
    else
      synth_dense_kernel<false, N, false><<<grid, threads, 0, st>>>(
          d, row0, bucket0, n_out, tile, sub, out, out_kind, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace wfsynth

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a window or tile the kernel does not take.
// Samples [row0, row0 + n_out) go to a (C, n_out) output; row0 is a
// multiple of `tile`, and the window ends at most at n_samples rounded up
// to whole 128-sample rows.  `tile`, a power of two of at least 128 that
// divides bucket_samples, bounds the kernel's own DENSE_TILE.  The NB
// buckets of the descriptors are the schedule's buckets [bucket0, bucket0 +
// NB) (a time shard's slice; 0 for a whole schedule).
int wf_synth_dense_shard(const int* seg_lo, const int* seg_hi,
                         const int* seg_hmax, const int* nterm,
                         const int* nfac, const float* amp, const int* op,
                         const int* power, const int* shift_hi,
                         const int* q32, const float* args, const float* ext,
                         const float* clip, const float* amp_im, int C,
                         int NB, int S, int T, int F, long long n_samples,
                         long long bucket_samples, long long row0,
                         long long n_out, long long bucket0, int tile,
                         void* out, int out_kind, const float* scale,
                         void* stream) {
  wfsynth::Desc d{seg_lo, seg_hi, seg_hmax, nterm, nfac, amp, op, power,
                  shift_hi, q32, args, ext, clip, amp_im, C, NB, S, T, F,
                  n_samples, bucket_samples};
  if (tile < 128 || (tile & (tile - 1)) || row0 < 0 || row0 % tile ||
      n_out < 0 || row0 + n_out > (n_samples + 127) / 128 * 128 ||
      bucket0 < 0)
    return (int)cudaErrorInvalidValue;
  tile = min(tile, wfsynth::DENSE_TILE);
  cudaStream_t st = (cudaStream_t)stream;
  if ((n_out + tile - 1) / tile * C < wfsynth::MIN_DENSE_BLOCKS)
    return wfsynth::launch_dense<wfsynth::DENSE_N_SMALL>(
        d, row0, bucket0, n_out, tile, out, out_kind, scale, st);
  return wfsynth::launch_dense<wfsynth::DENSE_N>(
      d, row0, bucket0, n_out, tile, out, out_kind, scale, st);
}

// The same over a whole bucket axis (bucket0 = 0): the C interface that
// builds of this kernel have had since the window, kept so that an A/B
// against an earlier build (tools/ab_dense.py) calls both alike.
int wf_synth_dense(const int* seg_lo, const int* seg_hi, const int* seg_hmax,
                   const int* nterm, const int* nfac, const float* amp,
                   const int* op, const int* power, const int* shift_hi,
                   const int* q32, const float* args, const float* ext,
                   const float* clip, const float* amp_im, int C, int NB,
                   int S, int T, int F, long long n_samples,
                   long long bucket_samples, long long row0,
                   long long n_out, int tile, void* out, int out_kind,
                   const float* scale, void* stream) {
  return wf_synth_dense_shard(seg_lo, seg_hi, seg_hmax, nterm, nfac, amp, op,
                              power, shift_hi, q32, args, ext, clip, amp_im,
                              C, NB, S, T, F, n_samples, bucket_samples, row0,
                              n_out, 0, tile, out, out_kind, scale, stream);
}

// The shot entry: out (n_shots, C, n_samples) holds schedule clamp(ks[s],
// 0, K - 1) of a table of K schedules at shot s.  The descriptors are the
// table's (K, C, NB, S, ...) tensors (C channels a schedule), ks (n_shots,)
// int32 on the device.  `tile` as wf_synth_dense_shard's.  Launch on
// `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a tile, table or grid the kernel does not take.
int wf_synth_dense_shots(const int* seg_lo, const int* seg_hi,
                         const int* seg_hmax, const int* nterm,
                         const int* nfac, const float* amp, const int* op,
                         const int* power, const int* shift_hi,
                         const int* q32, const float* args, const float* ext,
                         const float* clip, const float* amp_im, int C,
                         int NB, int S, int T, int F, long long n_samples,
                         long long bucket_samples, const int* ks, int K,
                         int n_shots, int tile, void* out, int out_kind,
                         const float* scale, void* stream) {
  wfsynth::Desc d{seg_lo, seg_hi, seg_hmax, nterm, nfac, amp, op, power,
                  shift_hi, q32, args, ext, clip, amp_im, C, NB, S, T, F,
                  n_samples, bucket_samples};
  if (tile < 128 || (tile & (tile - 1)) || K < 1 || n_shots < 0 ||
      (n_shots > 0 && ks == nullptr) || (long long)K * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  tile = min(tile, wfsynth::DENSE_TILE);
  cudaStream_t st = (cudaStream_t)stream;
  const wfsynth::Shots shots{ks, K, 0};
  if ((n_samples + tile - 1) / tile * C < wfsynth::MIN_DENSE_BLOCKS)
    return wfsynth::launch_dense<wfsynth::DENSE_N_SMALL>(
        d, 0, 0, n_samples, tile, out, out_kind, scale, st, shots, n_shots);
  return wfsynth::launch_dense<wfsynth::DENSE_N>(
      d, 0, 0, n_samples, tile, out, out_kind, scale, st, shots, n_shots);
}

const char* wf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
