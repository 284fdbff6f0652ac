// The worklist item walker: the body of the worklist kernel K7
// (synth_sparse.cu) and of its probe P1 (probes.cu, probe_sparse_compact),
// one device function for both, so that P1 prices the step K7 ships.
//
// A worklist item names one Rs x 128 subtile of one channel: its bucket, its
// absolute sample base, its output subtile and its segment range [s0, s1).
// The subtile is cut into passes of ITEM_N * ITEM_THREADS samples, one
// thread block each: items on blockIdx.x (a worklist at Rs 1 can have more
// than the 65,535 blocks gridDim.y allows) and passes on blockIdx.y.
// Thread 0 reads the item's six scalars once for the block.  In its pass
// each thread makes one walk_tile
// (synth_span.cuh, K1's tile walker) over its ITEM_N consecutive samples,
// reading each factor's descriptors once for all of them, skipping the
// segments none of them is in, and dropping a sample outside a segment by a
// select -- so every sample is what walk_sample gives, bit for bit, as in
// K1.  The pass goes through shared memory (padded one word in 32) and is
// stored by consecutive threads at consecutive samples in every output kind,
// zeros included, masked at the item's end (a ragged last pass, Rs * 128
// not a multiple of the pass) and at the window's end.
#pragma once

#include "synth_span.cuh"

namespace wfsynth {

// The layout: ITEM_N samples a thread, ITEM_THREADS threads a block (one
// pass of ITEM_PASS samples), and at least ITEM_MIN_BLOCKS thread blocks an
// SM, ITEM_MIN_BLOCKS_PAIR in pair mode (the register bound of
// __launch_bounds__: left to itself, ptxas gives this walker up to 167
// registers, three blocks an SM)
constexpr int ITEM_N = 8;
constexpr int ITEM_THREADS = 128;
constexpr int ITEM_MIN_BLOCKS = 5;
constexpr int ITEM_MIN_BLOCKS_PAIR = 4;
constexpr int ITEM_PASS = ITEM_N * ITEM_THREADS;
constexpr int STAGED_PASS = ITEM_PASS + ITEM_PASS / 32;  // padded, staged()
static_assert(ITEM_N <= 32, "walk_tile's mask is 32 bits");
static_assert(ITEM_THREADS % 32 == 0, "whole warps");

// A worklist's int32 columns; o is null where the output map is compact
// (item k at output block k, P1)
struct Worklist {
  const int* c;
  const int* b;
  const int* t;
  const int* o;
  const int* s0;
  const int* s1;
};

// Passes (thread blocks along gridDim.y) of a subtile of Rs x 128 samples
inline long long item_blocks_y(int Rs) {
  return ((long long)Rs * 128 + ITEM_PASS - 1) / ITEM_PASS;
}

// The item's scalars in shared memory: channel, bucket, subtile, output
// subtile, slots [s0, s1)
enum ItemWord : int { I_C = 0, I_B, I_T, I_O, I_S0, I_S1, I_WORDS };

// Samples of the item's subtile that are stored: all of them in the compact
// map, else those inside the window
template <bool COMPACT>
__device__ __forceinline__ int item_samples(const int* item, int Rs,
                                            long long window) {
  const long long tile = (long long)Rs * 128;
  return COMPACT ? (int)tile
                 : (int)min(tile, window - (long long)item[I_O] * tile);
}

// One pass's walk: the thread's ITEM_N samples from pass sample p0 + i0,
// staged in sx (and sy in pair mode)
template <bool PAIR, bool COMPACT>
__device__ __forceinline__ void walk_pass(const Desc& d, const int* item,
                                          int dc, int Rs, long long window,
                                          int p0, float* sx, float* sy) {
  const int i0 = threadIdx.x * ITEM_N;
  if (p0 + i0 >= item_samples<COMPACT>(item, Rs, window)) return;
  float acc[ITEM_N], acc_im[ITEM_N];
  walk_tile<PAIR, ITEM_N>(d, dc + item[I_C], item[I_B], item[I_S0],
                          item[I_S1],
                          (long long)item[I_T] * Rs * 128 + p0 + i0, acc,
                          acc_im);
#pragma unroll
  for (int j = 0; j < ITEM_N; ++j) {
    sx[staged(i0 + j)] = acc[j];
    if (PAIR) sy[staged(i0 + j)] = acc_im[j];
  }
}

// One pass's stores from the staging: consecutive threads at consecutive
// samples, masked at the item's (and the window's) end; out0 is the first
// element of the item's shot in the output
template <bool PAIR, bool COMPACT>
__device__ __forceinline__ void store_pass(const int* item, int Rs,
                                           long long window, int p0,
                                           void* out, long long out0,
                                           int out_kind, const float* scale,
                                           const float* sx, const float* sy) {
  const long long tile = (long long)Rs * 128;
  const long long pos = COMPACT
      ? (long long)blockIdx.x * tile
      : out0 + (long long)item[I_C] * window + (long long)item[I_O] * tile;
  const int n = item_samples<COMPACT>(item, Rs, window);
  const float sc = out_kind == OUT_I16 ? scale[item[I_C]] : 1.0f;
  for (int i = threadIdx.x; i < ITEM_PASS && p0 + i < n; i += ITEM_THREADS)
    store_walk<PAIR>(out, pos + p0 + i,
                     make_float2(sx[staged(i)], PAIR ? sy[staged(i)] : 0.0f),
                     out_kind, sc);
}

// Pass blockIdx.y of worklist item k.  COMPACT (P1): item k's subtile
// at out[k * tile, (k + 1) * tile), f32, padding items (an empty segment
// range) included, as zeros.  Otherwise (K7): item k's subtile at
// out[out0 + c * window + o * tile], masked at the window's end, and a
// padding item (o >= n_tiles) returns at once.  The descriptors are read at
// channel dc + c: a table of several schedules stacked along the channel
// axis (K7's shot entry) holds schedule j's channels from dc = j * C.  Only
// thread 0 reads the worklist, before the first barrier.  The
// item's scalars are read from shared memory again after each barrier, so
// that none of them is live across the walk.
template <bool PAIR, bool COMPACT>
__device__ __forceinline__ void walk_item(const Desc& d, const Worklist& w,
                                          int k, int dc, long long out0,
                                          int Rs, int n_tiles,
                                          long long window, void* out,
                                          int out_kind, const float* scale) {
  __shared__ int item[I_WORDS];
  __shared__ float sx[STAGED_PASS];
  __shared__ float sy[PAIR ? STAGED_PASS : 1];
  if (threadIdx.x == 0) {
    item[I_C] = w.c[k];
    item[I_B] = w.b[k];
    item[I_T] = w.t[k];
    item[I_O] = COMPACT ? k : w.o[k];
    item[I_S0] = w.s0[k];
    item[I_S1] = w.s1[k];
  }
  __syncthreads();
  if (!COMPACT && item[I_O] >= n_tiles) return;        // padding item
  const int p0 = blockIdx.y * ITEM_PASS;
  if (p0 >= item_samples<COMPACT>(item, Rs, window)) return;
  walk_pass<PAIR, COMPACT>(d, item, dc, Rs, window, p0, sx, sy);
  __syncthreads();
  store_pass<PAIR, COMPACT>(item, Rs, window, p0, out, out0, out_kind, scale,
                            sx, sy);
}

}  // namespace wfsynth
