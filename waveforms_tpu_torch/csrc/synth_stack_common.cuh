// Shared device code of the pulse-instance kernels: the stack kernel K5
// (synth_stack.cu) and its sequenced twin K6 (synth_stack_seq.cu).
//
// Both fill CTA_CHUNKS consecutive chunks (of CHUNK_ROWS 128-sample rows) of
// one channel per thread block from a CSR block list of instance tables
// (ops/stack_synth.StackTables): stack_rows.  The functions are
// force-inlined, so each kernel compiles to the code it would have with the
// loops written in place.
//
// Rows in registers.  A warp owns whole rows (rows warp, warp + STACK_WARPS,
// ...), and lane l holds samples [4l, 4l + 4) of a row in four registers.
// For each of its rows the warp finds the blocks on that row, in
// table order (a ballot over the block list), evaluates each block's
// instance over its four samples -- one factor_span<4> per factor, so each
// descriptor word is read once per 4 samples -- and then stores the row
// straight to device memory: one 16-byte f32 vector, or one 8-byte vector
// of int16 codes or bf16 / f16 words, per lane.  A row that no block touches
// is stored as zeros at once.  There is no shared tile to zero and read
// back, so registers, not shared memory, set how many blocks an SM holds.
// Four chunks a thread block give its warps about four times the rows that
// a block touches to walk while they share one staging.
//
// Descriptors staged in shared memory.  Before the walk the thread block
// copies its block list (blk_row, blk_inst) and then the descriptors
// of the instances that list names (inst, amp, term_nfac, op, power,
// shift_hi, q32, args) into shared memory with cp.async, every copy in
// flight at once; the zero rows are stored while the descriptors arrive.
// A run of consecutive blocks of one instance -- the blocks of one pulse,
// as build_stack_tables lays them out -- shares one staging slot, so each
// instance is read from device memory once per thread block, not once per
// block.  A thread block of more than STAGE_BLOCKS blocks, or whose
// instances need more than STAGE_WORDS words, walks the same way with the
// descriptors (and, past STAGE_BLOCKS, the block list) read from device
// memory in place: the same code through generic pointers, so nothing is
// refused.
//
// The sum is the one a shared-memory tile walk makes, bit for bit: each
// sample adds its row's blocks in table order, each the sum over its instance's
// terms of amp_t * prod_f factor_f ** power_f (seg = prod for the first
// term, seg + prod after), masked to [lo, hi) by a select, into an f32
// accumulator that starts at 0.  A sample outside [lo, hi) is evaluated and
// dropped, never multiplied in: its value may be NaN or inf.
#pragma once

#include "synth_span.cuh"

namespace wfsynth {

constexpr int CHUNK_ROWS = 64;      // == ops/stack_synth.CHUNK_ROWS
constexpr int ROW = 128;            // samples per row: one block's span
constexpr int ROW_N = 4;            // samples per lane
constexpr int STACK_WARPS = 4;      // warps per thread block
constexpr int STACK_THREADS = 32 * STACK_WARPS;
constexpr int STACK_MIN_BLOCKS = 5; // thread blocks an SM holds (registers)
constexpr int CTA_CHUNKS = 4;       // == ops/stack_synth.CTA_CHUNKS
constexpr int CTA_ROWS = CTA_CHUNKS * CHUNK_ROWS;
constexpr int STAGE_BLOCKS = 256;   // == ops/stack_synth.STAGE_BLOCKS
constexpr int STAGE_WORDS = 8192;   // == ops/stack_synth.STAGE_WORDS
static_assert(ROW == 32 * ROW_N && ROW_N == 4, "a warp holds a row, 4 a lane");
static_assert(CHUNK_ROWS % 32 == 0, "one mask word per 32 rows");

// thread blocks per channel: CTA_CHUNKS consecutive chunks each
__host__ __device__ __forceinline__ int chunk_groups(int n_chunks) {
  return (n_chunks + CTA_CHUNKS - 1) / CTA_CHUNKS;
}
constexpr unsigned FULL = 0xffffffffu;

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

// The per-instance descriptors of StackDesc, row-major with its NT and TF:
// in device memory (indexed by instance) or staged in shared memory
// (indexed by the chunk's slot)
struct StackView {
  const int* inst;
  const float* amp;
  const int* term_nfac;
  const int* op;
  const int* power;
  const int* shift_hi;
  const int* q32;
  const float* args;
};

// words of one instance's descriptors in a StackView
__device__ __forceinline__ int view_words(int NT, int TF) {
  return 4 + 2 * NT + (3 + 4 + W_ARGS) * TF;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy `width` words of each slot's instance mof[s] from src (`width` words
// per instance) to dst (`width` per slot): 16 bytes a copy where `vec` (width
// a multiple of 4, both sides 16-byte aligned), else 4
__device__ __forceinline__ void stage_rows(int* dst, const int* src,
                                           int width, const int* mof,
                                           int slots, bool vec) {
  if (vec) {
    const int w4 = width >> 2;
    for (int e = threadIdx.x; e < slots * w4; e += STACK_THREADS) {
      const int s = e / w4;
      cp_async16(dst + 4 * e, src + ((long long)mof[s] * w4 + e - s * w4) * 4);
    }
  } else {
    for (int e = threadIdx.x; e < slots * width; e += STACK_THREADS) {
      const int s = e / width;
      cp_async4(dst + e, src + (long long)mof[s] * width + e - s * width);
    }
  }
}

// Add instance m's value at samples [idx0, idx0 + ROW_N) into acc, masked to
// its [lo, hi): the sum over its terms of amp_t * prod_f factor_f ** power_f
template <int N>
__device__ __forceinline__ void add_block(const StackView& v, int NT, int TF,
                                          const float* ext, int m,
                                          long long idx0, float* acc) {
  const int* im = v.inst + 4 * m;
  const long long lo = im[1], hi = im[2];
  if (idx0 >= hi || idx0 + N <= lo) return;   // none of these samples is in
  unsigned in = 0;                            // bit j: sample idx0 + j is in
#pragma unroll
  for (int j = 0; j < N; ++j)
    in |= (unsigned)(idx0 + j >= lo && idx0 + j < hi) << j;
  const int nt = im[3];
  float seg[N];
#pragma unroll
  for (int j = 0; j < N; ++j) seg[j] = 0.0f;
  int f = 0;
  for (int tt = 0; tt < nt; ++tt) {
    const float amp = v.amp[m * NT + tt];
    float prod[N];
#pragma unroll
    for (int j = 0; j < N; ++j) prod[j] = amp;
    const int nf = v.term_nfac[m * NT + tt];
    for (int jf = 0; jf < nf; ++jf, ++f) {
      const long long ff = (long long)m * TF + f;
      const int di0 = (int)((uint32_t)idx0 - (uint32_t)v.shift_hi[ff]);
      const int p = v.power[ff];
      float val[N];
      factor_span<N>(val, v.op[ff], di0, v.args + ff * W_ARGS, v.q32 + ff * 4,
                     ext);
#pragma unroll
      for (int j = 0; j < N; ++j) prod[j] = prod[j] * raise_power(val[j], p);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) seg[j] = tt == 0 ? prod[j] : seg[j] + prod[j];
  }
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = (in >> j) & 1u ? acc[j] + seg[j] : acc[j];
}

// Samples [idx0, idx0 + ROW_N) of `row`: every block of the chunk's list
// (rows[i], refs[i] for i < n) on that row, in list order.  The whole warp
// calls; lane l's samples are its own.
__device__ __forceinline__ void walk_row(const StackView& v, int NT, int TF,
                                         const float* ext, const int* rows,
                                         const int* refs, int n, int row,
                                         long long idx0, float* acc) {
  const int lane = threadIdx.x & 31;
  for (int b = 0; b < n; b += 32) {
    unsigned hit = __ballot_sync(FULL, b + lane < n && rows[b + lane] == row);
    while (hit) {
      const int i = b + __ffs(hit) - 1;
      hit &= hit - 1;
      add_block<ROW_N>(v, NT, TF, ext, refs[i], idx0, acc);
    }
  }
}

// Store samples [idx0, idx0 + ROW_N) of a channel row starting at out + base
// (masked at the channel's end): one vector of f32, int16 DAC codes
// clip(round_half_even(acc * sc)), or bf16 / f16 words (acc rounded once to
// nearest even) where n_samples is a multiple of 4, else sample by sample
__device__ __forceinline__ void store_row(void* out, long long base,
                                          long long idx0, long long n_samples,
                                          const float* acc, int out_kind,
                                          float sc) {
  if (idx0 >= n_samples) return;
  if ((n_samples & 3) == 0) {
    const long long v = (base + idx0) >> 2;   // base + idx0 is a multiple of 4
    if (out_kind == OUT_I16) {
      reinterpret_cast<short4*>(out)[v] =
          make_short4(dac_code(acc[0], sc), dac_code(acc[1], sc),
                      dac_code(acc[2], sc), dac_code(acc[3], sc));
    } else if (out_kind == OUT_BF16 || out_kind == OUT_F16) {
      reinterpret_cast<ushort4*>(out)[v] = make_ushort4(
          narrow_bits(acc[0], out_kind), narrow_bits(acc[1], out_kind),
          narrow_bits(acc[2], out_kind), narrow_bits(acc[3], out_kind));
    } else {
      reinterpret_cast<float4*>(out)[v] =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < ROW_N; ++j)
      if (idx0 + j < n_samples)
        store_sample(out, base + idx0 + j, acc[j], out_kind, sc);
  }
}

// Fill rows [row0, row0 + CTA_ROWS) of one channel -- the channel's
// samples at out + base -- with the sum of blocks [k0, k1) of t.  The whole
// thread block (STACK_THREADS) calls.
__device__ __forceinline__ void stack_rows(const StackDesc& t, int k0,
                                            int k1, long long row0,
                                            void* out, long long base,
                                            long long n_samples, int out_kind,
                                            float sc) {
  __shared__ int s_row[STAGE_BLOCKS];    // the chunk's blocks: their row,
  __shared__ int s_ref[STAGE_BLOCKS];    // their instance,
  __shared__ int s_slot[STAGE_BLOCKS];   // and its staging slot
  __shared__ int s_mof[STAGE_BLOCKS];    // each slot's instance
  __shared__ __align__(16) int s_desc[STAGE_WORDS];
  __shared__ unsigned s_busy[CTA_ROWS / 32];   // rows that a block touches
  __shared__ int s_slots;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = k1 - k0;
  const float zero[ROW_N] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int nrows =
      (int)min((long long)CTA_ROWS, (n_samples + ROW - 1) / ROW - row0);
  if (n == 0) {                          // an empty chunk: zeros
    for (int r = warp; r < nrows; r += STACK_WARPS)
      store_row(out, base, (row0 + r) * ROW + lane * ROW_N, n_samples, zero,
                out_kind, sc);
    return;
  }
  // the block list
  const bool listed = n <= STAGE_BLOCKS;
  if (tid < CTA_ROWS / 32) s_busy[tid] = 0u;
  if (listed) {
    for (int i = tid; i < n; i += STACK_THREADS) {
      cp_async4(s_row + i, t.blk_row + k0 + i);
      cp_async4(s_ref + i, t.blk_inst + k0 + i);
    }
    cp_async_wait_all();
  }
  __syncthreads();
  const int* rows = listed ? s_row : t.blk_row + k0;
  for (int i = tid; i < n; i += STACK_THREADS) {
    const int r = (int)(rows[i] - row0);
    atomicOr(&s_busy[r >> 5], 1u << (r & 31));
  }
  // warp 0 numbers the slots: a block whose instance differs from the
  // previous block's opens the next one
  if (listed && warp == 0) {
    int count = 0, last = -1;
    for (int b = 0; b < n; b += 32) {
      const int i = b + lane;
      const int m = i < n ? s_ref[i] : -1;
      int prev = __shfl_up_sync(FULL, m, 1);
      if (lane == 0) prev = last;
      const bool first = i < n && m != prev;
      const unsigned opens = __ballot_sync(FULL, first);
      const int slot = count + __popc(opens & ((2u << lane) - 1u)) - 1;
      if (i < n) s_slot[i] = slot;
      if (first) s_mof[slot] = m;          // slot <= i < n <= STAGE_BLOCKS
      count += __popc(opens);
      last = __shfl_sync(FULL, m, 31);
    }
    if (lane == 0) s_slots = count;
  }
  __syncthreads();

  // the descriptors: staged when the chunk's slots fit, else read in place
  const int NT = t.NT, TF = t.TF;
  const int slots = listed ? s_slots : 0;
  const bool staged =
      listed && slots <= min(STAGE_BLOCKS, STAGE_WORDS / view_words(NT, TF));
  StackView v{t.inst, t.amp, t.term_nfac, t.op, t.power, t.shift_hi, t.q32,
              t.args};
  const int* refs = listed ? s_ref : t.blk_inst + k0;
  if (staged) {
    const bool vec = ((reinterpret_cast<uintptr_t>(t.args) |
                       reinterpret_cast<uintptr_t>(t.q32)) & 15) == 0;
    int* w = s_desc;                       // args and q32 first: 16-byte rows
    stage_rows(w, reinterpret_cast<const int*>(t.args), W_ARGS * TF, s_mof,
               slots, vec);
    v.args = reinterpret_cast<const float*>(w);
    w += slots * W_ARGS * TF;
    stage_rows(w, t.q32, 4 * TF, s_mof, slots, vec);
    v.q32 = w;
    w += slots * 4 * TF;
    stage_rows(w, t.op, TF, s_mof, slots, false);
    v.op = w;
    w += slots * TF;
    stage_rows(w, t.power, TF, s_mof, slots, false);
    v.power = w;
    w += slots * TF;
    stage_rows(w, t.shift_hi, TF, s_mof, slots, false);
    v.shift_hi = w;
    w += slots * TF;
    stage_rows(w, reinterpret_cast<const int*>(t.amp), NT, s_mof, slots,
               false);
    v.amp = reinterpret_cast<const float*>(w);
    w += slots * NT;
    stage_rows(w, t.term_nfac, NT, s_mof, slots, false);
    v.term_nfac = w;
    w += slots * NT;
    stage_rows(w, t.inst, 4, s_mof, slots, false);
    v.inst = w;
    refs = s_slot;
  }
  // the rows that no block touches, while the copies are in flight
  for (int r = warp; r < nrows; r += STACK_WARPS)
    if (!((s_busy[r >> 5] >> (r & 31)) & 1u))
      store_row(out, base, (row0 + r) * ROW + lane * ROW_N, n_samples, zero,
                out_kind, sc);
  cp_async_wait_all();
  __syncthreads();
  for (int r = warp; r < nrows; r += STACK_WARPS) {
    if (!((s_busy[r >> 5] >> (r & 31)) & 1u)) continue;
    const long long idx0 = (row0 + r) * ROW + lane * ROW_N;
    float acc[ROW_N] = {0.0f, 0.0f, 0.0f, 0.0f};
    walk_row(v, NT, TF, t.ext, rows, refs, n, (int)(row0 + r), idx0, acc);
    store_row(out, base, idx0, n_samples, acc, out_kind, sc);
  }
}

}  // namespace wfsynth
