// Pulse-instance stack kernel (K5).
//
// Replaces the TPU kernel built by waveforms_tpu/ops/stack_synth.py:
// _build_kernel_runner (its inner `kernel`, with _strip_builder, _scatter_dot
// and _emit_chunk).  It computes what that kernel computes: every narrow
// pulse instance of a StackPlan, evaluated over the 128-sample blocks it
// covers -- the sum over its terms of amp_t * prod_f factor_f ** power_f,
// in _eval_blocks' order, masked to [lo, hi) -- added into the output, which
// is stored as f32, as bf16 or f16 (rounded once), or as int16 DAC codes
// clip(round_half_even(acc * scale)).
//
// Not carried over: the TPU added blocks into 128x128 output chunks through
// a one-hot matrix product on its matrix unit (its answer to indexed
// accumulation, which needed Precision.HIGHEST or a three-way bf16 split to
// stay exact).  Here a direct add is exact and cheaper:
//
// Layout: one thread block of 128 threads per (channel, chunk of CHUNK_ROWS
// 128-sample rows).  The host (ops/stack_synth.build_stack_tables) flattens
// every group into one instance table padded to the widest term and factor
// counts, and sorts the blocks by (channel, chunk) into CSR offsets, so one
// launch covers the whole plan.  The thread block zeroes its CHUNK_ROWS x
// 128 f32 tile in shared memory (32 KB), then walks its blocks in order:
// thread `lane` evaluates sample `lane` of each block and adds it into its
// own column.  Every tile sample has one owner thread, so there is no race,
// no atomic, and the sum order is the table's -- deterministic.  Then the
// tile is stored once, coalesced (16-byte f32 or 8-byte int16 vectors where
// the row length allows), masked at the channel's end: every output sample
// is written exactly once, so the zero fill is fused.  The multi-tone DRAG
// opcodes read their coefficients from the schedule's ext buffer in global
// memory, so the TPU's one-ext-factor-per-instance limit does not apply.
// The walk and the store are synth_stack_common.cuh's, shared with the
// sequenced twin K6 (synth_stack_seq.cu).
//
// What bounds it on the H100: the output store.  The 120-pulse ladder
// (128 ch x 1,048,576 samples) evaluates 69,228 blocks (8.9 M samples) but
// stores 537 MB as f32; 16,384 thread blocks keep every SM storing.
#include "synth_stack_common.cuh"

namespace wfsynth {

__global__ void __launch_bounds__(LANES)
synth_stack_kernel(StackDesc t, const int* __restrict__ chunk_start,
                   int n_chunks, long long n_samples, void* out, int out_kind,
                   const float* scale) {
  __shared__ __align__(16) float acc[CHUNK_ROWS * LANES];
  const int q = blockIdx.x;                 // (channel, chunk), channel-major
  const int c = q / n_chunks;
  const long long row0 = (long long)(q - c * n_chunks) * CHUNK_ROWS;

  // zero and walk touch only this thread's column: no barrier between them
  stack_walk(t, acc, chunk_start[q], chunk_start[q + 1], row0, threadIdx.x);
  __syncthreads();

  const long long s0 = row0 * LANES;
  const long long count = min((long long)CHUNK_ROWS * LANES, n_samples - s0);
  stack_store(acc, out, (long long)c * n_samples + s0, count, n_samples,
              out_kind, out_kind == OUT_I16 ? scale[c] : 1.0f);
}

}  // namespace wfsynth

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).
int wf_synth_stack(const int* inst, const float* amp, const int* term_nfac,
                   const int* op, const int* power, const int* shift_hi,
                   const int* q32, const float* args, const float* ext,
                   const int* blk_inst, const int* blk_row,
                   const int* chunk_start, int NT, int TF, int C,
                   int n_chunks, long long n_samples, void* out, int out_kind,
                   const float* scale, void* stream) {
  const long long blocks = (long long)C * n_chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (blocks > 0)
    wfsynth::synth_stack_kernel<<<(unsigned)blocks, wfsynth::LANES, 0,
                                  (cudaStream_t)stream>>>(
        wfsynth::StackDesc{inst, amp, term_nfac, op, power, shift_hi, q32,
                           args, ext, blk_inst, blk_row, NT, TF},
        chunk_start, n_chunks, n_samples, out, out_kind, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
