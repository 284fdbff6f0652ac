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
// stay exact).  Here a direct add is exact and cheaper.
//
// Layout: one thread block of STACK_THREADS per CTA_CHUNKS consecutive
// chunks (of CHUNK_ROWS 128-sample rows) of a channel.  The host
// (ops/stack_synth.build_stack_tables) flattens every group into one
// instance table padded to the widest term and factor counts, and sorts the
// blocks by (channel, chunk) into CSR offsets, so one launch covers the
// whole plan.  The thread block stages its block list and instance
// descriptors in shared memory, and its warps walk whole rows in
// registers, each row stored once, coalesced, with the zero fill fused
// (stack_rows, synth_stack_common.cuh, shared with the sequenced twin K6).
// Every output sample has one owner lane, which adds its row's blocks in
// table order: no race, no atomic, deterministic.  The multi-tone DRAG
// opcodes read their coefficients from the schedule's ext buffer in device
// memory, so the TPU's one-ext-factor-per-instance limit does not apply.
//
// What bounds it on the H100: the 120-pulse ladder (128 ch x 1,048,576
// samples) stores 537 MB as f32 but also evaluates 69,228 blocks of 7.3
// cosine factors each; the evaluation, not the store, sets its pace (its
// int16 store takes the f32 time).
#include "synth_stack_common.cuh"

namespace wfsynth {

__global__ void __launch_bounds__(STACK_THREADS, STACK_MIN_BLOCKS)
synth_stack_kernel(StackDesc t, const int* __restrict__ chunk_start,
                   int n_chunks, long long n_samples, void* out, int out_kind,
                   const float* scale) {
  const int groups = chunk_groups(n_chunks);
  const int c = blockIdx.x / groups;        // (channel, chunk group)
  const int g = (blockIdx.x - c * groups) * CTA_CHUNKS;
  const int* cs = chunk_start + (long long)c * n_chunks;
  stack_rows(t, cs[g], cs[min(g + CTA_CHUNKS, n_chunks)],
             (long long)g * CHUNK_ROWS, out, (long long)c * n_samples,
             n_samples, out_kind, out_kind == OUT_I16 ? scale[c] : 1.0f);
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
  const long long blocks = (long long)C * wfsynth::chunk_groups(n_chunks);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (blocks > 0)
    wfsynth::synth_stack_kernel<<<(unsigned)blocks, wfsynth::STACK_THREADS, 0,
                                  (cudaStream_t)stream>>>(
        wfsynth::StackDesc{inst, amp, term_nfac, op, power, shift_hi, q32,
                           args, ext, blk_inst, blk_row, NT, TF},
        chunk_start, n_chunks, n_samples, out, out_kind, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
