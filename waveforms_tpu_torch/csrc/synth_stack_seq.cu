// Stacked-table sequence kernel (K6).
//
// Replaces the TPU kernel built by waveforms_tpu/ops/stack_seq.py:_seq_call
// (its inner `kernel`, with stack_synth's _strip_builder, _emit_chunk and
// _scatter_dot).  It computes what that kernel computes: for each shot s of a
// shot vector ks, the stack kernel's output (K5, synth_stack.cu) for schedule
// clamp(ks[s], 0, K - 1) of a table of K schedules, stored into out[s] as f32,
// as bf16 or f16 (rounded once), or as int16 DAC codes
// clip(round_half_even(acc * scale)).
//
// Not carried over: the TPU design -- a grid over (shot, superchunk), the
// shot index as a scalar-prefetch operand whose BlockSpec index maps stream
// the chosen schedule's packed group tables into VMEM, and the one-hot
// scatter matmul.  Here the tables of the K schedules are K5's own tables
// concatenated (ops/stack_seq.StackSequencer): the instance arrays along M,
// the block lists one after another, and per schedule one row of absolute
// CSR offsets, chunk_start (K, C * n_chunks + 1).  The drag_sin ext offsets
// were rewritten into the concatenated ext buffer on the host, so the walk
// is K5's, unchanged (stack_rows, synth_stack_common.cuh).
//
// Layout: one thread block of STACK_THREADS per (shot, channel, CTA_CHUNKS
// consecutive chunks of CHUNK_ROWS rows), shot-major.  The block reads
// ks[shot] itself from device memory and clamps it -- the host never reads
// ks, so a shot vector that came from a measurement on the card needs no
// host sync -- then stages that schedule's blocks of its chunks and their
// descriptors in shared memory and walks the rows in registers, each row
// stored once, coalesced, into out[shot, c, ...]: every output sample is
// written exactly once, so the zero fill is fused.
//
// What bounds it on the H100: as for K5, evaluating each shot's blocks, not
// the (n_shots, C, N) store; a shot vector that plays one schedule many
// times evaluates it each time.
#include "synth_stack_common.cuh"

namespace wfsynth {

// K5's layout, but its shot index and per-shot offsets take a few more
// registers: at K5's STACK_MIN_BLOCKS (96 registers) ptxas spills 8 bytes
constexpr int SEQ_MIN_BLOCKS = STACK_MIN_BLOCKS - 1;

__global__ void __launch_bounds__(STACK_THREADS, SEQ_MIN_BLOCKS)
synth_stack_seq_kernel(StackDesc t, const int* __restrict__ chunk_start,
                       const int* __restrict__ ks, int K, int C, int n_chunks,
                       long long n_samples, void* out, int out_kind,
                       const float* scale) {
  const int groups = chunk_groups(n_chunks);
  const long long blk = blockIdx.x;         // (shot, channel, chunk group)
  const long long shot = blk / ((long long)C * groups);
  const int q = (int)(blk - shot * C * groups);
  const int c = q / groups;
  const int g = (q - c * groups) * CTA_CHUNKS;
  int sched = ks[shot];
  sched = sched < 0 ? 0 : (sched >= K ? K - 1 : sched);
  const int* cs = chunk_start +
                  (long long)sched * ((long long)C * n_chunks + 1) +
                  (long long)c * n_chunks;
  stack_rows(t, cs[g], cs[min(g + CTA_CHUNKS, n_chunks)],
             (long long)g * CHUNK_ROWS, out, (shot * C + c) * n_samples,
             n_samples, out_kind, out_kind == OUT_I16 ? scale[c] : 1.0f);
}

}  // namespace wfsynth

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  out is
// (n_shots, C, n_samples); chunk_start is (K, C * n_chunks + 1).
int wf_synth_stack_seq(const int* inst, const float* amp, const int* term_nfac,
                       const int* op, const int* power, const int* shift_hi,
                       const int* q32, const float* args, const float* ext,
                       const int* blk_inst, const int* blk_row,
                       const int* chunk_start, const int* ks, int NT, int TF,
                       int K, int C, int n_chunks, long long n_samples,
                       int n_shots, void* out, int out_kind,
                       const float* scale, void* stream) {
  const long long blocks =
      (long long)n_shots * C * wfsynth::chunk_groups(n_chunks);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (blocks > 0)
    wfsynth::synth_stack_seq_kernel<<<(unsigned)blocks,
                                      wfsynth::STACK_THREADS, 0,
                                      (cudaStream_t)stream>>>(
        wfsynth::StackDesc{inst, amp, term_nfac, op, power, shift_hi, q32,
                           args, ext, blk_inst, blk_row, NT, TF},
        chunk_start, ks, K, C, n_chunks, n_samples, out, out_kind, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
