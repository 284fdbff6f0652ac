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
// The window: a launch may cover only chunks [chunk0, chunk0 + win_chunks)
// of every channel, the slice a time shard of a mesh plays
// (ops/stack_seq.synthesize_stack_sharded).  The instances carry absolute
// times and phases, so the rows are evaluated at their global row, as in a
// whole launch, and stored at their row less the window's first, into a
// (n_shots, C, n_local) output: sample chunk0 * CHUNK_ROWS * ROW + i at
// column i.  chunk0 = 0 with every chunk and n_local = n_samples is the
// whole table, as every other caller launches it.
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
                       int chunk0, int win_chunks, long long n_local,
                       void* out, int out_kind, const float* scale) {
  const int groups = chunk_groups(win_chunks);
  const long long blk = blockIdx.x;         // (shot, channel, chunk group)
  const long long shot = blk / ((long long)C * groups);
  const int q = (int)(blk - shot * C * groups);
  const int c = q / groups;
  const int g = chunk0 + (q - c * groups) * CTA_CHUNKS;
  int sched = ks[shot];
  sched = sched < 0 ? 0 : (sched >= K ? K - 1 : sched);
  const int* cs = chunk_start +
                  (long long)sched * ((long long)C * n_chunks + 1) +
                  (long long)c * n_chunks;
  // the window's first sample, and its end in the schedule's samples
  const long long w0 = (long long)chunk0 * CHUNK_ROWS * ROW;
  stack_rows(t, cs[g], cs[min(g + CTA_CHUNKS, chunk0 + win_chunks)],
             (long long)g * CHUNK_ROWS, out,
             (shot * C + c) * n_local - w0, w0 + n_local, out_kind,
             out_kind == OUT_I16 ? scale[c] : 1.0f);
}

}  // namespace wfsynth

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a window the kernel does not take.  out is
// (n_shots, C, n_local) and holds chunks [chunk0, chunk0 + win_chunks) of
// every channel: n_local = min(n_samples, (chunk0 + win_chunks) *
// CHUNK_ROWS * 128) - chunk0 * CHUNK_ROWS * 128.  chunk_start is (K, C *
// n_chunks + 1).
int wf_synth_stack_seq_window(
    const int* inst, const float* amp, const int* term_nfac, const int* op,
    const int* power, const int* shift_hi, const int* q32, const float* args,
    const float* ext, const int* blk_inst, const int* blk_row,
    const int* chunk_start, const int* ks, int NT, int TF, int K, int C,
    int n_chunks, long long n_samples, int chunk0, int win_chunks,
    long long n_local, int n_shots, void* out, int out_kind,
    const float* scale, void* stream) {
  constexpr long long CHUNK = (long long)wfsynth::CHUNK_ROWS * wfsynth::ROW;
  const long long end = (chunk0 + win_chunks) * CHUNK;
  if (chunk0 < 0 || win_chunks < 0 || chunk0 + win_chunks > n_chunks ||
      n_local != (end < n_samples ? end : n_samples) - chunk0 * CHUNK)
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)n_shots * C * wfsynth::chunk_groups(win_chunks);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (blocks > 0)
    wfsynth::synth_stack_seq_kernel<<<(unsigned)blocks,
                                      wfsynth::STACK_THREADS, 0,
                                      (cudaStream_t)stream>>>(
        wfsynth::StackDesc{inst, amp, term_nfac, op, power, shift_hi, q32,
                           args, ext, blk_inst, blk_row, NT, TF},
        chunk_start, ks, K, C, n_chunks, chunk0, win_chunks, n_local, out,
        out_kind, scale);
  return (int)cudaGetLastError();
}

// The whole table (chunk0 = 0, every chunk): the C interface that builds of
// this kernel have had since it was written, kept so that an A/B against an
// earlier build (tools/ab_stack.py) calls both alike.
int wf_synth_stack_seq(const int* inst, const float* amp, const int* term_nfac,
                       const int* op, const int* power, const int* shift_hi,
                       const int* q32, const float* args, const float* ext,
                       const int* blk_inst, const int* blk_row,
                       const int* chunk_start, const int* ks, int NT, int TF,
                       int K, int C, int n_chunks, long long n_samples,
                       int n_shots, void* out, int out_kind,
                       const float* scale, void* stream) {
  return wf_synth_stack_seq_window(
      inst, amp, term_nfac, op, power, shift_hi, q32, args, ext, blk_inst,
      blk_row, chunk_start, ks, NT, TF, K, C, n_chunks, n_samples, 0,
      n_chunks, n_samples, n_shots, out, out_kind, scale, stream);
}

}  // extern "C"
