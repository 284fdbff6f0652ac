// Worklist synthesis kernel (K7).
//
// Replaces the TPU kernel waveforms_tpu/ops/sparse_synth.py:_sparse_kernel
// (launched by _run_sparse).  The worklist of a SparsePlan (work_c, work_b,
// work_t, work_o, work_s0, work_s1) names every live Rs x 128 subtile: its
// channel, descriptor bucket, absolute sample base, output subtile and
// segment range [s0, s1).  Each item's subtile is evaluated with the segment
// walker (the TPU kernel's _tile_walker: mask, clip, f32 accumulation in
// slot order) and stored, as f32, as bf16 or f16 (rounded once), as int16
// DAC codes clip(round_half_even(acc * scale)), or, in pair mode, as
// complex64.
//
// Layout (the item walker, synth_item.cuh, shared with the probe P1): each
// item's subtile is cut into passes of ITEM_N * ITEM_THREADS samples (8 x 128
// = 1024), items on blockIdx.x and passes on blockIdx.y: on the flagship,
// 457 live items at Rs 32 (512 with the padding) make 1,828 working thread
// blocks of 2,048.  A thread walks its 8
// consecutive samples once with K1's tile walker (walk_tile): one read of
// each factor's descriptors and one opcode switch for the 8, where the
// per-sample walker (walk_sample) re-read the whole dependent chain for each
// of the 16 samples a thread of a 256-thread block owned.  The pass goes
// through shared memory and consecutive threads store consecutive samples in
// every output kind, masked at the window's end.  Padding items (work_o ==
// n_tiles) return at once from every one of their blocks: the TPU wrote them
// into a scratch row block, the card needs none.  The output is written at
// its final (C, window) shape.
//
// Race freedom and the background: the output arrives zeroed (the TPU kernel
// too takes its zero background from outside, _run_sparse), and every item
// only stores, every sample of its subtile, zeros included.
// build_sparse_plan requires buckets that are whole subtiles, so no output
// subtile has two items: no read-modify-write, no atomics, and int16 codes
// are stored once.
//
// What bounds it on the H100: not the bytes (457 of 62,500 per-channel
// subtiles live on the flagship, 7.5 MB of f32 stores, 0.0025 ms at the HBM
// rate) but latency: one launch's floor (0.0049 ms under probes.cuda_ms's
// timer), a grid of short blocks each waiting on its chain of dependent
// loads (the item's scalars, then its segments' descriptors), and the
// passes that meet a pulse walking its 5 terms of 1-2 cos factors one after
// another.  On an NVIDIA H100 80GB HBM3 at 700 W, K7 takes about 0.0163 ms on
// the flagship (0.0193 with one block an item and walk_sample); with 4
// samples a thread, 0.0176 ms, 0.0132 without the factor math, 0.0081
// without the walk and 0.0072 with no store either (tools/ab_sparse.py
// layout runs).  The path's cost is the zero fill of the output before it
// (1.02 GB as f32 on the flagship, 0.314 ms).
//
// The shot entry (wf_synth_sparse_shots): one launch for a shot vector ks
// over a sequence table of K schedules (ops/sequencer.Sequencer), as the
// TPU ran jax.vmap of play_sparse over the schedule index.  The descriptors
// are the table's (K, C, ...) tensors, read as one table of K * C channels,
// and the worklists its (K, Kw) stacked per-schedule worklists.  Items of
// shot s are blocks [s * Kw, (s + 1) * Kw) of the grid's x axis: each block
// reads ks[s] from device memory and clamps it to [0, K - 1] itself (the
// JAX gather's mode='clip'), walks item j of that schedule's worklist with
// the descriptors of its channels (channel sched * C + c) and stores into
// out[s] (a (n_shots, C, window) output, zeroed).  The host reads neither
// ks nor the schedule's count of live items: padding items return at once,
// as in a one-shot launch.  Every item walks as it does there, so each shot
// is bit-identical to a one-shot launch of its schedule.
#include "synth_item.cuh"

namespace wfsynth {

template <bool PAIR>
__global__ void __launch_bounds__(
    ITEM_THREADS, PAIR ? ITEM_MIN_BLOCKS_PAIR : ITEM_MIN_BLOCKS)
synth_sparse_kernel(Desc d, Worklist w, int Rs, int n_tiles,
                    long long window, void* out, int out_kind,
                    const float* scale) {
  walk_item<PAIR, false>(d, w, blockIdx.x, 0, 0, Rs, n_tiles, window, out,
                         out_kind, scale);
}

// The shot entry's kernel: block x = shot * Kw + item
template <bool PAIR>
__global__ void __launch_bounds__(
    ITEM_THREADS, PAIR ? ITEM_MIN_BLOCKS_PAIR : ITEM_MIN_BLOCKS)
synth_sparse_shots_kernel(Desc d, Worklist w, int Kw, const int* ks, int K,
                          int Rs, int n_tiles, long long window, void* out,
                          int out_kind, const float* scale) {
  const int shot = blockIdx.x / Kw;
  const int j = blockIdx.x - shot * Kw;
  int sched = ks[shot];
  sched = sched < 0 ? 0 : (sched >= K ? K - 1 : sched);
  const long long row = (long long)sched * Kw;
  const Worklist ws{w.c + row, w.b + row, w.t + row,
                    w.o + row, w.s0 + row, w.s1 + row};
  walk_item<PAIR, false>(d, ws, j, sched * d.C, (long long)shot * d.C * window,
                         Rs, n_tiles, window, out, out_kind, scale);
}

}  // namespace wfsynth

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  K is the
// worklist length, padding included.
int wf_synth_sparse(const int* seg_lo, const int* seg_hi, const int* nterm,
                    const int* nfac, const float* amp, const int* op,
                    const int* power, const int* shift_hi, const int* q32,
                    const float* args, const float* ext, const float* clip,
                    const float* amp_im, int C, int NB, int S, int T, int F,
                    long long n_samples, long long bucket_samples,
                    const int* work_c, const int* work_b, const int* work_t,
                    const int* work_o, const int* work_s0,
                    const int* work_s1, int K, int Rs, int n_tiles,
                    long long window, void* out, int out_kind,
                    const float* scale, void* stream) {
  wfsynth::Desc d{seg_lo, seg_hi, nullptr, nterm, nfac, amp, op, power,
                  shift_hi, q32, args, ext, clip, amp_im, C, NB, S, T, F,
                  n_samples, bucket_samples};
  const wfsynth::Worklist w{work_c, work_b, work_t, work_o, work_s0, work_s1};
  const long long grid_y = wfsynth::item_blocks_y(Rs);
  if (Rs < 1 || grid_y > 65535) return (int)cudaErrorInvalidValue;
  if (K > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const dim3 grid((unsigned)K, (unsigned)grid_y);
    if (out_kind == wfsynth::OUT_C64)
      wfsynth::synth_sparse_kernel<true><<<grid, wfsynth::ITEM_THREADS, 0,
                                           st>>>(d, w, Rs, n_tiles, window,
                                                 out, out_kind, scale);
    else
      wfsynth::synth_sparse_kernel<false><<<grid, wfsynth::ITEM_THREADS, 0,
                                            st>>>(d, w, Rs, n_tiles, window,
                                                  out, out_kind, scale);
  }
  return (int)cudaGetLastError();
}

// The shot entry.  The descriptors are a table's (K, C, NB, S, ...) tensors
// (C channels a schedule), the work_* columns its (K, Kw) worklists, ks the
// (n_shots,) int32 schedule indices on the device (clamped there), and out
// (n_shots, C, window), zeroed.  Launch on `stream`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a grid
// the card does not take.
int wf_synth_sparse_shots(const int* seg_lo, const int* seg_hi,
                          const int* nterm, const int* nfac, const float* amp,
                          const int* op, const int* power,
                          const int* shift_hi, const int* q32,
                          const float* args, const float* ext,
                          const float* clip, const float* amp_im, int C,
                          int NB, int S, int T, int F, long long n_samples,
                          long long bucket_samples, const int* work_c,
                          const int* work_b, const int* work_t,
                          const int* work_o, const int* work_s0,
                          const int* work_s1, int Kw, const int* ks, int K,
                          int n_shots, int Rs, int n_tiles, long long window,
                          void* out, int out_kind, const float* scale,
                          void* stream) {
  wfsynth::Desc d{seg_lo, seg_hi, nullptr, nterm, nfac, amp, op, power,
                  shift_hi, q32, args, ext, clip, amp_im, C, NB, S, T, F,
                  n_samples, bucket_samples};
  const wfsynth::Worklist w{work_c, work_b, work_t, work_o, work_s0, work_s1};
  const long long grid_y = wfsynth::item_blocks_y(Rs);
  const long long grid_x = (long long)n_shots * Kw;
  if (Rs < 1 || grid_y > 65535 || grid_x > 0x7fffffffLL || K < 1 ||
      (long long)K * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (grid_x > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
    if (out_kind == wfsynth::OUT_C64)
      wfsynth::synth_sparse_shots_kernel<true><<<grid, wfsynth::ITEM_THREADS,
                                                 0, st>>>(
          d, w, Kw, ks, K, Rs, n_tiles, window, out, out_kind, scale);
    else
      wfsynth::synth_sparse_shots_kernel<false><<<grid, wfsynth::ITEM_THREADS,
                                                  0, st>>>(
          d, w, Kw, ks, K, Rs, n_tiles, window, out, out_kind, scale);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
