// Measurement probes P1-P4: the four kernels of tools/tpu_capture.py, for
// the H100.
//
// Replaces the TPU probe kernels launched by tools/tpu_capture.py:
//   P4 probe_health          main()'s health probe `k` (x * 2 over (8, 128))
//   P2 probe_grid            task_grid_overhead_probe's trivial body
//   P3 probe_walker          task_walker_cost_probe's seven bodies
//   P1 probe_sparse_compact  task_sparse_step_cost_probe's `run_compact`:
//                            the worklist kernel's body (K7) storing item i
//                            at output block i, with no background
// The same functions, element for element.  Every P2/P3 body is a chain of
// f32 adds in the JAX body's order (x2 and +1 are exact or round once), so
// the card's output equals the plain versions (ops/reference_probes.py) bit
// for bit; that equality is also the check that nvcc kept each construct.
//
// Layout: P2 and P3 run one thread block of PROBE_THREADS threads per grid
// step; block i owns one Rs x 128 f32 output block and its threads store
// consecutive samples, so stores coalesce.  Every thread does the step's
// scalar reads itself, as walk_sample does in the panel walker K2, so the
// probes price what that walker pays.  P1 runs K7's own body, the item
// walker of synth_item.cuh (passes of 1024 samples a block, 8 a thread,
// walk_tile), so it prices the step K7 ships.  P2's table pointers travel
// in a struct passed by value (the kernel-parameter bank, the GPU's
// counterpart of the TPU's scalar-memory operands).
//
// What bounds them on the H100: P2 and P3 store 16 KB per step, so a run of
// K steps is store-bound at K * 16 KB over HBM (64 MB for P2's K = 4096) or
// at the L2 for P2's dynamic output map (4096 steps into 256 blocks); P1
// (4 MB of stores at K = 256) and P4 are short enough that one launch's
// fixed cost is a large part of their time.  On the GPU the blocks run at
// once, so a probe's time / K is a throughput, not the latency of one step
// as on the TPU's sequential grid.
#include "synth_item.cuh"

namespace wfsynth {

constexpr int PROBE_THREADS = 256;
constexpr int PROBE_MAX_OPS = 13;

// P2's table operands: tables[r] is (C, 1, L) f32, read at [idx, 0, 0]
struct ProbeTables {
  const float* p[PROBE_MAX_OPS];
};

// P3's bodies, in tools/tpu_capture.py's order
enum WalkerBody : int {
  W_BASE = 0, W_READS64 = 1, W_COND16 = 2, W_SWITCH16X3 = 3, W_FORI16 = 4,
  W_VECCOND8 = 5, W_VECWORK8 = 6,
};

__global__ void probe_health_kernel(const float* __restrict__ x,
                                    float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] * 2.0f;
}

// P2: acc = 0 + t_0[idx] + ... + t_{N-1}[idx], idx = wc[i] (dynamic index
// map) or 0 (static), stored over output block wo[i] (dynamic output map)
// or i.  Under the dynamic map several steps store one block; the probe's
// tables make them store the same value.
template <int N_OPS, bool DYN_IN, bool DYN_OUT>
__global__ void __launch_bounds__(PROBE_THREADS)
probe_grid_kernel(ProbeTables tabs, const int* __restrict__ wc,
                  const int* __restrict__ wo, int L, int tile,
                  float* __restrict__ out) {
  const int i = blockIdx.x;
  const long long row = DYN_IN ? (long long)wc[i] * L : 0;
  float acc = 0.0f;
#pragma unroll
  for (int r = 0; r < N_OPS; ++r) acc = acc + tabs.p[r][row];
  float* dst = out + (long long)(DYN_OUT ? wo[i] : i) * tile;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) dst[e] = acc;
}

// P3: one body over row wc[i] of the f (C, 1, L) f32 and it (C, 1, L) int32
// tables.  The row is chosen by data, so no read folds into a constant.
template <int BODY>
__device__ __forceinline__ float walker_scalar(const float* f, const int* it,
                                               int L) {
  float acc = 0.0f;
  if (BODY == W_BASE) {
    acc = f[0];
  } else if (BODY == W_READS64) {
#pragma unroll
    for (int k = 0; k < 64; ++k) acc = acc + f[k];
  } else if (BODY == W_COND16) {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (it[k] > 0) acc = acc + f[k];
  } else if (BODY == W_SWITCH16X3) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int s = it[k] < 0 ? 0 : (it[k] > 2 ? 2 : it[k]);  // lax.switch
      float v;                                                 // clamps
      switch (s) {
        case 0: v = f[k]; break;
        case 1: v = f[k] * 2.0f; break;
        default: v = f[k] + 1.0f;
      }
      acc = acc + v;
    }
  } else if (BODY == W_FORI16) {
    int n = it[0] + 15;              // trip count known at run time only
    n = n < L ? n : L;
    for (int j = 0; j < n; ++j) acc = acc + f[j];
  } else if (BODY == W_VECCOND8) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (it[k] > 0) acc = acc + f[k];
  }
  return acc;
}

template <int BODY>
__global__ void __launch_bounds__(PROBE_THREADS)
probe_walker_kernel(const int* __restrict__ wc, const float* __restrict__ ftab,
                    const int* __restrict__ itab, int L, int tile,
                    float* __restrict__ out) {
  const int i = blockIdx.x;
  const float* f = ftab + (long long)wc[i] * L;
  const int* it = itab + (long long)wc[i] * L;
  float* dst = out + (long long)i * tile;
  if (BODY == W_VECWORK8 || BODY == W_VECCOND8) {
    // vector bodies: evaluated per output element, as on the TPU
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      float acc;
      if (BODY == W_VECWORK8) {
        const int row = e >> 7;      // the element's row of the Rs x 128 block
        acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) acc = acc + (row >= it[k] ? f[k] : 0.0f);
      } else {
        acc = walker_scalar<W_VECCOND8>(f, it, L);
      }
      dst[e] = acc;
    }
    return;
  }
  const float acc = walker_scalar<BODY>(f, it, L);
  for (int e = threadIdx.x; e < tile; e += blockDim.x) dst[e] = acc;
}

// P1: K7's body (synth_sparse.cu), the same item walker (synth_item.cuh),
// with item k's subtile stored at output block k of a (K, Rs * 128) f32
// output, and no background.  Padding items (an empty segment range) store
// zeros.
__global__ void __launch_bounds__(ITEM_THREADS, ITEM_MIN_BLOCKS)
probe_sparse_compact_kernel(Desc d, Worklist w, int Rs, float* out) {
  walk_item<false, true>(d, w, blockIdx.x, 0, 0, Rs, 0, 0, out, OUT_F32,
                         nullptr);
}

template <int N>
static void launch_grid(const ProbeTables& t, const int* wc, const int* wo,
                        bool dyn_in, bool dyn_out, int K, int L, int tile,
                        float* out, cudaStream_t st) {
  if (dyn_in && dyn_out)
    probe_grid_kernel<N, true, true><<<K, PROBE_THREADS, 0, st>>>(
        t, wc, wo, L, tile, out);
  else if (dyn_in)
    probe_grid_kernel<N, true, false><<<K, PROBE_THREADS, 0, st>>>(
        t, wc, wo, L, tile, out);
  else if (dyn_out)
    probe_grid_kernel<N, false, true><<<K, PROBE_THREADS, 0, st>>>(
        t, wc, wo, L, tile, out);
  else
    probe_grid_kernel<N, false, false><<<K, PROBE_THREADS, 0, st>>>(
        t, wc, wo, L, tile, out);
}

}  // namespace wfsynth

extern "C" {

// Each launches on `stream` and returns cudaGetLastError() (0 on success).

int wf_probe_health(const float* x, float* out, long long n, void* stream) {
  if (n > 0) {
    const int blocks = (int)((n + wfsynth::PROBE_THREADS - 1)
                             / wfsynth::PROBE_THREADS);
    wfsynth::probe_health_kernel<<<blocks, wfsynth::PROBE_THREADS, 0,
                                   (cudaStream_t)stream>>>(x, out, n);
  }
  return (int)cudaGetLastError();
}

// tables: n_ops (2 or 13) pointers to (C, 1, L) f32 tables; out holds
// K blocks (static output map) or at least max(wo) + 1 (dynamic) of `tile`
// f32 each.
int wf_probe_grid(const float* const* tables, int n_ops, const int* wc,
                  const int* wo, int dyn_in, int dyn_out, int K, int L,
                  int tile, float* out, void* stream) {
  wfsynth::ProbeTables t{};
  if (n_ops != 2 && n_ops != wfsynth::PROBE_MAX_OPS)
    return (int)cudaErrorInvalidValue;
  for (int r = 0; r < n_ops; ++r) t.p[r] = tables[r];
  cudaStream_t st = (cudaStream_t)stream;
  if (K > 0) {
    if (n_ops == 2)
      wfsynth::launch_grid<2>(t, wc, wo, dyn_in, dyn_out, K, L, tile, out,
                              st);
    else
      wfsynth::launch_grid<wfsynth::PROBE_MAX_OPS>(t, wc, wo, dyn_in, dyn_out,
                                                   K, L, tile, out, st);
  }
  return (int)cudaGetLastError();
}

// body: a WalkerBody; out (K, tile) f32
int wf_probe_walker(int body, const int* wc, const float* ftab,
                    const int* itab, int K, int L, int tile, float* out,
                    void* stream) {
  using namespace wfsynth;
  cudaStream_t st = (cudaStream_t)stream;
  if (K > 0) {
    switch (body) {
#define WF_WALKER(B)                                                      \
  case B:                                                                 \
    probe_walker_kernel<B><<<K, PROBE_THREADS, 0, st>>>(wc, ftab, itab, L, \
                                                        tile, out);       \
    break;
      WF_WALKER(W_BASE)
      WF_WALKER(W_READS64)
      WF_WALKER(W_COND16)
      WF_WALKER(W_SWITCH16X3)
      WF_WALKER(W_FORI16)
      WF_WALKER(W_VECCOND8)
      WF_WALKER(W_VECWORK8)
#undef WF_WALKER
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// The worklist (K items, padding included) of a SparsePlan over a
// DeviceSchedule's descriptors; out (K, Rs * 128) f32.
int wf_probe_sparse_compact(const int* seg_lo, const int* seg_hi,
                            const int* nterm, const int* nfac,
                            const float* amp, const int* op, const int* power,
                            const int* shift_hi, const int* q32,
                            const float* args, const float* ext,
                            const float* clip, int C, int NB, int S, int T,
                            int F, long long n_samples,
                            long long bucket_samples, const int* work_c,
                            const int* work_b, const int* work_t,
                            const int* work_s0, const int* work_s1, int K,
                            int Rs, float* out, void* stream) {
  wfsynth::Desc d{seg_lo, seg_hi, nullptr, nterm, nfac, amp, op, power,
                  shift_hi, q32, args, ext, clip, nullptr, C, NB, S, T, F,
                  n_samples, bucket_samples};
  const wfsynth::Worklist w{work_c, work_b, work_t, nullptr, work_s0,
                            work_s1};
  const long long grid_y = wfsynth::item_blocks_y(Rs);
  if (Rs < 1 || grid_y > 65535) return (int)cudaErrorInvalidValue;
  if (K > 0)
    wfsynth::probe_sparse_compact_kernel<<<dim3((unsigned)K,
                                                (unsigned)grid_y),
                                           wfsynth::ITEM_THREADS, 0,
                                           (cudaStream_t)stream>>>(d, w, Rs,
                                                                   out);
  return (int)cudaGetLastError();
}

}  // extern "C"
