// Fused confidence-gated cascade over QuickScorer bitvector stages, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `cascade_qs_forward` in
// src/repro/kernels/cascade_kernel.py:88 (body `_cascade_qs_kernel` :38).
// Same function: each row walks the K stages in order.  A stage adds the
// QuickScorer leaf sum over its trees (the traversal of qs_forward.cu);
// after every stage but the last the gate decides, on the row's running
// scores times inv_scale, whether the row exits; an exited row records
// its stage and keeps its scores.  Rows with valid = 0 never count, and a
// block whose rows have all exited skips the remaining stages.  Float
// forests sum in f32, int-accum forests in int32 (the TPU kernel sums in
// f32, exact below 2^24).
//
// What bounds it on an H100.  It reads x (B*d*4 bytes), the stage-
// concatenated node stream feat/thr/masks (T*N*(8+4W)), init_idx and
// leaf_val, and writes scores (B*C*4) and exit stages (B*4).  Its work
// depends on the data: rows reaching stage k times the trees of stage k
// times N*(1+W) 32-bit instructions (a compare and W predicated ANDs per
// node), plus a leaf add per class.  At the mnist cascade (512 trees in
// stages 16/64/256/512, L=64, d=784, C=10, B=1024) that is bound by
// operations at the card's 67 T op/s non-tensor rate (chip_smoke.py
// prints the count from the served batch's exit counts).
//
// What the design does about it.
//   * Rows and slices.  A block holds kRows = 8 rows and kSlices = 32
//     tree slices (256 threads): thread (slice s, row r) walks trees
//     s, s + 32, ... of each staged chunk for row r.  So B = 1024 gives
//     128 blocks, about one per SM, where one thread per row would give 8.
//     A warp holds 8 rows x 4 slices: it reads 4 trees' nodes from shared
//     memory at once.
//   * Tree chunks.  Each stage's trees are staged through shared memory in
//     chunks that never cross a stage boundary (stage_bounds are the
//     stage-concatenated, block_t-padded offsets).
//   * Deterministic sums.  At the end of a stage each slice writes its
//     partial sums to shared memory; the row's slice-0 thread adds them in
//     slice order 0..31 and then adds that stage sum to the running score.
//     No atomics: a float forest gives the same bits on every run.
//   * The gate runs in the slice-0 thread on the descaled running scores,
//     with every rounding step explicit (__fmul_rn, __fadd_rn, __fsub_rn,
//     __fdiv_rn: nvcc never fuses them into an FMA), the classes summed
//     left to right, ties resolved to the first maximum, and expf for the
//     softmax of logit forests: the arithmetic of the torch `decide`
//     (repro_torch/cascade/policy.py).  Built without --use_fast_math, so
//     the division is IEEE.
//   * Early exit.  __syncthreads_or(still active) once per stage; exited
//     threads stay in the loop to the barrier (returning early would
//     deadlock the block) and skip only the traversal.
//
// The traversal of one (row, tree) is copied from qs_forward.cu, not
// shared through a header: build.py hashes each source alone.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (src/repro_torch/kernels/cascade_kernel.py).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;
constexpr int kSlices = 32;
constexpr int kThreads = kRows * kSlices;
constexpr size_t kMaxSharedBytes = 48 * 1024;

// cascade/policy.py GATE_*
enum GateKind { kNever = 0, kMargin = 1, kProba = 2, kScoreBound = 3 };

// consts: inv_scale, threshold, uniform, lo_thr, hi_thr, slack, then
// rest_min (K-1, C) and rest_max (K-1, C) for score-bound gates.
constexpr int kInvScale = 0, kThreshold = 1, kUniform = 2, kLoThr = 3,
              kHiThr = 4, kSlack = 5, kRest = 6;

// p = votes ? v / sum(v), v = max(s, 0) (uniform where the sum is not > 0)
//           : softmax(s)
template <int CMAX>
__device__ void normalize(const float* s, float* p, int C, int votes,
                          float uniform) {
  if (votes) {
    float v[CMAX];
    float tot = 0.f;
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c < C) {
        v[c] = fmaxf(s[c], 0.f);
        tot = (c == 0) ? v[0] : __fadd_rn(tot, v[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < C) p[c] = (tot > 0.f) ? __fdiv_rn(v[c], tot) : uniform;
    return;
  }
  float m = s[0];
#pragma unroll
  for (int c = 1; c < CMAX; ++c)
    if (c < C) m = fmaxf(m, s[c]);
  float tot = 0.f;
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < C) {
      p[c] = expf(__fsub_rn(s[c], m));
      tot = (c == 0) ? p[0] : __fadd_rn(tot, p[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < CMAX; ++c)
    if (c < C) p[c] = __fdiv_rn(p[c], tot);
}

// index of the first maximum of a[0..C), and that maximum
template <int CMAX>
__device__ int first_argmax(const float* a, int C, float* best_value) {
  int best = 0;
  float bv = a[0];
#pragma unroll
  for (int c = 1; c < CMAX; ++c) {
    if (c < C && a[c] > bv) {
      best = c;
      bv = a[c];
    }
  }
  *best_value = bv;
  return best;
}

// Margin and proba gates: does a row with descaled running scores s exit?
template <int CMAX>
__device__ bool confidence_exits(const float* s, int C, int kind, int votes,
                                 const float* consts) {
  float p[CMAX];
  normalize<CMAX>(s, p, C, votes, consts[kUniform]);
  float top_p;
  const int top = first_argmax<CMAX>(p, C, &top_p);
  if (kind == kProba) return top_p >= consts[kThreshold];
  float second = -CUDART_INF_F;
#pragma unroll
  for (int c = 0; c < CMAX; ++c)
    if (c < C && c != top) second = fmaxf(second, p[c]);
  return __fsub_rn(top_p, second) >= consts[kThreshold];
}

// Score-bound gate, given this stage's rest_min and rest_max rows: exit
// when the decision can no longer change.
template <int CMAX>
__device__ bool bound_exits(const float* s, int C, const float* rmin,
                            const float* rmax, const float* consts) {
  if (C < 2) {
    const float lo = __fadd_rn(s[0], rmin[0]);
    const float hi = __fadd_rn(s[0], rmax[0]);
    return lo > consts[kLoThr] || hi < consts[kHiThr];
  }
  float best_s;
  const int best = first_argmax<CMAX>(s, C, &best_s);
  const float best_lo = __fadd_rn(best_s, rmin[best]);
  float other_hi = -CUDART_INF_F;
#pragma unroll
  for (int c = 0; c < CMAX; ++c)
    if (c < C && c != best)
      other_hi = fmaxf(other_hi, __fadd_rn(s[c], rmax[c]));
  return best_lo > __fsub_rn(other_hi, consts[kSlack]);
}

template <int WMAX, int CMAX, typename Acc>
__global__ void __launch_bounds__(kThreads)
cascade_kernel(const float* __restrict__ x, const uint8_t* __restrict__ valid,
               const int* __restrict__ feat, const float* __restrict__ thr,
               const uint32_t* __restrict__ masks,
               const uint32_t* __restrict__ init_idx,
               const float* __restrict__ leaf_val,
               const int* __restrict__ stage_bounds,
               const float* __restrict__ consts, Acc* __restrict__ out,
               int* __restrict__ exit_stage, int B, int d, int N, int W,
               int L, int C, int K, int tree_chunk, int gate_kind,
               int votes) {
  extern __shared__ uint32_t smem[];
  Acc* red = reinterpret_cast<Acc*>(smem);           // (kSlices, kRows, C)
  Acc* run = red + kSlices * kRows * C;              // (kRows, C)
  int* active = reinterpret_cast<int*>(run + kRows * C);   // (kRows,)
  int* feat_s = active + kRows;
  float* thr_s = reinterpret_cast<float*>(feat_s + tree_chunk * N);
  uint32_t* masks_s = reinterpret_cast<uint32_t*>(thr_s + tree_chunk * N);
  uint32_t* init_s = masks_s + tree_chunk * N * W;

  const int r = threadIdx.x % kRows;
  const int s = threadIdx.x / kRows;
  const int row = blockIdx.x * kRows + r;
  const bool real = row < B && valid[row] != 0;
  if (s == 0) {
    active[r] = real ? 1 : 0;
    for (int c = 0; c < C; ++c) run[r * C + c] = Acc(0);
  }
  const float* xr = x + static_cast<size_t>(real ? row : 0) * d;
  const float inv_scale = consts[kInvScale];
  int my_exit = K - 1;
  int any = __syncthreads_or(real);

  for (int k = 0; k < K && any; ++k) {
    const int a = stage_bounds[k];
    const int b = stage_bounds[k + 1];
    const bool mine = active[r] != 0;
    Acc part[CMAX];
#pragma unroll
    for (int c = 0; c < CMAX; ++c) part[c] = Acc(0);

    for (int t0 = a; t0 < b; t0 += tree_chunk) {
      const int tc = min(tree_chunk, b - t0);
      __syncthreads();                 // the previous chunk is read
      const size_t node0 = static_cast<size_t>(t0) * N;
      for (int i = threadIdx.x; i < tc * N; i += kThreads) {
        feat_s[i] = feat[node0 + i];
        thr_s[i] = thr[node0 + i];
      }
      for (int i = threadIdx.x; i < tc * N * W; i += kThreads)
        masks_s[i] = masks[node0 * W + i];
      for (int i = threadIdx.x; i < tc * W; i += kThreads)
        init_s[i] = init_idx[static_cast<size_t>(t0) * W + i];
      __syncthreads();
      if (!mine) continue;
      for (int t = s; t < tc; t += kSlices) {
        uint32_t leafidx[WMAX];
#pragma unroll
        for (int w = 0; w < WMAX; ++w)
          leafidx[w] = (w < W) ? init_s[t * W + w] : 0u;
        const int* ft = feat_s + t * N;
        const float* th = thr_s + t * N;
        const uint32_t* mt = masks_s + t * N * W;
        for (int n = 0; n < N; ++n) {
          // all ones when the row goes left (x <= thr, or NaN)
          const uint32_t keep =
              (__ldg(xr + ft[n]) > th[n]) ? 0u : 0xFFFFFFFFu;
#pragma unroll
          for (int w = 0; w < WMAX; ++w)
            if (w < W) leafidx[w] &= mt[n * W + w] | keep;
        }
        int leaf = 0;
#pragma unroll
        for (int w = WMAX - 1; w >= 0; --w)
          if (w < W && leafidx[w] != 0u) leaf = w * 32 + __ffs(leafidx[w]) - 1;
        const float* lv =
            leaf_val + (static_cast<size_t>(t0 + t) * L + leaf) * C;
#pragma unroll
        for (int c = 0; c < CMAX; ++c)
          if (c < C) part[c] += static_cast<Acc>(__ldg(lv + c));
      }
    }

#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < C) red[(s * kRows + r) * C + c] = part[c];
    __syncthreads();

    bool still = false;
    if (s == 0 && mine) {
      float sc[CMAX];
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (c < C) {
          Acc stage_sum = red[r * C + c];
          for (int sl = 1; sl < kSlices; ++sl)
            stage_sum += red[(sl * kRows + r) * C + c];
          const Acc total = run[r * C + c] + stage_sum;
          run[r * C + c] = total;
          sc[c] = __fmul_rn(static_cast<float>(total), inv_scale);
        }
      }
      still = true;
      if (k < K - 1 && gate_kind != kNever) {
        bool ex;
        if (gate_kind == kScoreBound) {
          const float* rmin = consts + kRest + k * C;
          const float* rmax = consts + kRest + (K - 1) * C + k * C;
          ex = bound_exits<CMAX>(sc, C, rmin, rmax, consts);
        } else {
          ex = confidence_exits<CMAX>(sc, C, gate_kind, votes, consts);
        }
        if (ex) {
          still = false;
          my_exit = k;
          active[r] = 0;
        }
      }
    }
    any = __syncthreads_or(still);
  }

  if (s == 0 && row < B) {
    for (int c = 0; c < C; ++c)
      out[static_cast<size_t>(row) * C + c] = run[r * C + c];
    exit_stage[row] = my_exit;
  }
}

size_t shared_bytes(int N, int W, int C, int tree_chunk) {
  return sizeof(uint32_t) *
         (static_cast<size_t>(kSlices) * kRows * C + kRows * C + kRows +
          static_cast<size_t>(tree_chunk) * N * (2 + W) + tree_chunk * W);
}

template <int WMAX, int CMAX, typename Acc>
cudaError_t launch(const float* x, const uint8_t* valid, const int* feat,
                   const float* thr, const uint32_t* masks,
                   const uint32_t* init_idx, const float* leaf_val,
                   const int* stage_bounds, const float* consts, Acc* out,
                   int* exit_stage, int B, int d, int N, int W, int L, int C,
                   int K, int tree_chunk, int gate_kind, int votes,
                   cudaStream_t stream) {
  const dim3 grid((B + kRows - 1) / kRows);
  cascade_kernel<WMAX, CMAX, Acc>
      <<<grid, kThreads, shared_bytes(N, W, C, tree_chunk), stream>>>(
          x, valid, feat, thr, masks, init_idx, leaf_val, stage_bounds,
          consts, out, exit_stage, B, d, N, W, L, C, K, tree_chunk,
          gate_kind, votes);
  return cudaGetLastError();
}

template <int WMAX, typename Acc>
cudaError_t dispatch_classes(int C, const float* x, const uint8_t* valid,
                             const int* feat, const float* thr,
                             const uint32_t* masks, const uint32_t* init_idx,
                             const float* leaf_val, const int* stage_bounds,
                             const float* consts, Acc* out, int* exit_stage,
                             int B, int d, int N, int W, int L, int K,
                             int tree_chunk, int gate_kind, int votes,
                             cudaStream_t s) {
  if (C <= 1)
    return launch<WMAX, 1, Acc>(x, valid, feat, thr, masks, init_idx,
                                leaf_val, stage_bounds, consts, out,
                                exit_stage, B, d, N, W, L, C, K, tree_chunk,
                                gate_kind, votes, s);
  if (C <= 4)
    return launch<WMAX, 4, Acc>(x, valid, feat, thr, masks, init_idx,
                                leaf_val, stage_bounds, consts, out,
                                exit_stage, B, d, N, W, L, C, K, tree_chunk,
                                gate_kind, votes, s);
  return launch<WMAX, 16, Acc>(x, valid, feat, thr, masks, init_idx,
                               leaf_val, stage_bounds, consts, out,
                               exit_stage, B, d, N, W, L, C, K, tree_chunk,
                               gate_kind, votes, s);
}

template <typename Acc>
cudaError_t dispatch(const float* x, const uint8_t* valid, const int* feat,
                     const float* thr, const uint32_t* masks,
                     const uint32_t* init_idx, const float* leaf_val,
                     const int* stage_bounds, const float* consts, Acc* out,
                     int* exit_stage, int B, int d, int N, int W, int L,
                     int C, int K, int tree_chunk, int gate_kind, int votes,
                     cudaStream_t s) {
  if (W <= 1)
    return dispatch_classes<1, Acc>(C, x, valid, feat, thr, masks, init_idx,
                                    leaf_val, stage_bounds, consts, out,
                                    exit_stage, B, d, N, W, L, K, tree_chunk,
                                    gate_kind, votes, s);
  if (W <= 2)
    return dispatch_classes<2, Acc>(C, x, valid, feat, thr, masks, init_idx,
                                    leaf_val, stage_bounds, consts, out,
                                    exit_stage, B, d, N, W, L, K, tree_chunk,
                                    gate_kind, votes, s);
  if (W <= 4)
    return dispatch_classes<4, Acc>(C, x, valid, feat, thr, masks, init_idx,
                                    leaf_val, stage_bounds, consts, out,
                                    exit_stage, B, d, N, W, L, K, tree_chunk,
                                    gate_kind, votes, s);
  return dispatch_classes<8, Acc>(C, x, valid, feat, thr, masks, init_idx,
                                  leaf_val, stage_bounds, consts, out,
                                  exit_stage, B, d, N, W, L, K, tree_chunk,
                                  gate_kind, votes, s);
}

}  // namespace

extern "C" {

// Scores (B, C) into `out` (f32, or int32 when int_accum != 0) and exit
// stages (B,) int32 into `exit_stage`.  valid is (B,) bytes; feat, thr,
// masks, init_idx and leaf_val are the stage-concatenated kernel arrays
// (masks and init_idx uint32 bit patterns); stage_bounds (K + 1,) int32
// tree offsets into them; consts the gate's f32 array (see kInvScale...).
// Every array is contiguous and on the current device.  Returns a
// cudaError_t: 0 when the kernel was launched.
int cascade_qs_forward_launch(const void* x, const void* valid,
                              const void* feat, const void* thr,
                              const void* masks, const void* init_idx,
                              const void* leaf_val, const void* stage_bounds,
                              const void* consts, void* out, void* exit_stage,
                              int B, int d, int N, int W, int L, int C, int K,
                              int tree_chunk, int gate_kind, int votes,
                              int int_accum, void* stream) {
  if (B < 1 || d < 1 || N < 0 || W < 1 || W > 8 || C < 1 || C > 16 ||
      L < 1 || L > 32 * W || K < 1 || tree_chunk < 1 || gate_kind < 0 ||
      gate_kind > 3 || shared_bytes(N, W, C, tree_chunk) > kMaxSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* va = static_cast<const uint8_t*>(valid);
  const auto* ft = static_cast<const int*>(feat);
  const auto* th = static_cast<const float*>(thr);
  const auto* mk = static_cast<const uint32_t*>(masks);
  const auto* ii = static_cast<const uint32_t*>(init_idx);
  const auto* lv = static_cast<const float*>(leaf_val);
  const auto* sb = static_cast<const int*>(stage_bounds);
  const auto* cs = static_cast<const float*>(consts);
  auto* ex = static_cast<int*>(exit_stage);
  auto s = static_cast<cudaStream_t>(stream);
  if (int_accum)
    return static_cast<int>(dispatch<int>(
        xf, va, ft, th, mk, ii, lv, sb, cs, static_cast<int*>(out), ex, B, d,
        N, W, L, C, K, tree_chunk, gate_kind, votes, s));
  return static_cast<int>(dispatch<float>(
      xf, va, ft, th, mk, ii, lv, sb, cs, static_cast<float*>(out), ex, B, d,
      N, W, L, C, K, tree_chunk, gate_kind, votes, s));
}

const char* cascade_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
