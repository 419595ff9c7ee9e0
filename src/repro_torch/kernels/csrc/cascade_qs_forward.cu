// Fused confidence-gated cascade over QuickScorer bitvector stages, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `cascade_qs_forward` in
// src/repro/kernels/cascade_kernel.py:88 (body `_cascade_qs_kernel` :38).
// Same function: each row walks the K stages in order.  A stage adds the
// QuickScorer leaf sum over its trees (the traversal of qs_forward.cu);
// after every stage but the last the gate decides, on the row's running
// scores times inv_scale, whether the row exits; an exited row records
// its stage and keeps its scores.  Rows with valid = 0 score 0 and exit
// at K - 1, and a tile whose rows have all exited skips the remaining
// stages.  Float forests sum in f32, int-accum forests in int32 (the TPU
// kernel sums in f32, exact below 2^24).
//
// What bounds it on an H100.  It reads x (B*d*4 bytes), the stage-
// concatenated node stream feat/thr/masks (T*N*(8+4W)), init_idx and
// leaf_val, and writes scores (B*C*4) and exit stages (B*4).  Its work
// depends on the data: rows reaching stage k times the trees of stage k
// times N*(1+W) 32-bit instructions (a compare and W predicated ANDs per
// node), plus a leaf add per class.  At the mnist cascade (512 trees in
// stages 16/64/256/512, L=64, d=784, C=10, B=1024) the bytes bound it
// (chip_smoke.py prints both counts from the batch's exit stages).
//
// What the design does about it.
//   * A block is qs_forward's row tile: 32 rows x 8 warps, lane = row,
//     warp = tree slice.  Its rows of x sit in shared memory feature-major
//     at stride 33 (tile_common.cuh), 103,488 bytes at d = 784 (dynamic
//     shared memory, opted in), so a warp's read of one feature over its
//     rows is one wavefront.  Where 32 rows of x do not fit (d above
//     ~1600), the kSmemX = false instance reads x from global memory; the
//     wrapper counts which route ran.
//   * Node records {feat, thr, W mask words} (16 bytes at W <= 2) reach a
//     two-stage cp.async ring `chunk` trees at a time, each tree's run
//     padded to whole groups of nodes; the next chunk is copied while this
//     one is walked, across stage boundaries too, but a chunk never
//     crosses one.  The walk is tile_common.cuh's qs_exit_leaf.  Each
//     tree's leaf row is loaded after its walk and added after the warp's
//     next one.
//   * A thread-block cluster of G blocks shares a row tile: with 32 rows a
//     block, B = 1024 gives 32 tiles, and one block a tile would leave 100
//     of the 132 SMs idle.  Rank r walks the r-th of G contiguous shares of
//     every stage's trees; the shares depend on the stages and G, never on
//     B, so a row's float sum has one order in any batch.  The wrapper
//     takes the largest G whose 32 clusters (1024 rows) the card holds at
//     once (cudaOccupancyMaxActiveClusters): clusters live within a GPC,
//     and at one block an SM an H100 holds 39 clusters of 3 but only 30 of
//     4, so the mnist cascade runs G = 3 on 96 SMs.
//   * At a stage's end each block adds its 8 warps' sums in warp order into
//     its own shared memory (double-buffered by stage parity); after
//     cluster.sync() every block reads the G partials through distributed
//     shared memory and adds them in rank order.  So every block holds the
//     same running scores, bit for bit, and reaches the same gate
//     decisions: no atomics, no second pass.  The buffer of stage k is
//     written again at stage k + 2, after a cluster.sync() that every
//     reader of stage k has passed; a last cluster.sync() keeps each block
//     alive until the others have read it.
//   * The gate runs in warp 0, lane = row, 32 rows at once, on the
//     descaled running scores, with every rounding step explicit
//     (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: nvcc never fuses them
//     into an FMA), the classes summed left to right, ties resolved to the
//     first maximum, and expf for the softmax of logit forests: the
//     arithmetic of the torch `decide` (repro_torch/cascade/policy.py).
//     Built without --use_fast_math, so the division is IEEE.
//   * Registers: __launch_bounds__(256, 1).  With no floor on blocks per
//     SM, ptxas capped the mnist instance at 128 registers and spilled
//     (a bet on two blocks an SM, which the x tile never allows); with it,
//     that instance takes what it needs: CMAX = 16 class accumulators and
//     16 pending leaf values, 4 node records of 4 words in flight, the
//     gate's per-class arrays, the ring cursor.  No instance spills.
//   * What remains, measured (scripts/torch_forest_tiles.py): the walk is
//     bound by shared memory delivering each 16-byte record to 32 lanes,
//     not by latency (8 nodes in flight instead of 4 did not help); the 3
//     gates and the stage boundaries add about a fifth.  Rows are not
//     compacted across tiles: a tile walks a stage while any of its 32
//     rows is active, so at the mnist exit profile (55% of rows reach the
//     last stage) nearly every tile walks every stage (chip_smoke.py
//     prints the share of pairs walked for exited rows).
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (src/repro_torch/kernels/cascade_kernel.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tile_common.cuh"

namespace cg = cooperative_groups;

namespace {

using tile::kRows;
using tile::kThreads;
using tile::kWarps;
using tile::kXStride;
using tile::qs_node_pad;
using tile::record_words;

constexpr int kMaxCluster = 8;            // the portable cluster size

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

// Shared words of a block besides the ring and the x tile: the 8 warps'
// per-row sums (kWarps, kRows, C), the block's stage partials (2, kRows,
// C), the running scores (kRows, C), the active flags and exit stages
// (kRows each) and the tile's any-active flag, padded to 16 bytes.
__host__ __device__ inline int sum_words(int C) {
  return (kWarps * kRows * C + 3 * kRows * C + 2 * kRows + 1 + 3) / 4 * 4;
}

// Shared bytes of a block: the two-stage ring of `chunk` trees, the sums
// above and, for smem_x, the x tile.  The wrapper passes what
// cascade_layout computed; the entry point checks it against this.
inline size_t shared_bytes(int N, int W, int C, int d, int chunk,
                           bool smem_x) {
  return 4 * (2 * static_cast<size_t>(chunk) * qs_node_pad(N) *
                  record_words(W) +
              sum_words(C) +
              (smem_x ? static_cast<size_t>(kXStride) * d : 0));
}

template <int WMAX, int CMAX, bool kSmemX, typename Acc>
__global__ void __launch_bounds__(kThreads, 1)
cascade_kernel(const float* __restrict__ x, const uint8_t* __restrict__ valid,
               const int* __restrict__ feat, const float* __restrict__ thr,
               const uint32_t* __restrict__ masks,
               const uint32_t* __restrict__ init_idx,
               const float* __restrict__ leaf_val,
               const int* __restrict__ stage_bounds,
               const float* __restrict__ consts, Acc* __restrict__ out,
               int* __restrict__ exit_stage, int B, int d, int N, int W,
               int L, int C, int K, int chunk, int gate_kind, int votes) {
  using R = tile::Record<WMAX>;
  cg::cluster_group cluster = cg::this_cluster();
  const int G = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());

  extern __shared__ uint4 smem[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);
  const int tree_words = qs_node_pad(N) * R::kWords;
  const int chunk_words = chunk * tree_words;
  Acc* part = reinterpret_cast<Acc*>(ring + 2 * chunk_words);
  Acc* blk = part + kWarps * kRows * C;          // (2, kRows, C)
  Acc* run = blk + 2 * kRows * C;                // (kRows, C)
  int* act = reinterpret_cast<int*>(run + kRows * C);
  int* exits = act + kRows;
  int* any_active = exits + kRows;
  float* x_s = reinterpret_cast<float*>(ring + 2 * chunk_words) +
               sum_words(C);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row0 = blockIdx.y * kRows;
  const int row = row0 + lane;
  if (warp == 0) {
    act[lane] = row < B && valid[row] != 0;
    exits[lane] = K - 1;
  }
  for (int i = threadIdx.x; i < kRows * C; i += kThreads) run[i] = Acc(0);

  // this rank's share of stage k: trees [lo, hi) of G contiguous shares
  auto share = [&](int k, int* lo, int* hi) {
    const int a = __ldg(stage_bounds + k), b = __ldg(stage_bounds + k + 1);
    const int per = (b - a + G - 1) / G;
    *lo = min(b, a + rank * per);
    *hi = min(b, *lo + per);
  };
  // The rank's chunks in order, stage by stage: the fetch cursor (fk, ft)
  // is the next chunk to copy, `fetched` the chunks copied so far.
  int fk = 0, ft = 0, f_hi = 0, fetched = 0;
  share(0, &ft, &f_hi);
  auto fetch = [&]() -> bool {
    while (fk < K && ft >= f_hi) {
      if (++fk < K) share(fk, &ft, &f_hi);
    }
    if (fk == K) return false;
    const int tc = min(chunk, f_hi - ft);
    tile::stage_records(ring + (fetched % 2) * chunk_words, ft, tc, N, W,
                        R::kWords, feat, thr, masks);
    tile::cp_async_commit();
    ft += tc;
    ++fetched;
    return true;
  };

  // rows past B: x_s holds zeros; the global route reads row B - 1
  const float* xr = x + static_cast<size_t>(min(row, B - 1)) * d;
  const float inv_scale = consts[kInvScale];
  bool any = __syncthreads_or(row < B && valid[row] != 0);
  if (any) {
    if (kSmemX) tile::stage_x(x_s, x, row0, B, d);
    tile::pad_records(ring, 2 * chunk, N, R::kWords);
    if (!fetch()) tile::cp_async_commit();      // the x tile alone
  }

  int used = 0;                                 // chunks walked
  const bool pairs =
      C % 2 == 0 && reinterpret_cast<uintptr_t>(leaf_val) % 8 == 0;
  for (int k = 0; k < K && any; ++k) {
    // each tree's leaf row is loaded after its walk (8 bytes a load where
    // C is even and the rows are so aligned) and added after the warp's
    // next walk, which hides the gather's latency
    Acc acc[CMAX];
    float pend[CMAX];
#pragma unroll
    for (int c = 0; c < CMAX; ++c) acc[c] = Acc(0);
    bool have = false;
    int lo, hi;
    share(k, &lo, &hi);
    for (int t0 = lo; t0 < hi; t0 += chunk, ++used) {
      if (fetch())
        tile::cp_async_wait<1>();
      else
        tile::cp_async_wait<0>();
      __syncthreads();
      const uint32_t* recs = ring + (used % 2) * chunk_words;
      const int tc = min(chunk, hi - t0);
      for (int slot = warp; slot < tc; slot += kWarps) {
        const int t = t0 + slot;
        const int leaf = tile::qs_exit_leaf<WMAX, kSmemX>(
            reinterpret_cast<const uint4*>(recs + slot * tree_words),
            init_idx + static_cast<size_t>(t) * W, N, W, x_s, xr, lane);
        const float* lv =
            leaf_val + (static_cast<size_t>(t) * L + leaf) * C;
#pragma unroll
        for (int c = 0; c < CMAX; ++c)
          if (have && c < C) acc[c] += static_cast<Acc>(pend[c]);
        if (pairs) {
          const float2* lv2 = reinterpret_cast<const float2*>(lv);
#pragma unroll
          for (int c = 0; c < CMAX / 2; ++c) {
            if (2 * c < C) {
              const float2 v = __ldg(lv2 + c);
              pend[2 * c] = v.x;
              pend[2 * c + 1] = v.y;
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < CMAX; ++c)
            if (c < C) pend[c] = __ldg(lv + c);
        }
        have = true;
      }
      __syncthreads();                          // ring stage free again
    }
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (have && c < C) acc[c] += static_cast<Acc>(pend[c]);

    // the block's stage partial: its 8 warps' sums in warp order
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < C) part[(warp * kRows + lane) * C + c] = acc[c];
    __syncthreads();
    Acc* mine = blk + (k & 1) * kRows * C;
    for (int i = threadIdx.x; i < kRows * C; i += kThreads) {
      Acc s = part[i];
      for (int w = 1; w < kWarps; ++w) s += part[w * kRows * C + i];
      mine[i] = s;
    }
    cluster.sync();
    // the stage sum: the G partials in rank order, for the active rows
    for (int i = threadIdx.x; i < kRows * C; i += kThreads) {
      if (!act[i / C]) continue;
      Acc s = *cluster.map_shared_rank(mine + i, 0);
      for (int q = 1; q < G; ++q) s += *cluster.map_shared_rank(mine + i, q);
      run[i] += s;
    }
    __syncthreads();

    // the gate: warp 0, lane = row
    if (warp == 0) {
      bool still = act[lane] != 0;
      if (still && k < K - 1 && gate_kind != kNever) {
        float sc[CMAX];
#pragma unroll
        for (int c = 0; c < CMAX; ++c)
          if (c < C)
            sc[c] = __fmul_rn(static_cast<float>(run[lane * C + c]),
                              inv_scale);
        const bool ex =
            gate_kind == kScoreBound
                ? bound_exits<CMAX>(sc, C, consts + kRest + k * C,
                                    consts + kRest + (K - 1) * C + k * C,
                                    consts)
                : confidence_exits<CMAX>(sc, C, gate_kind, votes, consts);
        if (ex) {
          still = false;
          exits[lane] = k;
          act[lane] = 0;
        }
      }
      const bool some = __any_sync(0xFFFFFFFFu, still);
      if (lane == 0) *any_active = some;
    }
    __syncthreads();
    any = *any_active != 0;
  }

  tile::cp_async_wait<0>();     // a chunk copied for a stage never walked
  cluster.sync();               // no block leaves while others read it
  if (rank == 0) {
    for (int i = threadIdx.x; i < kRows * C; i += kThreads)
      if (row0 + i / C < B) out[static_cast<size_t>(row0) * C + i] = run[i];
    if (warp == 0 && row < B) exit_stage[row] = exits[lane];
  }
}

struct Args {
  const float* x;
  const uint8_t* valid;
  const int* feat;
  const float* thr;
  const uint32_t* masks;
  const uint32_t* init_idx;
  const float* leaf_val;
  const int* stage_bounds;
  const float* consts;
  void* out;
  int* exit_stage;
  int B, d, N, W, L, C, K, chunk, cluster, shared, gate_kind, votes;
};

// Launch the kernel as clusters of a.cluster blocks, or, with
// `max_clusters`, only ask how many such clusters can be resident at once.
template <int WMAX, int CMAX, bool kSmemX, typename Acc>
cudaError_t launch(const Args& a, cudaStream_t stream, int* max_clusters) {
  auto kernel = cascade_kernel<WMAX, CMAX, kSmemX, Acc>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.shared);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, (a.B + kRows - 1) / kRows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.shared;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(
        max_clusters, reinterpret_cast<const void*>(kernel), &cfg);
  err = cudaLaunchKernelEx(
      &cfg, kernel, a.x, a.valid, a.feat, a.thr, a.masks, a.init_idx,
      a.leaf_val, a.stage_bounds, a.consts, static_cast<Acc*>(a.out),
      a.exit_stage, a.B, a.d, a.N, a.W, a.L, a.C, a.K, a.chunk, a.gate_kind,
      a.votes);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int WMAX, int CMAX, typename Acc>
cudaError_t dispatch_route(bool smem_x, const Args& a, cudaStream_t s,
                           int* q) {
  return smem_x ? launch<WMAX, CMAX, true, Acc>(a, s, q)
                : launch<WMAX, CMAX, false, Acc>(a, s, q);
}

template <int WMAX, typename Acc>
cudaError_t dispatch_classes(bool smem_x, const Args& a, cudaStream_t s,
                             int* q) {
  if (a.C <= 1) return dispatch_route<WMAX, 1, Acc>(smem_x, a, s, q);
  if (a.C <= 4) return dispatch_route<WMAX, 4, Acc>(smem_x, a, s, q);
  return dispatch_route<WMAX, 16, Acc>(smem_x, a, s, q);
}

template <typename Acc>
cudaError_t dispatch(bool smem_x, const Args& a, cudaStream_t s, int* q) {
  if (a.W <= 1) return dispatch_classes<1, Acc>(smem_x, a, s, q);
  if (a.W <= 2) return dispatch_classes<2, Acc>(smem_x, a, s, q);
  if (a.W <= 4) return dispatch_classes<4, Acc>(smem_x, a, s, q);
  return dispatch_classes<8, Acc>(smem_x, a, s, q);
}

cudaError_t run(const Args& a, int smem_x, int int_accum, cudaStream_t s,
                int* q) {
  if (a.B < 1 || a.B > 65535 * kRows || a.d < 1 || a.N < 0 || a.W < 1 ||
      a.W > 8 || a.C < 1 || a.C > 16 || a.L < 1 || a.L > 32 * a.W ||
      a.K < 1 || a.chunk < 1 || a.cluster < 1 || a.cluster > kMaxCluster ||
      a.gate_kind < 0 || a.gate_kind > 3 || a.shared < 0 ||
      static_cast<size_t>(a.shared) > tile::kMaxSharedBytes ||
      static_cast<size_t>(a.shared) !=
          shared_bytes(a.N, a.W, a.C, a.d, a.chunk, smem_x != 0))
    return cudaErrorInvalidValue;
  return int_accum ? dispatch<int>(smem_x != 0, a, s, q)
                   : dispatch<float>(smem_x != 0, a, s, q);
}

}  // namespace

extern "C" {

// Scores (B, C) into `out` (f32, or int32 when int_accum != 0) and exit
// stages (B,) int32 into `exit_stage`.  valid is (B,) bytes; feat, thr,
// masks, init_idx and leaf_val are the stage-concatenated kernel arrays
// (masks and init_idx uint32 bit patterns); stage_bounds (K + 1,) int32
// tree offsets into them; consts the gate's f32 array (see kInvScale...).
// Clusters of `cluster` blocks share a 32-row tile; a block stages `chunk`
// trees at a time; `smem_x` != 0 stages its rows of x in shared memory;
// `shared` is the block's dynamic shared bytes, which must equal
// shared_bytes().  Every array is contiguous and on the current device.
// Returns a cudaError_t: 0 when the kernel was launched.
int cascade_qs_forward_launch(const void* x, const void* valid,
                              const void* feat, const void* thr,
                              const void* masks, const void* init_idx,
                              const void* leaf_val, const void* stage_bounds,
                              const void* consts, void* out, void* exit_stage,
                              int B, int d, int N, int W, int L, int C, int K,
                              int chunk, int cluster, int smem_x, int shared,
                              int gate_kind, int votes, int int_accum,
                              void* stream) {
  const Args a{static_cast<const float*>(x),
               static_cast<const uint8_t*>(valid),
               static_cast<const int*>(feat),
               static_cast<const float*>(thr),
               static_cast<const uint32_t*>(masks),
               static_cast<const uint32_t*>(init_idx),
               static_cast<const float*>(leaf_val),
               static_cast<const int*>(stage_bounds),
               static_cast<const float*>(consts),
               out,
               static_cast<int*>(exit_stage),
               B, d, N, W, L, C, K, chunk, cluster, shared, gate_kind, votes};
  return static_cast<int>(
      run(a, smem_x, int_accum, static_cast<cudaStream_t>(stream), nullptr));
}

// How many clusters of the instance for (W, C, smem_x, int_accum) with
// `cluster` blocks of `shared` bytes the current device can hold at once,
// into *max_clusters (0: the launch could never run).  Returns a
// cudaError_t.
int cascade_max_active_clusters(int d, int N, int W, int L, int C,
                                int chunk, int cluster, int smem_x,
                                int shared, int int_accum,
                                int* max_clusters) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, nullptr, nullptr, nullptr,
               kRows, d, N, W, L, C, 1, chunk, cluster, shared, 0, 0};
  *max_clusters = 0;
  return static_cast<int>(run(a, smem_x, int_accum, nullptr, max_clusters));
}

const char* cascade_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
