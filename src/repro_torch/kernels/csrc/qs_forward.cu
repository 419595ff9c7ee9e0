// QuickScorer bitvector traversal for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `qs_forward` in
// src/repro/kernels/quickscorer_kernel.py:130 (body `_qs_kernel` :107 ->
// `qs_tile_scores` :50).  Same function: for every (row, tree), the nodes
// whose predicate x[feat] > thr fires (NaN does not: it goes left) AND
// their interval masks into the tree's W-word leafidx, `& init_idx`; the
// exit leaf is the lowest set bit; leaf_val[t, leaf, :] is summed over
// trees.  Float forests sum in f32, int-accum forests in int32.
//
// What bounds it on an H100.  Per call it reads x (B*d*4 bytes), the node
// stream feat/thr/masks (T*N*(8+4W)), init_idx (T*W*4) and leaf_val
// (T*L*C*4), and writes (B*C*4).  At T=1024, L=64 (N=63, W=2), d=136, C=1,
// B=1024 that is 1.86 MB: 0.56 us at 3.35 TB/s.  The work is
// B*T*N*(1+W) 32-bit instructions (one compare per node and one AND per
// word, predicated on it; ~2.0e8 here) plus B*T*C adds: 3.0 us at the
// 67 T op/s of the card's non-tensor f32 peak, which is twice the rate at
// which it issues such instructions.  So the bound is 3.0 us, by
// operations, not bytes.
//
// What held the first kernel (one thread per row, x gathered from global
// memory) at 0.53 ms: per node, the 32 lanes of a warp read x[row_lane,
// feat] from 32 rows d*4 bytes apart, 32 cache lines and 32 L1 wavefronts
// per warp instruction, ~66 M lane reads at the MSN shape.  This kernel
// stages x instead:
//   * A block is 32 rows x 8 warps: lane = row, warp = tree slice.  Its
//     rows of x sit in shared memory feature-major, x_s[f * 33 + lane]
//     (33: the tile is written row by row from coalesced global reads
//     without bank conflicts), so a warp's gather of one feature over its
//     32 rows reads 32 consecutive banks: one wavefront.  17 KB at d=136,
//     101 KB at mnist's d=784 (dynamic shared memory, opted in).
//   * Node records.  A tree's nodes are packed in shared memory as one
//     record each, {feat, thr, mask words}, 16 bytes for W <= 2 (32 for
//     W <= 4, 48 for W <= 8); all lanes of a warp read the same record, a
//     broadcast.  A chunk of `chunk` trees is staged by cp.async into a
//     two-stage ring while the previous chunk is traversed, each tree's
//     run padded with never-firing records to a multiple of 8 nodes, so
//     the walk has no tail of single nodes.
//   * The node loop is unrolled by kQsUnroll: the records of kQsUnroll
//     nodes are loaded, then their x values, then the compares and ANDs,
//     so the dependent pair of shared-memory loads of several nodes is in
//     flight at once.  leafidx lives in registers (W <= 8, so L <= 256),
//     updated branch-free: leafidx &= mask | keep.  The exit leaf is __ffs
//     of the lowest nonzero word.  The records, the x tile and this walk
//     are tile_common.cuh's, shared with cascade_qs_forward.cu.
//   * Grid: ceil(B/32) row blocks x tree groups; the wrapper
//     (quickscorer_kernel.qs_layout) picks the group size so that a batch
//     of 1024 rows fills the SMs in one wave, and never from B.  Each block
//     writes partial[group, row, :]: its 8 warps' sums added in warp order
//     in shared memory.  A second kernel sums the groups in order.  No
//     atomics, so a float forest gives the same bits on every run and for
//     a row in any batch.
//   * Where 32 rows of x do not fit in shared memory (d above ~1700), the
//     kSmemX = false instance reads x from global memory as the first
//     kernel did; the wrapper counts which route ran.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (src/repro_torch/kernels/quickscorer_kernel.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_common.cuh"

namespace {

using tile::kRows;
using tile::kThreads;
using tile::kWarps;
using tile::kXStride;
using tile::qs_node_pad;
using tile::record_words;

// Shared bytes of a block: the ring (or, after the tree loop, the 8 warps'
// partial sums) and, for kSmemX, the x tile.  The wrapper passes what
// qs_layout computed; the entry point checks it against this.
inline size_t shared_bytes(int N, int W, int C, int d, int chunk,
                           bool smem_x) {
  const size_t ring =
      2 * static_cast<size_t>(chunk) * qs_node_pad(N) * record_words(W);
  const size_t part = static_cast<size_t>(kWarps) * kRows * C;
  return 4 * ((ring > part ? ring : part) +
              (smem_x ? static_cast<size_t>(kXStride) * d : 0));
}

template <int WMAX, int CMAX, bool kSmemX, typename Acc>
__global__ void __launch_bounds__(kThreads)
qs_tile_kernel(const float* __restrict__ x, const int* __restrict__ feat,
               const float* __restrict__ thr,
               const uint32_t* __restrict__ masks,
               const uint32_t* __restrict__ init_idx,
               const float* __restrict__ leaf_val, Acc* __restrict__ partial,
               int B, int d, int T, int N, int W, int L, int C, int chunk,
               int group_trees) {
  using R = tile::Record<WMAX>;
  extern __shared__ uint4 smem[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);
  const int tree_words = qs_node_pad(N) * R::kWords;
  const int chunk_words = chunk * tree_words;
  const int ring_words = max(2 * chunk_words, kWarps * kRows * C);
  float* x_s = reinterpret_cast<float*>(ring + ring_words);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row0 = blockIdx.x * kRows;
  const int t_begin = blockIdx.y * group_trees;
  const int t_end = min(T, t_begin + group_trees);
  const int n_chunks = (t_end - t_begin + chunk - 1) / chunk;

  if (kSmemX) tile::stage_x(x_s, x, row0, B, d);
  tile::pad_records(ring, 2 * chunk, N, R::kWords);
  // chunk c's records into ring stage c % 2
  auto stage = [&](int c) {
    const int t0 = t_begin + c * chunk;
    tile::stage_records(ring + (c % 2) * chunk_words, t0,
                        min(chunk, t_end - t0), N, W, R::kWords, feat, thr,
                        masks);
    tile::cp_async_commit();
  };

  // rows past B: x_s holds zeros; the global route reads row B - 1
  const float* xr = x + static_cast<size_t>(min(row0 + lane, B - 1)) * d;
  Acc acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = Acc(0);

  if (n_chunks > 0) stage(0);              // with the x tile's copies
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      stage(c + 1);
      tile::cp_async_wait<1>();
    } else {
      tile::cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t* recs = ring + (c % 2) * chunk_words;
    const int t0 = t_begin + c * chunk;
    const int tc = min(chunk, t_end - t0);
    for (int slot = warp; slot < tc; slot += kWarps) {
      const int t = t0 + slot;
      const int leaf = tile::qs_exit_leaf<WMAX, kSmemX>(
          reinterpret_cast<const uint4*>(recs + slot * tree_words),
          init_idx + static_cast<size_t>(t) * W, N, W, x_s, xr, lane);
      const float* lv = leaf_val + (static_cast<size_t>(t) * L + leaf) * C;
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (c < C) acc[c] += static_cast<Acc>(__ldg(lv + c));
    }
    __syncthreads();                       // stage c % 2 is free again
  }

  // the 8 warps' sums per row, added in warp order
  tile::write_partial<CMAX, Acc>(acc, reinterpret_cast<Acc*>(ring), partial,
                                 blockIdx.y, row0, B, C);
}

struct Args {
  const float* x;
  const int* feat;
  const float* thr;
  const uint32_t* masks;
  const uint32_t* init_idx;
  const float* leaf_val;
  int B, d, T, N, W, L, C, chunk, group_trees, shared;
};

template <int WMAX, int CMAX, bool kSmemX, typename Acc>
cudaError_t launch(const Args& a, Acc* partial, Acc* out,
                   cudaStream_t stream) {
  const int n_groups =
      a.T > 0 ? (a.T + a.group_trees - 1) / a.group_trees : 0;
  if (n_groups > 0) {
    auto kernel = qs_tile_kernel<WMAX, CMAX, kSmemX, Acc>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.shared);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.B + kRows - 1) / kRows, n_groups);
    kernel<<<grid, kThreads, a.shared, stream>>>(
        a.x, a.feat, a.thr, a.masks, a.init_idx, a.leaf_val, partial, a.B,
        a.d, a.T, a.N, a.W, a.L, a.C, a.chunk, a.group_trees);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return tile::reduce_groups(partial, out, n_groups, a.B * a.C, stream);
}

template <int WMAX, int CMAX, typename Acc>
cudaError_t dispatch_route(bool smem_x, const Args& a, Acc* partial,
                           Acc* out, cudaStream_t s) {
  return smem_x ? launch<WMAX, CMAX, true, Acc>(a, partial, out, s)
                : launch<WMAX, CMAX, false, Acc>(a, partial, out, s);
}

template <int WMAX, typename Acc>
cudaError_t dispatch_classes(bool smem_x, const Args& a, Acc* partial,
                             Acc* out, cudaStream_t s) {
  if (a.C <= 1)
    return dispatch_route<WMAX, 1, Acc>(smem_x, a, partial, out, s);
  if (a.C <= 4)
    return dispatch_route<WMAX, 4, Acc>(smem_x, a, partial, out, s);
  return dispatch_route<WMAX, 16, Acc>(smem_x, a, partial, out, s);
}

template <typename Acc>
cudaError_t dispatch(bool smem_x, const Args& a, Acc* partial, Acc* out,
                     cudaStream_t s) {
  if (a.W <= 1) return dispatch_classes<1, Acc>(smem_x, a, partial, out, s);
  if (a.W <= 2) return dispatch_classes<2, Acc>(smem_x, a, partial, out, s);
  if (a.W <= 4) return dispatch_classes<4, Acc>(smem_x, a, partial, out, s);
  return dispatch_classes<8, Acc>(smem_x, a, partial, out, s);
}

}  // namespace

extern "C" {

// Scores (B, C) into `out` (f32, or int32 when int_accum != 0), using
// `partial` (ceil(T / group_trees), B, C) of the same type as scratch.
// A block stages `chunk` trees at a time and walks `group_trees` trees;
// `smem_x` != 0 stages its 32 rows of x in shared memory; `shared` is the
// block's dynamic shared bytes, which must equal shared_bytes().  Every
// array is contiguous and on the current device; masks and init_idx are
// uint32 bit patterns.  Returns a cudaError_t: 0 when both kernels were
// launched.
int qs_forward_launch(const void* x, const void* feat, const void* thr,
                      const void* masks, const void* init_idx,
                      const void* leaf_val, void* partial, void* out, int B,
                      int d, int T, int N, int W, int L, int C, int chunk,
                      int group_trees, int smem_x, int shared,
                      int int_accum, void* stream) {
  if (B < 1 || d < 1 || T < 0 || N < 0 || W < 1 || W > 8 || C < 1 ||
      C > 16 || L < 1 || L > 32 * W || chunk < 1 || group_trees < chunk ||
      shared < 0 || static_cast<size_t>(shared) > tile::kMaxSharedBytes ||
      static_cast<size_t>(shared) !=
          shared_bytes(N, W, C, d, chunk, smem_x != 0) ||
      (T + group_trees - 1) / group_trees > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(x), static_cast<const int*>(feat),
               static_cast<const float*>(thr),
               static_cast<const uint32_t*>(masks),
               static_cast<const uint32_t*>(init_idx),
               static_cast<const float*>(leaf_val), B, d, T, N, W, L, C,
               chunk, group_trees, shared};
  auto s = static_cast<cudaStream_t>(stream);
  if (int_accum)
    return static_cast<int>(dispatch<int>(smem_x != 0, a,
                                          static_cast<int*>(partial),
                                          static_cast<int*>(out), s));
  return static_cast<int>(dispatch<float>(smem_x != 0, a,
                                          static_cast<float*>(partial),
                                          static_cast<float*>(out), s));
}

const char* qs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
