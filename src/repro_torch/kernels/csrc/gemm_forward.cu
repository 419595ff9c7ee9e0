// GEMM (Hummingbird-style) forest traversal for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `gemm_forward` in
// src/repro/kernels/gemm_forest_kernel.py:58 (body `_gemm_kernel` :19).
// Same function: for every (row, tree),
//   S_n = x[feat_n] <= thr_n in {0, 1}    (padding nodes: thr = -inf),
//   R_l = sum_n S_n * A[n, l]             (A in {-1, 0, +1}),
//   hit_l = (R_l == Bvec_l)               (padding leaves: Bvec = L + 1),
// and the leaf values of every hit are summed over leaves and trees, in f32
// for float forests and in int32 for int-accum ones.  Every hit is summed,
// as the TPU kernel's hit @ leaf_val does; a real tree has exactly one.
//
// What bounds it on an H100.  The bulk of the function is one product per
// tree, R = S.A: 2*B*T*N*L operations, ~8.5e9 at T=1024, L=64 (N=63), C=1,
// B=1024.  S in {0,1}, A in {-1,0,1} and |R| <= N are exact in int8 with
// int32 accumulation, so the least time for it is that count at the dense
// int8 tensor rate of 1979 T op/s: 4.3 us.  Beside it, on the other pipes,
// run a compare per node, an equality test per leaf and a leaf add per
// tree (one hit each), B*T*(N+L+C) ~ 1.3e8 32-bit operations: 2.0 us at
// 67 T op/s.  The bytes are x (B*d*4), feat/thr (T*N*8), A (T*L*Npad as
// int8), Bvec (T*L*4) and leaf_val (T*L*C*4) read and B*C*4 written:
// about 5 MB, 1.6 us at 3.35 TB/s.  So the bound is 4.27 us, by
// operations (chip_smoke.py, Kernel.work).
//
// What held the first kernel (PR 12: one thread per row, 128 rows a
// block) at 0.51 ms: every node's x[row, feat] was an __ldg gather in
// which the 32 lanes of a warp read 32 rows d*4 bytes apart, 32 cache
// lines and 32 L1 wavefronts per warp instruction (~66 M lane reads at
// the MSN shape); and R ran on the CUDA cores, 4*FW popcount operations
// per leaf over +1/-1 node bit masks, 512 per tree at L = 64.
//
// What this kernel does:
//   * The x tile (csrc/tile_common.cuh, as csrc/qs_forward.cu does it).  A
//     block is 32 rows x 8 warps, lane = row, warp = tree slice.  Its rows
//     of x sit in shared memory feature-major at stride 33, so a warp's
//     gather of one feature over its rows is one wavefront.  Lane = row
//     tests its row against a tree's nodes, {feat, thr} records read as
//     broadcasts, into ceil(N/32) words of S: the records are padded with
//     zeros to whole words of 32 nodes, so a word's loop is unrolled and
//     each condition sets its bit with one predicated OR.  Rows too wide
//     for the tile (the kSmemX = false instance) gather x from global
//     memory; the wrapper counts which route ran.
//   * R = S.A on the int8 tensor cores, mma.sync.m16n8k32 (u8 S x s8 A,
//     int32 accumulators): per tree (32 rows x Npad) . (Npad x L), two m16
//     tiles x ceil(L/8) n8 tiles x Npad/32 k-steps.  The A fragment is
//     made in registers from the words of S: row r's words are shuffled to
//     the lanes of its fragment and each nibble is spread to four 0/1
//     bytes.  wgmma is not used: its 64-row M would need 64 rows a block,
//     and its asynchrony buys nothing when the A operand is made fresh in
//     registers for every tree; the tensor work is ~4.3 us of the whole.
//   * hit = (R == Bvec) on each n-tile's accumulator fragment as it comes
//     out, so no thread holds all L sums: four n-tiles make a 32-leaf hit
//     word per row, ORed across the quad and shuffled to lane = row, which
//     adds leaf_val[t, l, :] for every hit l in ascending order; each
//     hit's load is added at the next hit (a tree later, as a rule), so
//     its latency hides behind that tree.
//   * Operands in the layout the tensor cores read, made once per forest
//     by kernels/ops.py::_gemm_arrays: A as int8, K-major per tree,
//     (T, L, Npad) with Npad = N rounded up to 32, zero past N.  A chunk
//     of 8 trees' records, A and Bvec reach shared memory through a
//     two-stage cp.async ring while the previous chunk is traversed, each
//     warp staging one tree with no runtime division; there A takes L
//     rounded up to 8 rows (the columns past L are never read out), Npad +
//     16 bytes apart, so fragment loads are free of bank conflicts.
//   * Tree groups sized for 1024 rows, never from B (launch.tile_layout):
//     each block writes partial[group, row, :], its 8 warps' sums added in
//     warp order; a second kernel sums the groups in order.  No atomics,
//     so a float forest's row gives the same bits in any batch.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (src/repro_torch/kernels/gemm_forest_kernel.py).

#include <limits.h>

#include "tile_common.cuh"

namespace {

using namespace tile;

// Bytes of one tree in the ring: its node records, L8 rows of A and L8
// Bvec words.
__host__ __device__ inline int tree_bytes(int N, int L) {
  const int l8 = round_up(L, 8);
  return node_bytes(N) + l8 * row_bytes(N) + 4 * l8;
}

// v[mt][h] of the fragment lanes 4*(lane%8).. → lane = row: row r is
// m-tile r/16, half (r/8)%2 of the lanes 4*(r%8)..4*(r%8)+3 (which, after
// a quad reduction, all hold it).
__device__ __forceinline__ uint32_t to_row_lane(const uint32_t (&v)[2][2],
                                                int lane) {
  const int src = 4 * (lane & 7);
  const uint32_t v00 = __shfl_sync(0xFFFFFFFFu, v[0][0], src);
  const uint32_t v01 = __shfl_sync(0xFFFFFFFFu, v[0][1], src);
  const uint32_t v10 = __shfl_sync(0xFFFFFFFFu, v[1][0], src);
  const uint32_t v11 = __shfl_sync(0xFFFFFFFFu, v[1][1], src);
  const bool upper = lane & 8;
  return lane < 16 ? (upper ? v01 : v00) : (upper ? v11 : v10);
}

template <int KS, int CMAX, bool kSmemX, typename Acc>
__global__ void __launch_bounds__(kThreads)
gemm_tile_kernel(const float* __restrict__ x, const int* __restrict__ feat,
                 const float* __restrict__ thr,
                 const uint8_t* __restrict__ A, const int* __restrict__ bvec,
                 const float* __restrict__ leaf_val,
                 Acc* __restrict__ partial, int B, int d, int T, int N,
                 int L, int C, int chunk, int group_trees) {
  extern __shared__ uint4 smem[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem);
  const int l8 = round_up(L, 8), n_tiles = l8 / 8;
  const int ks_n = node_pad(N) / 32;       // k-steps of this forest
  const int rb = row_bytes(N);
  const int tb = tree_bytes(N, L);
  const int bvec_off = node_bytes(N) + l8 * rb;
  const int ring_bytes = max(2 * chunk * tb, 4 * kWarps * kRows * C);
  float* x_s = reinterpret_cast<float*>(ring + ring_bytes);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * kRows;
  const int t_begin = blockIdx.y * group_trees;
  const int t_end = min(T, t_begin + group_trees);
  const int n_chunks = (t_end - t_begin + chunk - 1) / chunk;

  if (kSmemX) stage_x(x_s, x, row0, B, d);
  zero_pad_records(ring, 2 * chunk, N, tb);
  auto stage = [&](int c) {
    const int t0 = t_begin + c * chunk;
    stage_trees(ring + (c % 2) * chunk * tb, min(chunk, t_end - t0), t0, N,
                tb, feat, thr, A, 1, L, bvec, L, bvec_off);
    cp_async_commit();
  };

  // rows past B: x_s holds zeros; the global route reads row B - 1
  const float* xr = x + static_cast<size_t>(min(row0 + lane, B - 1)) * d;
  // acc: this row's sum over the warp's trees' hits, in order; lv_next:
  // the last hit's leaf values, loaded while the next tree is traversed
  // and added before the next hit's are loaded
  Acc acc[CMAX];
  float lv_next[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = Acc(0), lv_next[c] = 0.f;

  if (n_chunks > 0) stage(0);              // with the x tile's copies
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      stage(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* trees = ring + (c % 2) * chunk * tb;
    const int t0 = t_begin + c * chunk;
    const int tc = min(chunk, t_end - t0);
    for (int slot = warp; slot < tc; slot += kWarps) {
      const uint8_t* tree = trees + slot * tb;
      uint32_t s[KS];
      condition_words<KS, kSmemX, true>(reinterpret_cast<const uint2*>(tree),
                                        ks_n, x_s, xr, lane, s);
      uint32_t a[2][KS][4];
      a_fragments<KS>(s, lane, a);
      const int* bvec_s = reinterpret_cast<const int*>(tree + bvec_off);
      const float* lv_tree =
          leaf_val + static_cast<size_t>(t0 + slot) * L * C;
      for (int w = 0; 4 * w < n_tiles; ++w) {
        // hit[mt][h] bit 8q + j, then shifted by 2(lane%4): leaf
        // 32w + 8q + 2(lane%4) + j of row 16mt + 8h + lane/4
        uint32_t hit[2][2] = {{0u, 0u}, {0u, 0u}};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int nt = 4 * w + q;
          if (nt >= n_tiles) break;
          int r[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
          const uint32_t* brow = reinterpret_cast<const uint32_t*>(
              tree + node_bytes(N) + (nt * 8 + g) * rb) + t4;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            if (ks < ks_n) {
              const uint32_t b0 = brow[8 * ks], b1 = brow[8 * ks + 4];
              mma_u8s8(r[0], a[0][ks], b0, b1);
              mma_u8s8(r[1], a[1][ks], b0, b1);
            }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = nt * 8 + 2 * t4 + j;
            // |R| <= N, so INT_MIN matches no column past L
            const int bv = col < L ? bvec_s[col] : INT_MIN;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                if (r[mt][2 * h + j] == bv) hit[mt][h] |= 1u << (8 * q + j);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            hit[mt][h] <<= 2 * t4;
            hit[mt][h] |= __shfl_xor_sync(0xFFFFFFFFu, hit[mt][h], 1);
            hit[mt][h] |= __shfl_xor_sync(0xFFFFFFFFu, hit[mt][h], 2);
          }
        uint32_t mine = to_row_lane(hit, lane);
        while (mine != 0u) {
          const int l = 32 * w + __ffs(mine) - 1;
          mine &= mine - 1u;
          const float* lv = lv_tree + static_cast<size_t>(l) * C;
#pragma unroll
          for (int cc = 0; cc < CMAX; ++cc) {
            acc[cc] += static_cast<Acc>(lv_next[cc]);
            lv_next[cc] = cc < C ? __ldg(lv + cc) : 0.f;
          }
        }
      }
    }
    __syncthreads();                       // stage c % 2 is free again
  }
#pragma unroll
  for (int cc = 0; cc < CMAX; ++cc) acc[cc] += static_cast<Acc>(lv_next[cc]);
  write_partial<CMAX, Acc>(acc, reinterpret_cast<Acc*>(ring), partial,
                           blockIdx.y, row0, B, C);
}

struct Args {
  const float* x;
  const int* feat;
  const float* thr;
  const uint8_t* A;
  const int* bvec;
  const float* leaf_val;
  int B, d, T, N, L, C, chunk, group_trees, shared;
};

template <int KS, int CMAX, bool kSmemX, typename Acc>
cudaError_t launch(const Args& a, Acc* partial, Acc* out,
                   cudaStream_t stream) {
  const int n_groups =
      a.T > 0 ? (a.T + a.group_trees - 1) / a.group_trees : 0;
  if (n_groups > 0) {
    auto kernel = gemm_tile_kernel<KS, CMAX, kSmemX, Acc>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.shared);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.B + kRows - 1) / kRows, n_groups);
    kernel<<<grid, kThreads, a.shared, stream>>>(
        a.x, a.feat, a.thr, a.A, a.bvec, a.leaf_val, partial, a.B, a.d, a.T,
        a.N, a.L, a.C, a.chunk, a.group_trees);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return reduce_groups<Acc>(partial, out, n_groups, a.B * a.C, stream);
}

template <int KS, int CMAX, typename Acc>
cudaError_t dispatch_route(bool smem_x, const Args& a, Acc* partial,
                           Acc* out, cudaStream_t s) {
  return smem_x ? launch<KS, CMAX, true, Acc>(a, partial, out, s)
                : launch<KS, CMAX, false, Acc>(a, partial, out, s);
}

template <int KS, typename Acc>
cudaError_t dispatch_classes(bool smem_x, const Args& a, Acc* partial,
                             Acc* out, cudaStream_t s) {
  if (a.C <= 1) return dispatch_route<KS, 1, Acc>(smem_x, a, partial, out, s);
  if (a.C <= 4) return dispatch_route<KS, 4, Acc>(smem_x, a, partial, out, s);
  return dispatch_route<KS, 16, Acc>(smem_x, a, partial, out, s);
}

template <typename Acc>
cudaError_t dispatch(bool smem_x, const Args& a, Acc* partial, Acc* out,
                     cudaStream_t s) {
  const int ks = node_pad(a.N) / 32;
  if (ks <= 1) return dispatch_classes<1, Acc>(smem_x, a, partial, out, s);
  if (ks <= 2) return dispatch_classes<2, Acc>(smem_x, a, partial, out, s);
  if (ks <= 4) return dispatch_classes<4, Acc>(smem_x, a, partial, out, s);
  return dispatch_classes<8, Acc>(smem_x, a, partial, out, s);
}

}  // namespace

extern "C" {

// Scores (B, C) into `out` (f32, or int32 when int_accum != 0), using
// `partial` (ceil(T / group_trees), B, C) of the same type as scratch.
// A (T, L, Npad) int8: A[t, l, n] is the traversal matrix's entry for
// node n and leaf l, zero past N (Npad = N rounded up to 32); Bvec (T, L)
// int32.  A block stages `chunk` trees at a
// time and walks `group_trees` trees; `smem_x` != 0 stages its 32 rows of
// x in shared memory; `shared` is the block's dynamic shared bytes, which
// must equal tile::shared_bytes().  Every array is contiguous and on the
// current device.  Returns a cudaError_t: 0 when both kernels were
// launched.
int gemm_forward_launch(const void* x, const void* feat, const void* thr,
                        const void* A, const void* bvec, const void* leaf_val,
                        void* partial, void* out, int B, int d, int T, int N,
                        int L, int C, int chunk, int group_trees, int smem_x,
                        int shared, int int_accum, void* stream) {
  if (B < 1 || d < 1 || T < 0 || N < 0 || N > 256 || L < 1 || C < 1 ||
      C > 16 || chunk < 1 || group_trees < chunk || shared < 0 ||
      static_cast<size_t>(shared) > kMaxSharedBytes ||
      static_cast<size_t>(shared) !=
          shared_bytes(tree_bytes(N, L), C, d, chunk, smem_x != 0) ||
      (T + group_trees - 1) / group_trees > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(x), static_cast<const int*>(feat),
               static_cast<const float*>(thr),
               static_cast<const uint8_t*>(A), static_cast<const int*>(bvec),
               static_cast<const float*>(leaf_val), B, d, T, N, L, C, chunk,
               group_trees, shared};
  auto s = static_cast<cudaStream_t>(stream);
  if (int_accum)
    return static_cast<int>(dispatch<int>(smem_x != 0, a,
                                          static_cast<int*>(partial),
                                          static_cast<int*>(out), s));
  return static_cast<int>(dispatch<float>(smem_x != 0, a,
                                          static_cast<float*>(partial),
                                          static_cast<float*>(out), s));
}

const char* gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
