// Bit-matmul QuickScorer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `qs_bitmm_forward` in
// src/repro/kernels/quickscorer_kernel.py:240 (body `_qs_bitmm_kernel`
// :165).  Same function: for every (row, tree), cond_n = x[feat_n] > thr_n
// in {0, 1}; packed word g of the tree is
//   words[g] = bias[g] + sum_n cond_n * packed[n, g],
// where each word holds `npack` leaf fields of `bits` bits, a field
// counting the firing ancestors that clear its leaf.  The exit leaf is the
// lowest zero field, found with the borrow trick
// (v - lo) & ~v & hi (src/repro/core/quickscorer.py:313); leaves at or above
// `n_leaves`, and trees with no zero field (padding trees), map to leaf 0.
// leaf_val[t, leaf, :] is summed over trees, in f32 for float forests and
// in int32 for int-accum ones.
//
// What bounds it on an H100.  Per call it reads x (B*d*4 bytes), feat/thr
// (T*N*8), the packed words (3*T*N*G bytes as byte planes), bias (T*G*4)
// and leaf_val (T*L*C*4), and writes B*C*4: about 3 MB at T=1024, L=64
// (N=63, bits 3, npack 8, G=8), d=136, C=1, B=1024, 0.9 us at 3.35 TB/s.
// The contraction is linear and cond is 0/1, so it runs exactly as three
// products of cond with the byte planes of the packed words (u8, each sum
// <= N*255 in int32) on the int8 tensor cores: 3*2*B*T*N*G ~ 3.2e9
// operations, 1.6 us at 1979 T op/s.  Beside it, on the other pipes: a
// compare per node, and per (row, tree, group) two multiply-adds that join
// the planes, the borrow trick's subtract and one three-input logic op,
// and a test, plus a leaf add per (row, tree, class): B*T*(N + 5G + C)
// ~ 1.1e8 32-bit operations, 1.6 us at 67 T op/s.  So the bound is 1.63
// us, by operations (chip_smoke.py, Kernel.work).
//
// What held the first kernel (PR 12: one thread per row, 128 rows a
// block) at 0.54 ms: every node's x[row, feat] was an __ldg gather in
// which the 32 lanes of a warp read 32 rows d*4 bytes apart, 32 cache
// lines and 32 L1 wavefronts per warp instruction (~66 M lane reads at
// the MSN shape); and the contraction ran on the CUDA cores as a
// predicated add per (node, group) over shared-memory words.
//
// What this kernel does:
//   * The x tile (csrc/tile_common.cuh, as csrc/qs_forward.cu does it).  A
//     block is 32 rows x 8 warps, lane = row, warp = tree slice.  Its rows
//     of x sit in shared memory feature-major at stride 33, so a warp's
//     gather of one feature over its rows is one wavefront.  Lane = row
//     then tests its row against a tree's nodes, {feat, thr} records read
//     as broadcasts, into ceil(N/32) condition words: the records are
//     padded with zeros to whole words of 32 nodes, so a word's loop is
//     unrolled and each condition sets its bit with one predicated OR.
//     Rows too wide for the tile (the kSmemX = false instance) gather x
//     from global memory; the wrapper counts which route ran.
//   * The contraction on the int8 tensor cores, mma.sync.m16n8k32 (u8 x
//     u8, int32 accumulators): per tree the (32 rows x Npad) 0/1 matrix
//     times the (Npad x G) byte planes, two m16 tiles x ceil(G/8) n8
//     tiles x Npad/32 k-steps x 3 planes.  The A fragment is made in
//     registers from the condition words: row r's words are shuffled to
//     the lanes of its fragment and each nibble is spread to four 0/1
//     bytes.  The planes run high to low into one accumulator shifted 8
//     bits between them, so it ends as P0 + (P1 << 8) + (P2 << 16): the
//     exact clear counts, below 2^24.  wgmma is not used: its 64-row M
//     would need 64 rows a block, and its asynchrony buys nothing when A
//     is made fresh in registers for every tree; the tensor work is
//     ~1.6 us of the whole.
//   * The epilogue on the accumulator fragment: v = acc + bias, the borrow
//     trick, and per row the lowest (group, bit) with a flag, as one
//     number group*32 + bit; a min over the quad (two 16-bit halves per
//     word, __vminu2) and a shuffle bring each row's to lane = row, which
//     turns it into a leaf and loads leaf_val[t, leaf, :]; the load is
//     added after the next tree, so its latency hides behind that tree.
//   * Operands in the layout the tensor cores read, made once per forest
//     by kernels/ops.py::_bitmm_arrays: the packed words as three u8 byte
//     planes, K-major per tree, (T, 3, G, Npad) with Npad = N rounded up
//     to 32.  A chunk of 8 trees' records, planes and bias reach shared
//     memory through a two-stage cp.async ring while the previous chunk
//     is traversed, each warp staging one tree with no runtime division;
//     there each plane takes G rounded up to 8 rows (the columns past G
//     are never read out), Npad + 16 bytes apart, so fragment loads are
//     free of bank conflicts.
//   * Tree groups sized for 1024 rows, never from B (launch.tile_layout):
//     each block writes partial[group, row, :], its 8 warps' sums added in
//     warp order; a second kernel sums the groups in order.  No atomics,
//     so a float forest's row gives the same bits in any batch.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (src/repro_torch/kernels/quickscorer_kernel.py).

#include "tile_common.cuh"

namespace {

using namespace tile;

// Bytes of one tree in the ring: its node records, the three byte planes
// (3*G8 rows) and G8 bias words.
__host__ __device__ inline int tree_bytes(int N, int G) {
  const int g8 = round_up(G, 8);
  return node_bytes(N) + 3 * g8 * row_bytes(N) + 4 * g8;
}

template <int KS, int CMAX, bool kSmemX, typename Acc>
__global__ void __launch_bounds__(kThreads)
bitmm_tile_kernel(const float* __restrict__ x, const int* __restrict__ feat,
                  const float* __restrict__ thr,
                  const uint8_t* __restrict__ planes,
                  const int* __restrict__ bias,
                  const float* __restrict__ leaf_val,
                  Acc* __restrict__ partial, int B, int d, int T, int N,
                  int G, int L, int C, int n_leaves, int bits, int npack,
                  int chunk, int group_trees) {
  extern __shared__ uint4 smem[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem);
  const int g8 = round_up(G, 8), n_tiles = g8 / 8;
  const int ks_n = node_pad(N) / 32;       // k-steps of this forest
  const int rb = row_bytes(N), plane_bytes = g8 * rb;
  const int tb = tree_bytes(N, G);
  const int bias_off = node_bytes(N) + 3 * plane_bytes;
  const int ring_bytes = max(2 * chunk * tb,
                             4 * kWarps * kRows * C);
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
                tb, feat, thr, planes, 3, G, bias, G, bias_off);
    cp_async_commit();
  };

  // borrow-trick masks: the low bit and the high bit of every field
  uint32_t lo = 0u;
  for (int i = 0; i < npack; ++i) lo |= 1u << (bits * i);
  const uint32_t hi = lo << (bits - 1);
  // field = bit / bits as a multiply: exact for bit < 32, bits <= 24
  const uint32_t inv_bits = (65536u + bits - 1) / bits;

  // rows past B: x_s holds zeros; the global route reads row B - 1
  const float* xr = x + static_cast<size_t>(min(row0 + lane, B - 1)) * d;
  // acc: this row's sum over the warp's trees, in tree order; lv_next:
  // the last tree's leaf values, loaded while the next tree is traversed
  // and added before its own are loaded
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
      uint32_t fire[KS];
      condition_words<KS, kSmemX, false>(reinterpret_cast<const uint2*>(tree),
                                         ks_n, x_s, xr, lane, fire);
      uint32_t a[2][KS][4];
      a_fragments<KS>(fire, lane, a);
      const int* bias_s = reinterpret_cast<const int*>(tree + bias_off);
      // best[mt][h]: the lowest group*32 + bit with a flag in row
      // 16mt + 8h + g, over this lane's columns (0xFFFF: none)
      uint32_t best[2][2] = {{0xFFFFu, 0xFFFFu}, {0xFFFFu, 0xFFFFu}};
      for (int nt = 0; nt < n_tiles; ++nt) {
        int d_[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
        for (int p = 2; p >= 0; --p) {
          if (p < 2) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int i = 0; i < 4; ++i) d_[mt][i] <<= 8;
          }
          const uint32_t* brow = reinterpret_cast<const uint32_t*>(
              tree + node_bytes(N) + p * plane_bytes + (nt * 8 + g) * rb) +
              t4;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            if (ks < ks_n) {
              const uint32_t b0 = brow[8 * ks], b1 = brow[8 * ks + 4];
              mma_u8u8(d_[0], a[0][ks], b0, b1);
              mma_u8u8(d_[1], a[1][ks], b0, b1);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = nt * 8 + 2 * t4 + j;
          if (col >= G) continue;
          const uint32_t bj = static_cast<uint32_t>(bias_s[col]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t v = static_cast<uint32_t>(d_[mt][2 * h + j]) + bj;
              const uint32_t flags = (v - lo) & ~v & hi;
              if (flags != 0u)
                best[mt][h] = min(best[mt][h], static_cast<uint32_t>(
                    (col << 5) | (__ffs(flags) - 1)));
            }
        }
      }
      // the quad's lowest per row (rows g and g + 8 as the two halves of
      // a word), then to lane = row: row r is m-tile r/16, half (r/8)%2
      // of quad r%8
      uint32_t q[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t w = best[mt][0] | (best[mt][1] << 16);
        w = __vminu2(w, __shfl_xor_sync(0xFFFFFFFFu, w, 1));
        q[mt] = __vminu2(w, __shfl_xor_sync(0xFFFFFFFFu, w, 2));
      }
      const int src = 4 * (lane & 7);
      const uint32_t q0 = __shfl_sync(0xFFFFFFFFu, q[0], src);
      const uint32_t q1 = __shfl_sync(0xFFFFFFFFu, q[1], src);
      const uint32_t m = ((lane < 16 ? q0 : q1) >> (lane & 8 ? 16 : 0)) &
                         0xFFFFu;
      int leaf = 0;
      if (m != 0xFFFFu) {
        leaf = static_cast<int>(m >> 5) * npack +
               static_cast<int>(((m & 31u) * inv_bits) >> 16);
        if (leaf >= n_leaves) leaf = 0;
      }
      const float* lv =
          leaf_val + (static_cast<size_t>(t0 + slot) * L + leaf) * C;
#pragma unroll
      for (int cc = 0; cc < CMAX; ++cc) {
        acc[cc] += static_cast<Acc>(lv_next[cc]);
        lv_next[cc] = cc < C ? __ldg(lv + cc) : 0.f;
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
  const uint8_t* planes;
  const int* bias;
  const float* leaf_val;
  int B, d, T, N, G, L, C, n_leaves, bits, npack, chunk, group_trees, shared;
};

template <int KS, int CMAX, bool kSmemX, typename Acc>
cudaError_t launch(const Args& a, Acc* partial, Acc* out,
                   cudaStream_t stream) {
  const int n_groups =
      a.T > 0 ? (a.T + a.group_trees - 1) / a.group_trees : 0;
  if (n_groups > 0) {
    auto kernel = bitmm_tile_kernel<KS, CMAX, kSmemX, Acc>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.shared);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.B + kRows - 1) / kRows, n_groups);
    kernel<<<grid, kThreads, a.shared, stream>>>(
        a.x, a.feat, a.thr, a.planes, a.bias, a.leaf_val, partial, a.B,
        a.d, a.T, a.N, a.G, a.L, a.C, a.n_leaves, a.bits, a.npack, a.chunk,
        a.group_trees);
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
// planes (T, 3, G, Npad) uint8: byte p of packed word [t, n, g] at
// [t, p, g, n], zero past N (Npad = N rounded up to 32); bias (T, G)
// int32; both hold words below 2^24.  A
// block stages `chunk` trees at a time and walks `group_trees` trees;
// `smem_x` != 0 stages its 32 rows of x in shared memory; `shared` is the
// block's dynamic shared bytes, which must equal tile::shared_bytes().
// Every array is contiguous and on the current device.  Returns a
// cudaError_t: 0 when both kernels were launched.
int qs_bitmm_forward_launch(const void* x, const void* feat, const void* thr,
                            const void* planes, const void* bias,
                            const void* leaf_val, void* partial, void* out,
                            int B, int d, int T, int N, int G, int L, int C,
                            int n_leaves, int bits, int npack, int chunk,
                            int group_trees, int smem_x, int shared,
                            int int_accum, void* stream) {
  if (B < 1 || d < 1 || T < 0 || N < 0 || N > 256 || G < 1 || C < 1 ||
      C > 16 || L < 1 || n_leaves < 1 || n_leaves > L || bits < 1 ||
      npack < 1 || bits * npack > 24 || G * npack < n_leaves || chunk < 1 ||
      group_trees < chunk || shared < 0 ||
      static_cast<size_t>(shared) > kMaxSharedBytes ||
      static_cast<size_t>(shared) !=
          shared_bytes(tree_bytes(N, G), C, d, chunk, smem_x != 0) ||
      (T + group_trees - 1) / group_trees > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(x), static_cast<const int*>(feat),
               static_cast<const float*>(thr),
               static_cast<const uint8_t*>(planes),
               static_cast<const int*>(bias),
               static_cast<const float*>(leaf_val), B, d, T, N, G, L, C,
               n_leaves, bits, npack, chunk, group_trees, shared};
  auto s = static_cast<cudaStream_t>(stream);
  if (int_accum)
    return static_cast<int>(dispatch<int>(smem_x != 0, a,
                                          static_cast<int*>(partial),
                                          static_cast<int*>(out), s));
  return static_cast<int>(dispatch<float>(smem_x != 0, a,
                                          static_cast<float*>(partial),
                                          static_cast<float*>(out), s));
}

const char* qs_bitmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
