// What the row-tile forest kernels share on Hopper (sm_90a): the block's
// shape, the feature-major x tile, cp.async staging, the QuickScorer node
// records and the walk of one tree (qs_forward, cascade_qs_forward), the
// condition words of a tree (lane = row) and their expansion into the A
// fragments of an int8 mma.sync m16n8k32 (qs_bitmm_forward, gemm_forward),
// the per-row partial sums and the in-order sum over tree groups.
//
// A block is kRows = 32 rows x kWarps = 8 warps: lane = row, warp = tree
// slice.  Its 32 rows of x sit in shared memory feature-major,
// x_s[f * 33 + r], so a warp's read of one feature over its rows touches
// 32 consecutive banks.  A tree's node records are read by all lanes at
// once (broadcasts).
//
// Included by every csrc/*.cu but flash_forward.cu; kernels/build.py
// hashes this header into every library's name.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tile {

constexpr int kRows = 32;                 // rows of a block: lane = row
constexpr int kWarps = 8;                 // tree slices: warp = slice
constexpr int kThreads = kRows * kWarps;
constexpr int kXStride = kRows + 1;       // words per feature in x_s
constexpr int kReduceThreads = 256;
constexpr size_t kMaxSharedBytes = 232448;   // 227 KB

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Nodes of a tree padded to whole k-steps of the m16n8k32 product (at
// least one).
__host__ __device__ constexpr int node_pad(int N) {
  return N > 32 ? round_up(N, 32) : 32;
}

// Bytes of one row of a K-major operand tile in shared memory: Npad bytes
// and 16 more, so that the 8 rows a fragment load touches start 4 banks
// apart and the 32 lanes' words fall in 32 different banks.
__host__ __device__ constexpr int row_bytes(int N) {
  return node_pad(N) + 16;
}

// Bytes of a tree's node records {feat, thr}, one per node of the padded
// k-steps: the records past N stay zero (feature 0), so the condition loop
// runs over whole words of 32 nodes with no bound; their conditions meet
// zero rows of the operand tile.
__host__ __device__ constexpr int node_bytes(int N) { return 8 * node_pad(N); }

// Shared bytes of a block: the two-stage ring of `chunk` trees of
// `tree_bytes` each (reused, after the tree loop, for the 8 warps' partial
// sums), and, for smem_x, the x tile.  The wrapper passes what
// launch.tile_layout computed; the entry points check it against this.
inline size_t shared_bytes(size_t tree_bytes, int C, int d, int chunk,
                           bool smem_x) {
  const size_t ring = 2 * static_cast<size_t>(chunk) * tree_bytes;
  const size_t part = 4 * static_cast<size_t>(kWarps) * kRows * C;
  return (ring > part ? ring : part) +
         (smem_x ? 4 * static_cast<size_t>(kXStride) * d : 0);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x_s[f * 33 + r] = x[row0 + r, f]; rows past B are zeros.  Consecutive
// threads read consecutive features of a row and write banks f + r, all
// different.
__device__ __forceinline__ void stage_x(float* x_s, const float* x, int row0,
                                        int B, int d) {
  for (int i = threadIdx.x; i < kRows * d; i += kThreads) {
    const int r = i / d, f = i % d;
    if (row0 + r < B)
      cp_async4(x_s + f * kXStride + r,
                x + static_cast<size_t>(row0 + r) * d + f);
    else
      x_s[f * kXStride + r] = 0.f;
  }
}

// n / d for the small n and d of the staging loops with one multiply-high:
// m = ceil(2^32 / d) gives floor(n / d) exactly for n < 2^32 / d^2.
struct FastDiv {
  uint32_t m;
  __device__ explicit FastDiv(int d) : m(0xFFFFFFFFu / d + 1u) {}
  __device__ int operator()(int n) const {
    return static_cast<int>(__umulhi(static_cast<uint32_t>(n), m));
  }
};

// ---- QuickScorer node records (qs_forward.cu, cascade_qs_forward.cu) ----

constexpr int kQsUnroll = 4;              // nodes whose loads overlap
constexpr int kQsNodeMultiple = 8;        // a tree's records in a ring
static_assert(kQsNodeMultiple % kQsUnroll == 0, "whole node groups");

// Words of one node record: feat, thr and W mask words, rounded up to
// 16-byte units (W <= 8).
__host__ __device__ constexpr int record_words(int W) {
  return W <= 2 ? 4 : (W <= 4 ? 8 : 12);
}

// Records of one tree in a ring: N rounded up to kQsNodeMultiple.  The
// records past N (feature 0 against an infinite threshold: they never
// fire) are written once per block by pad_records and never by staging,
// so a walk runs whole groups of kQsUnroll nodes.
__host__ __device__ constexpr int qs_node_pad(int N) {
  return round_up(N, kQsNodeMultiple);
}

template <int WMAX>
struct Record {
  static constexpr int kWords = record_words(WMAX);
  static constexpr int kVecs = kWords / 4;
};

// Word i of a record held as 16-byte vectors (i is a constant after
// unrolling, so this folds to a register).
template <int V>
__device__ __forceinline__ uint32_t word(const uint4 (&r)[V], int i) {
  const uint4 q = r[i / 4];
  switch (i % 4) {
    case 0: return q.x;
    case 1: return q.y;
    case 2: return q.z;
    default: return q.w;
  }
}

// The padding records of the `slots` tree slots of a ring.
__device__ __forceinline__ void pad_records(uint32_t* ring, int slots, int N,
                                            int words) {
  const int npad = qs_node_pad(N), pad = npad - N;
  for (int i = threadIdx.x; i < slots * pad; i += kThreads) {
    const int s = i / pad;
    uint32_t* rec = ring + (s * npad + N + i - s * pad) * words;
    rec[0] = 0u;
    rec[1] = 0x7F800000u;                 // +inf
  }
}

// The records of the tc trees from t0 of the (T, N) node arrays into the
// tree slots at dst, qs_node_pad(N) records of `words` (record_words(W))
// words each, by cp.async; the caller commits.
__device__ __forceinline__ void stage_records(
    uint32_t* dst, int t0, int tc, int N, int W, int words,
    const int* __restrict__ feat, const float* __restrict__ thr,
    const uint32_t* __restrict__ masks) {
  if (N == 0) return;
  const int npad = qs_node_pad(N);
  const FastDiv by_tree(N);
  const size_t node0 = static_cast<size_t>(t0) * N;
  for (int i = threadIdx.x; i < tc * N; i += kThreads) {
    const int t = N == 1 ? i : by_tree(i);     // FastDiv needs d >= 2
    uint32_t* rec = dst + (t * npad + i - t * N) * words;
    cp_async4(rec, feat + node0 + i);
    cp_async4(rec + 1, thr + node0 + i);
    for (int w = 0; w < W; ++w)
      cp_async4(rec + 2 + w, masks + (node0 + i) * W + w);
  }
}

// The exit leaf of one tree for this lane's row: the nodes whose
// predicate x[feat] > thr fires (NaN does not) AND their masks into the
// W-word leafidx, from the tree's init_idx; the leaf is its lowest set
// bit.  `node` holds the tree's qs_node_pad(N) records in shared memory;
// x comes from the x tile (kSmemX) or the row xr in global memory.  The
// node loop is unrolled by kQsUnroll: the records of kQsUnroll nodes are
// loaded, then their x values, then the compares and ANDs, so the
// dependent pair of shared-memory loads of several nodes is in flight at
// once.
template <int WMAX, bool kSmemX>
__device__ __forceinline__ int qs_exit_leaf(const uint4* node,
                                            const uint32_t* __restrict__ init,
                                            int N, int W, const float* x_s,
                                            const float* __restrict__ xr,
                                            int lane) {
  using R = Record<WMAX>;
  uint32_t leafidx[WMAX];
#pragma unroll
  for (int w = 0; w < WMAX; ++w) leafidx[w] = w < W ? __ldg(init + w) : 0u;
  const int npad = qs_node_pad(N);
  for (int n = 0; n < npad; n += kQsUnroll) {
    uint4 rec[kQsUnroll][R::kVecs];
    float xv[kQsUnroll];
#pragma unroll
    for (int u = 0; u < kQsUnroll; ++u)
#pragma unroll
      for (int v = 0; v < R::kVecs; ++v)
        rec[u][v] = node[(n + u) * R::kVecs + v];
#pragma unroll
    for (int u = 0; u < kQsUnroll; ++u)
      xv[u] = kSmemX ? x_s[rec[u][0].x * kXStride + lane]
                     : __ldg(xr + rec[u][0].x);
#pragma unroll
    for (int u = 0; u < kQsUnroll; ++u) {
      // keep = all ones when the row goes left at this node (x <= thr, or
      // NaN): the node's mask then clears nothing
      const uint32_t keep =
          xv[u] > __uint_as_float(rec[u][0].y) ? 0u : 0xFFFFFFFFu;
#pragma unroll
      for (int w = 0; w < WMAX; ++w)
        if (w < W) leafidx[w] &= word(rec[u], 2 + w) | keep;
    }
  }
  // lowest set bit across words; the lowest nonzero word is assigned last.
  // An all-zero leafidx (a padding tree) keeps leaf 0, whose leaf row is
  // zero.
  int leaf = 0;
#pragma unroll
  for (int w = WMAX - 1; w >= 0; --w)
    if (w < W && leafidx[w] != 0u) leaf = w * 32 + __ffs(leafidx[w]) - 1;
  return leaf;
}

// Zero node records past N in every tree slot of the two ring stages,
// once per block: staging never writes them.
__device__ __forceinline__ void zero_pad_records(uint8_t* ring, int slots,
                                                 int N, int tree_bytes) {
  const int pad = node_pad(N) - N;
  for (int i = threadIdx.x; i < slots * pad; i += kThreads) {
    const int s = i / pad;
    reinterpret_cast<uint2*>(ring + s * tree_bytes)[N + i - s * pad] =
        make_uint2(0u, 0u);
  }
}

// A chunk of trees into the ring stage at `dst`: the tc trees from t0,
// each `tree_bytes` long, warp w staging trees w, w + 8, ... (the ring
// holds at most a tree a warp, so each warp copies one).  Per tree: its
// node records {feat, thr} from the (T, N) arrays at offset 0; its K-major
// operand tile, `n_planes` (<= 3) planes of `rows` rows of Npad bytes in
// global memory, at node_bytes(N), plane p's row r at row
// p * round_up(rows, 8) + r, rows row_bytes(N) apart (the rows past `rows`
// are never read out); and `words` int32 words from `extra` at
// `extra_off`.  No runtime division: a tile row is split by FastDiv.
__device__ __forceinline__ void stage_trees(
    uint8_t* dst, int tc, int t0, int N, int tree_bytes,
    const int* __restrict__ feat, const float* __restrict__ thr,
    const uint8_t* __restrict__ tiles, int n_planes, int rows,
    const int* __restrict__ extra, int words, int extra_off) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int vecs_per_row = node_pad(N) / 16;       // 2..16
  const int vecs_per_tree = n_planes * rows * vecs_per_row;
  const int skip = round_up(rows, 8) - rows;       // rows a plane pads
  const FastDiv by_row(vecs_per_row);
  for (int s = warp; s < tc; s += kWarps) {
    uint8_t* tree = dst + s * tree_bytes;
    const size_t t = static_cast<size_t>(t0 + s);
    for (int n = lane; n < N; n += 32) {
      uint32_t* rec = reinterpret_cast<uint32_t*>(tree + 8 * n);
      cp_async4(rec, feat + t * N + n);
      cp_async4(rec + 1, thr + t * N + n);
    }
    const uint8_t* src = tiles + t * vecs_per_tree * 16;
    uint8_t* tile = tree + node_bytes(N);
    for (int i = lane; i < vecs_per_tree; i += 32) {
      const int row = by_row(i), v = i - row * vecs_per_row;
      const int p = (row >= rows) + (row >= 2 * rows);
      cp_async16(tile + (row + p * skip) * row_bytes(N) + 16 * v,
                 src + static_cast<size_t>(i) * 16);
    }
    for (int k = lane; k < words; k += 32)
      cp_async4(tree + extra_off + 4 * k, extra + t * words + k);
  }
}

// fire[k] bit j: the condition of node 32k + j for this lane's row, from
// x_s (kSmemX) or the row xr in global memory, for the ks_n <= KS words
// of the padded nodes.  kLeft: x <= thr (the GEMM engine's S; NaN compares
// false and goes right); else x > thr (the bit-matmul engine's cond; NaN
// goes left).  A word's 32 nodes are unrolled, so each condition sets its
// bit with one predicated OR of a constant; the records of four nodes (two
// 16-byte loads) are read before their x values, so the dependent
// shared-memory loads of several nodes overlap.
template <int KS, bool kSmemX, bool kLeft>
__device__ __forceinline__ void condition_words(
    const uint2* __restrict__ nodes, int ks_n, const float* x_s,
    const float* __restrict__ xr, int lane, uint32_t (&fire)[KS]) {
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    uint32_t f = 0u;
    if (k < ks_n) {
#pragma unroll
      for (int j = 0; j < 32; j += 4) {
        const uint4* q = reinterpret_cast<const uint4*>(nodes + 32 * k + j);
        const uint4 r01 = q[0], r23 = q[1];
        const uint32_t ft[4] = {r01.x, r01.z, r23.x, r23.z};
        const uint32_t th[4] = {r01.y, r01.w, r23.y, r23.w};
        float xv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          xv[u] = kSmemX ? x_s[ft[u] * kXStride + lane] : __ldg(xr + ft[u]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float t = __uint_as_float(th[u]);
          if (kLeft ? (xv[u] <= t) : (xv[u] > t)) f |= 1u << (j + u);
        }
      }
    }
    fire[k] = f;
  }
}

// Four condition bits → four 0/1 bytes, bit i in byte i.
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

// The A fragments of the (32 rows x 32*KS nodes) 0/1 matrix for
// mma.m16n8k32 with 8-bit A: m-tile mt holds rows 16mt..16mt+15; register
// i of k-step ks holds row 16mt + lane/4 (+8 for i = 1, 3) and nodes
// 32ks + 4(lane%4) + 0..3 (+16 for i = 2, 3).  Row r's words are lane r's
// fire[], shuffled to the lanes of its fragment.
template <int KS>
__device__ __forceinline__ void a_fragments(const uint32_t (&fire)[KS],
                                            int lane,
                                            uint32_t (&a)[2][KS][4]) {
  const int g = lane >> 2, sh = 4 * (lane & 3);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const uint32_t w0 = __shfl_sync(0xFFFFFFFFu, fire[ks], 16 * mt + g);
      const uint32_t w1 = __shfl_sync(0xFFFFFFFFu, fire[ks], 16 * mt + g + 8);
      a[mt][ks][0] = nibble_bytes((w0 >> sh) & 0xFu);
      a[mt][ks][1] = nibble_bytes((w1 >> sh) & 0xFu);
      a[mt][ks][2] = nibble_bytes((w0 >> (sh + 16)) & 0xFu);
      a[mt][ks][3] = nibble_bytes((w1 >> (sh + 16)) & 0xFu);
    }
}

// d += a . b on the int8 tensor cores: A 16x32 u8 (row), B 32x8 (col),
// u8 or s8, int32 accumulators.  b0 holds B[4(lane%4) + 0..3][lane/4],
// b1 the same 16 rows further; d[0..1] are row lane/4, columns
// 2(lane%4) + 0..1, d[2..3] row lane/4 + 8.
__device__ __forceinline__ void mma_u8u8(int (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_u8s8(int (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The block's per-row sums: warp w's acc (lane = row) into shared memory,
// then the 8 warps added in warp order into partial[group, row, :].
template <int CMAX, typename Acc>
__device__ __forceinline__ void write_partial(const Acc (&acc)[CMAX],
                                              Acc* part, Acc* partial,
                                              int group, int row0, int B,
                                              int C) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int c = 0; c < CMAX; ++c)
    if (c < C) part[(warp * kRows + lane) * C + c] = acc[c];
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * C; i += kThreads) {
    const int r = i / C, c = i % C;
    if (row0 + r >= B) continue;
    Acc sum = Acc(0);
    for (int w = 0; w < kWarps; ++w) sum += part[(w * kRows + r) * C + c];
    partial[(static_cast<size_t>(group) * B + row0 + r) * C + c] = sum;
  }
}

// out[i] = sum over groups k = 0, 1, ... of partial[k, i], in that order.
template <typename Acc>
__global__ void reduce_groups_kernel(const Acc* __restrict__ partial,
                                     Acc* __restrict__ out, int n_groups,
                                     int n_out) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= n_out) return;
  Acc s = Acc(0);
  for (int k = 0; k < n_groups; ++k)
    s += partial[static_cast<size_t>(k) * n_out + i];
  out[i] = s;
}

template <typename Acc>
cudaError_t reduce_groups(const Acc* partial, Acc* out, int n_groups,
                          int n_out, cudaStream_t stream) {
  reduce_groups_kernel<Acc>
      <<<(n_out + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0,
         stream>>>(partial, out, n_groups, n_out);
  return cudaGetLastError();
}

}  // namespace tile
