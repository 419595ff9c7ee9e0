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
// (T*N*8), packed (T*N*G*4), bias (T*G*4) and leaf_val (T*L*C*4), and
// writes B*C*4.  At T=1024, L=64 (N=63, bits 3, npack 8, G=8), d=136, C=1,
// B=1024 that is 3.4 MB: 1.0 us at 3.35 TB/s.  The contraction is linear
// and cond is 0/1, so it runs exactly as three products of cond with the
// byte planes of the packed words (u8, each sum <= N*255 in int32) on the
// int8 tensor cores: 3*2*B*T*N*G ~ 3.2e9 operations, 1.6 us at 1979
// T op/s.  Beside it, on the other pipes: a compare per node, and per
// (row, tree, group) two multiply-adds that join the planes (the bias
// seeds the accumulator), the borrow trick's subtract and one three-input
// logic op, and a test, plus a leaf add per (row, tree, class):
// B*T*(N + 5G + C) ~ 1.1e8 32-bit operations, 1.6 us at 67 T op/s.  The
// larger of the two, 1.6 us, bounds it: operations, not bytes.
//
// What the design does about it.
//   * The TPU kernel runs the contraction as an f32 matmul at HIGHEST
//     precision on the MXU.  Because cond is 0/1, the contraction here is a
//     predicated integer add per (node, group): words[g] += cond ? p : 0,
//     with packed converted to uint32 on the host (exact), so nothing is
//     rounded.  This keeps the kernel simple and right; the byte-plane
//     int8 products of the bound above are work for a later version.
//   * No one-hot matmuls: the TPU kernel selects features and leaf rows by
//     matmul (quickscorer_kernel.py:189-195, :222-228).  Here x[row, feat]
//     is a direct __ldg gather and leaf_val[t, leaf, :] a direct load.
//   * One thread per row; a block covers 128 rows x one chunk of trees whose
//     feat/thr/packed/bias sit in shared memory, read by every thread of a
//     warp at once (broadcasts, no bank conflicts).
//   * The conditions of a tree's N <= 256 nodes are taken once into FW <= 8
//     bit words in registers.  The groups are then summed one at a time, in
//     order, and the loop stops at the first group that holds a zero field:
//     registers do not grow with G, so every L <= 256 is covered.  A tree
//     chunk above 48 KB of shared memory (one tree with N=255, G=86 needs
//     90 KB) is opted in up to the 227 KB a block may hold.
//   * No float atomics: each block writes partial[chunk, row, :] and a
//     second kernel sums the chunks in order, so a float forest gives the
//     same bits on every run.
//
// wgmma, TMA and tile tuning are left for later work.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (src/repro_torch/kernels/quickscorer_kernel.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 128;
constexpr int kReduceThreads = 256;
constexpr size_t kDefaultSharedBytes = 48 * 1024;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB, opt-in

template <int FW, int CMAX, typename Acc>
__global__ void __launch_bounds__(kRowsPerBlock)
bitmm_tile_kernel(const float* __restrict__ x, const int* __restrict__ feat,
                  const float* __restrict__ thr,
                  const uint32_t* __restrict__ packed,
                  const uint32_t* __restrict__ bias,
                  const float* __restrict__ leaf_val,
                  Acc* __restrict__ partial, int B, int d, int T, int N,
                  int G, int L, int C, int n_leaves, int bits, int npack,
                  int tree_chunk) {
  extern __shared__ uint32_t smem[];
  const int t0 = blockIdx.y * tree_chunk;
  const int tc = min(tree_chunk, T - t0);
  const int n_nodes = tc * N;
  int* feat_s = reinterpret_cast<int*>(smem);
  float* thr_s = reinterpret_cast<float*>(smem + tree_chunk * N);
  uint32_t* packed_s = smem + 2 * tree_chunk * N;
  uint32_t* bias_s = packed_s + static_cast<size_t>(tree_chunk) * N * G;

  const size_t node0 = static_cast<size_t>(t0) * N;
  for (int i = threadIdx.x; i < n_nodes; i += blockDim.x) {
    feat_s[i] = feat[node0 + i];
    thr_s[i] = thr[node0 + i];
  }
  for (int i = threadIdx.x; i < n_nodes * G; i += blockDim.x)
    packed_s[i] = packed[node0 * G + i];
  for (int i = threadIdx.x; i < tc * G; i += blockDim.x)
    bias_s[i] = bias[static_cast<size_t>(t0) * G + i];
  __syncthreads();

  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x;
  if (row >= B) return;
  const float* xr = x + static_cast<size_t>(row) * d;

  // borrow-trick masks: the low bit and the high bit of every field
  uint32_t lo = 0u;
  for (int i = 0; i < npack; ++i) lo |= 1u << (bits * i);
  const uint32_t hi = lo << (bits - 1);

  Acc acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = Acc(0);

  for (int t = 0; t < tc; ++t) {
    const int* ft = feat_s + t * N;
    const float* th = thr_s + t * N;
    // fire[k] bit j: node 32k + j goes right (x > thr; NaN compares false
    // and goes left, as the gather engine does)
    uint32_t fire[FW];
#pragma unroll
    for (int k = 0; k < FW; ++k) {
      const int n0 = 32 * k;
      const int nn = min(32, N - n0);
      uint32_t f = 0u;
      for (int j = 0; j < nn; ++j)
        f |= static_cast<uint32_t>(__ldg(xr + ft[n0 + j]) > th[n0 + j]) << j;
      fire[k] = f;
    }
    const uint32_t* pt = packed_s + static_cast<size_t>(t) * N * G;
    const uint32_t* bt = bias_s + t * G;
    int leaf = 0;
    for (int g = 0; g < G; ++g) {
      uint32_t v = bt[g];
#pragma unroll
      for (int k = 0; k < FW; ++k) {
        const int n0 = 32 * k;
        const int nn = min(32, N - n0);
        const uint32_t f = fire[k];
        const uint32_t* p = pt + n0 * G + g;
        for (int j = 0; j < nn; ++j)
          v += p[j * G] & (0u - ((f >> j) & 1u));
      }
      const uint32_t flags = (v - lo) & ~v & hi;
      if (flags != 0u) {
        leaf = g * npack + (__ffs(flags) - 1) / bits;
        break;
      }
    }
    if (leaf >= n_leaves) leaf = 0;
    const float* lv =
        leaf_val + (static_cast<size_t>(t0 + t) * L + leaf) * C;
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < C) acc[c] += static_cast<Acc>(__ldg(lv + c));
  }

  Acc* out = partial + (static_cast<size_t>(blockIdx.y) * B + row) * C;
#pragma unroll
  for (int c = 0; c < CMAX; ++c)
    if (c < C) out[c] = acc[c];
}

// out[i] = sum over chunks k = 0, 1, ... of partial[k, i], in that order.
template <typename Acc>
__global__ void bitmm_reduce_kernel(const Acc* __restrict__ partial,
                                    Acc* __restrict__ out, int n_chunks,
                                    int n_out) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= n_out) return;
  Acc s = Acc(0);
  for (int k = 0; k < n_chunks; ++k)
    s += partial[static_cast<size_t>(k) * n_out + i];
  out[i] = s;
}

struct Args {
  const float* x;
  const int* feat;
  const float* thr;
  const uint32_t* packed;
  const uint32_t* bias;
  const float* leaf_val;
  int B, d, T, N, G, L, C, n_leaves, bits, npack, tree_chunk;
  size_t smem;
  cudaStream_t stream;
};

template <int FW, int CMAX, typename Acc>
cudaError_t launch(const Args& a, Acc* partial, Acc* out) {
  const int n_chunks = (a.T + a.tree_chunk - 1) / a.tree_chunk;
  if (n_chunks > 0) {
    auto kernel = bitmm_tile_kernel<FW, CMAX, Acc>;
    if (a.smem > kDefaultSharedBytes) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(a.smem));
      if (err != cudaSuccess) return err;
    }
    const dim3 grid((a.B + kRowsPerBlock - 1) / kRowsPerBlock, n_chunks);
    kernel<<<grid, kRowsPerBlock, a.smem, a.stream>>>(
        a.x, a.feat, a.thr, a.packed, a.bias, a.leaf_val, partial, a.B, a.d,
        a.T, a.N, a.G, a.L, a.C, a.n_leaves, a.bits, a.npack, a.tree_chunk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int n_out = a.B * a.C;
  bitmm_reduce_kernel<Acc>
      <<<(n_out + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0,
         a.stream>>>(partial, out, n_chunks, n_out);
  return cudaGetLastError();
}

template <int FW, typename Acc>
cudaError_t dispatch_classes(const Args& a, Acc* partial, Acc* out) {
  if (a.C <= 1) return launch<FW, 1, Acc>(a, partial, out);
  if (a.C <= 4) return launch<FW, 4, Acc>(a, partial, out);
  return launch<FW, 16, Acc>(a, partial, out);
}

template <typename Acc>
cudaError_t dispatch(const Args& a, Acc* partial, Acc* out) {
  if (a.N <= 32) return dispatch_classes<1, Acc>(a, partial, out);
  if (a.N <= 64) return dispatch_classes<2, Acc>(a, partial, out);
  if (a.N <= 128) return dispatch_classes<4, Acc>(a, partial, out);
  return dispatch_classes<8, Acc>(a, partial, out);
}

}  // namespace

extern "C" {

// Scores (B, C) into `out` (f32, or int32 when int_accum != 0), using
// `partial` (ceil(T / tree_chunk), B, C) of the same type as scratch.
// packed (T, N, G) and bias (T, G) are uint32 words below 2^24; every
// array is contiguous and on the current device.  Returns a cudaError_t:
// 0 when both kernels were launched.
int qs_bitmm_forward_launch(const void* x, const void* feat, const void* thr,
                            const void* packed, const void* bias,
                            const void* leaf_val, void* partial, void* out,
                            int B, int d, int T, int N, int G, int L, int C,
                            int n_leaves, int bits, int npack,
                            int tree_chunk, int int_accum, void* stream) {
  const size_t smem =
      sizeof(uint32_t) * static_cast<size_t>(tree_chunk) *
      (static_cast<size_t>(N) * (2 + G) + G);
  if (B < 1 || d < 1 || T < 0 || N < 0 || N > 256 || G < 1 || C < 1 ||
      C > 16 || L < 1 || n_leaves < 1 || n_leaves > L || bits < 1 ||
      npack < 1 || bits * npack > 32 || G * npack < n_leaves ||
      tree_chunk < 1 || smem > kMaxSharedBytes ||
      (T + tree_chunk - 1) / tree_chunk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(x),
         static_cast<const int*>(feat),
         static_cast<const float*>(thr),
         static_cast<const uint32_t*>(packed),
         static_cast<const uint32_t*>(bias),
         static_cast<const float*>(leaf_val),
         B, d, T, N, G, L, C, n_leaves, bits, npack, tree_chunk, smem,
         static_cast<cudaStream_t>(stream)};
  if (int_accum)
    return static_cast<int>(dispatch<int>(a, static_cast<int*>(partial),
                                          static_cast<int*>(out)));
  return static_cast<int>(dispatch<float>(a, static_cast<float*>(partial),
                                          static_cast<float*>(out)));
}

const char* qs_bitmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
