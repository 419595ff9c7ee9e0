// QuickScorer bitvector traversal for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `qs_forward` in
// src/repro/kernels/quickscorer_kernel.py:130 (body `_qs_kernel` :107 ->
// `qs_tile_scores` :50).  Same function: for every (row, tree), the nodes
// whose predicate x[feat] > thr fires AND their interval masks into the
// tree's W-word leafidx, `& init_idx`; the exit leaf is the lowest set bit;
// leaf_val[t, leaf, :] is summed over trees.  Float forests sum in f32,
// int-accum forests in int32.
//
// What bounds it on an H100.  Per call it reads x (B*d*4 bytes), the node
// stream feat/thr/masks (T*N*(8+4W)), init_idx (T*W*4) and leaf_val
// (T*L*C*4), and writes (B*C*4).  At T=1024, L=64 (N=63, W=2), d=136, C=1,
// B=1024 that is 1.86 MB: 0.56 us at 3.35 TB/s.  The work is
// B*T*N*(1+2W) 32-bit ALU operations (one compare, one select and one AND
// per word, ~3.3e8 here) plus B*T*C adds: 4.9 us at the 67 T op/s of the
// card's non-tensor f32 peak, and about four times that at the int32
// pipe's rate (64 lanes per SM against 128).  So the kernel is bound by
// integer and compare operations, not bytes, by an order of magnitude.
//
// What the design does about it.
//   * No one-hot matmuls: the TPU kernel selects features and leaf rows by
//     matmul because it cannot gather (quickscorer_kernel.py:72-77, :98-103).
//     Here x[row, feat] is a direct __ldg gather and leaf_val[t, leaf, :] a
//     direct load, so no operations are spent on a d-wide or L-wide
//     contraction.
//   * One thread per row; a block covers 128 rows x one chunk of trees.
//     The chunk's feat/thr/masks/init_idx sit in shared memory, and every
//     thread of a warp reads the same node at once (a broadcast, no bank
//     conflicts).  x stays in global memory and is read through the
//     read-only cache: a 128-row tile of x at d=784 would not fit in
//     shared memory.
//   * The W-word leafidx lives in registers (W <= 8, so L <= 256), and the
//     predicate is applied branch-free: leafidx &= mask | ~fire, one LOP3
//     per word.  The exit leaf is __ffs of the lowest nonzero word.
//   * No float atomics.  Each block writes its partial sums to
//     partial[chunk, row, :], and a second kernel sums the chunks in order,
//     so a float forest gives the same bits on every run.
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
constexpr size_t kMaxSharedBytes = 48 * 1024;

template <int WMAX, int CMAX, typename Acc>
__global__ void __launch_bounds__(kRowsPerBlock)
qs_tile_kernel(const float* __restrict__ x, const int* __restrict__ feat,
               const float* __restrict__ thr,
               const uint32_t* __restrict__ masks,
               const uint32_t* __restrict__ init_idx,
               const float* __restrict__ leaf_val, Acc* __restrict__ partial,
               int B, int d, int T, int N, int W, int L, int C,
               int tree_chunk) {
  extern __shared__ uint32_t smem[];
  const int t0 = blockIdx.y * tree_chunk;
  const int tc = min(tree_chunk, T - t0);
  const int n_nodes = tc * N;
  int* feat_s = reinterpret_cast<int*>(smem);
  float* thr_s = reinterpret_cast<float*>(smem + tree_chunk * N);
  uint32_t* masks_s = smem + 2 * tree_chunk * N;
  uint32_t* init_s = masks_s + tree_chunk * N * W;

  const size_t node0 = static_cast<size_t>(t0) * N;
  for (int i = threadIdx.x; i < n_nodes; i += blockDim.x) {
    feat_s[i] = feat[node0 + i];
    thr_s[i] = thr[node0 + i];
  }
  for (int i = threadIdx.x; i < n_nodes * W; i += blockDim.x)
    masks_s[i] = masks[node0 * W + i];
  for (int i = threadIdx.x; i < tc * W; i += blockDim.x)
    init_s[i] = init_idx[static_cast<size_t>(t0) * W + i];
  __syncthreads();

  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x;
  if (row >= B) return;
  const float* xr = x + static_cast<size_t>(row) * d;

  Acc acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = Acc(0);

  for (int t = 0; t < tc; ++t) {
    uint32_t leafidx[WMAX];
#pragma unroll
    for (int w = 0; w < WMAX; ++w)
      leafidx[w] = (w < W) ? init_s[t * W + w] : 0u;
    const int* ft = feat_s + t * N;
    const float* th = thr_s + t * N;
    const uint32_t* mt = masks_s + t * N * W;
    for (int n = 0; n < N; ++n) {
      // fire = all ones when the row goes right at this node (x > thr;
      // NaN compares false and goes left, as the gather engine does)
      const uint32_t keep = (__ldg(xr + ft[n]) > th[n]) ? 0u : 0xFFFFFFFFu;
#pragma unroll
      for (int w = 0; w < WMAX; ++w)
        if (w < W) leafidx[w] &= mt[n * W + w] | keep;
    }
    // lowest set bit across words; the lowest nonzero word is assigned
    // last.  An all-zero leafidx (a padding tree) keeps leaf 0, whose
    // leaf row is zero.
    int leaf = 0;
#pragma unroll
    for (int w = WMAX - 1; w >= 0; --w)
      if (w < W && leafidx[w] != 0u) leaf = w * 32 + __ffs(leafidx[w]) - 1;
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
__global__ void qs_reduce_kernel(const Acc* __restrict__ partial,
                                 Acc* __restrict__ out, int n_chunks,
                                 int n_out) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= n_out) return;
  Acc s = Acc(0);
  for (int k = 0; k < n_chunks; ++k)
    s += partial[static_cast<size_t>(k) * n_out + i];
  out[i] = s;
}

template <int WMAX, int CMAX, typename Acc>
cudaError_t launch(const float* x, const int* feat, const float* thr,
                   const uint32_t* masks, const uint32_t* init_idx,
                   const float* leaf_val, Acc* partial, Acc* out, int B,
                   int d, int T, int N, int W, int L, int C, int tree_chunk,
                   cudaStream_t stream) {
  const int n_chunks = (T + tree_chunk - 1) / tree_chunk;
  if (n_chunks > 0) {
    const size_t smem =
        sizeof(uint32_t) *
        (static_cast<size_t>(tree_chunk) * N * (2 + W) + tree_chunk * W);
    const dim3 grid((B + kRowsPerBlock - 1) / kRowsPerBlock, n_chunks);
    qs_tile_kernel<WMAX, CMAX, Acc><<<grid, kRowsPerBlock, smem, stream>>>(
        x, feat, thr, masks, init_idx, leaf_val, partial, B, d, T, N, W, L,
        C, tree_chunk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int n_out = B * C;
  qs_reduce_kernel<Acc>
      <<<(n_out + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0,
         stream>>>(partial, out, n_chunks, n_out);
  return cudaGetLastError();
}

template <int WMAX, typename Acc>
cudaError_t dispatch_classes(int C, const float* x, const int* feat,
                             const float* thr, const uint32_t* masks,
                             const uint32_t* init_idx, const float* leaf_val,
                             Acc* partial, Acc* out, int B, int d, int T,
                             int N, int W, int L, int tree_chunk,
                             cudaStream_t s) {
  if (C <= 1)
    return launch<WMAX, 1, Acc>(x, feat, thr, masks, init_idx, leaf_val,
                                partial, out, B, d, T, N, W, L, C,
                                tree_chunk, s);
  if (C <= 4)
    return launch<WMAX, 4, Acc>(x, feat, thr, masks, init_idx, leaf_val,
                                partial, out, B, d, T, N, W, L, C,
                                tree_chunk, s);
  return launch<WMAX, 16, Acc>(x, feat, thr, masks, init_idx, leaf_val,
                               partial, out, B, d, T, N, W, L, C, tree_chunk,
                               s);
}

template <typename Acc>
cudaError_t dispatch(const float* x, const int* feat, const float* thr,
                     const uint32_t* masks, const uint32_t* init_idx,
                     const float* leaf_val, Acc* partial, Acc* out, int B,
                     int d, int T, int N, int W, int L, int C,
                     int tree_chunk, cudaStream_t s) {
  if (W <= 1)
    return dispatch_classes<1, Acc>(C, x, feat, thr, masks, init_idx,
                                    leaf_val, partial, out, B, d, T, N, W, L,
                                    tree_chunk, s);
  if (W <= 2)
    return dispatch_classes<2, Acc>(C, x, feat, thr, masks, init_idx,
                                    leaf_val, partial, out, B, d, T, N, W, L,
                                    tree_chunk, s);
  if (W <= 4)
    return dispatch_classes<4, Acc>(C, x, feat, thr, masks, init_idx,
                                    leaf_val, partial, out, B, d, T, N, W, L,
                                    tree_chunk, s);
  return dispatch_classes<8, Acc>(C, x, feat, thr, masks, init_idx, leaf_val,
                                  partial, out, B, d, T, N, W, L, tree_chunk,
                                  s);
}

}  // namespace

extern "C" {

// Scores (B, C) into `out` (f32, or int32 when int_accum != 0), using
// `partial` (ceil(T / tree_chunk), B, C) of the same type as scratch.
// Every array is contiguous and on the current device; masks and init_idx
// are uint32 bit patterns.  Returns a cudaError_t: 0 when both kernels
// were launched.
int qs_forward_launch(const void* x, const void* feat, const void* thr,
                      const void* masks, const void* init_idx,
                      const void* leaf_val, void* partial, void* out, int B,
                      int d, int T, int N, int W, int L, int C,
                      int tree_chunk, int int_accum, void* stream) {
  const size_t smem = sizeof(uint32_t) *
      (static_cast<size_t>(tree_chunk) * N * (2 + W) + tree_chunk * W);
  if (B < 1 || d < 1 || T < 0 || N < 0 || W < 1 || W > 8 || C < 1 ||
      C > 16 || L < 1 || L > 32 * W || tree_chunk < 1 ||
      smem > kMaxSharedBytes ||
      (T + tree_chunk - 1) / tree_chunk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* ft = static_cast<const int*>(feat);
  const auto* th = static_cast<const float*>(thr);
  const auto* mk = static_cast<const uint32_t*>(masks);
  const auto* ii = static_cast<const uint32_t*>(init_idx);
  const auto* lv = static_cast<const float*>(leaf_val);
  auto s = static_cast<cudaStream_t>(stream);
  if (int_accum)
    return static_cast<int>(dispatch<int>(
        xf, ft, th, mk, ii, lv, static_cast<int*>(partial),
        static_cast<int*>(out), B, d, T, N, W, L, C, tree_chunk, s));
  return static_cast<int>(dispatch<float>(
      xf, ft, th, mk, ii, lv, static_cast<float*>(partial),
      static_cast<float*>(out), B, d, T, N, W, L, C, tree_chunk, s));
}

const char* qs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
