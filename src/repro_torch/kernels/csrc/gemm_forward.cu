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
// 67 T op/s.  The bytes are x (B*d*4), feat/thr (T*N*8), the plus and
// minus masks (2*T*L*FW*4, FW=2), Bvec (T*L*4) and leaf_val (T*L*C*4)
// read and B*C*4 written: 2.7 MB, 0.8 us at 3.35 TB/s.  So the bound is
// operations, 4.3 us.
//
// What the design does about it.
//   * The TPU kernel selects x by a one-hot matmul at default precision
//     (gemm_forest_kernel.py:30-32), which on a TPU rounds x through bf16.
//     Here x[row, feat] is an exact __ldg gather, so no predicate flips.
//   * R is an integer count, not a float product.  The host turns A into
//     two bit masks per leaf and 32 nodes (the nodes where A = +1 and
//     where A = -1; kernels/gemm_forest_kernel.py node_masks) once per
//     forest, and a block copies its tree chunk's masks into shared
//     memory.  With the row's S packed into FW <= 8 bit words,
//     R_l = sum_k popc(S_k & plus_lk) - popc(S_k & minus_lk): 4*FW integer
//     operations per leaf in place of 2*N multiply-adds.  This rests on
//     A holding only -1, 0 and +1, which is what the traversal matrices
//     are.
//   * The leaf product is a direct load of leaf_val[t, l, :] for each hit,
//     not a one-hot matmul.
//   * One thread per row; a block covers 128 rows x one chunk of trees
//     whose feat/thr/masks/Bvec sit in shared memory, read by every thread
//     of a warp at once (broadcasts).
//   * No float atomics: each block writes partial[chunk, row, :] and a
//     second kernel sums the chunks in order, so results are deterministic.
//
// wgmma, TMA and tile tuning are left for later work.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (src/repro_torch/kernels/gemm_forest_kernel.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 128;
constexpr int kReduceThreads = 256;
constexpr size_t kMaxSharedBytes = 48 * 1024;

// Shared memory per chunk: feat, thr (tc*N each), plus and minus masks
// (tc*L*FW each), Bvec (tc*L); 4 bytes each.
__host__ __device__ inline size_t chunk_words(int tc, int N, int L, int FW) {
  return static_cast<size_t>(tc) * (2 * static_cast<size_t>(N) +
                                    static_cast<size_t>(L) * (2 * FW + 1));
}

template <int FW, int CMAX, typename Acc>
__global__ void __launch_bounds__(kRowsPerBlock)
gemm_tile_kernel(const float* __restrict__ x, const int* __restrict__ feat,
                 const float* __restrict__ thr,
                 const uint32_t* __restrict__ plus,
                 const uint32_t* __restrict__ minus,
                 const int* __restrict__ bvec,
                 const float* __restrict__ leaf_val,
                 Acc* __restrict__ partial, int B, int d, int T, int N,
                 int L, int C, int tree_chunk) {
  extern __shared__ uint32_t smem[];
  const int t0 = blockIdx.y * tree_chunk;
  const int tc = min(tree_chunk, T - t0);
  int* feat_s = reinterpret_cast<int*>(smem);
  float* thr_s = reinterpret_cast<float*>(smem + tree_chunk * N);
  uint32_t* plus_s = smem + 2 * tree_chunk * N;
  uint32_t* minus_s = plus_s + tree_chunk * L * FW;
  int* bvec_s = reinterpret_cast<int*>(minus_s + tree_chunk * L * FW);

  const size_t node0 = static_cast<size_t>(t0) * N;
  for (int i = threadIdx.x; i < tc * N; i += blockDim.x) {
    feat_s[i] = feat[node0 + i];
    thr_s[i] = thr[node0 + i];
  }
  for (int i = threadIdx.x; i < tc * L; i += blockDim.x)
    bvec_s[i] = bvec[static_cast<size_t>(t0) * L + i];
  const size_t mask0 = static_cast<size_t>(t0) * L * FW;
  for (int i = threadIdx.x; i < tc * L * FW; i += blockDim.x) {
    plus_s[i] = plus[mask0 + i];
    minus_s[i] = minus[mask0 + i];
  }
  __syncthreads();

  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x;
  if (row >= B) return;
  const float* xr = x + static_cast<size_t>(row) * d;

  Acc acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = Acc(0);

  for (int t = 0; t < tc; ++t) {
    const int* ft = feat_s + t * N;
    const float* th = thr_s + t * N;
    // s[k] bit j: node 32k + j goes left (x <= thr; NaN compares false and
    // goes right, as the reference gemm engine does)
    uint32_t s[FW];
#pragma unroll
    for (int k = 0; k < FW; ++k) {
      const int n0 = 32 * k;
      const int nn = min(32, N - n0);
      uint32_t f = 0u;
      for (int j = 0; j < nn; ++j)
        f |= static_cast<uint32_t>(__ldg(xr + ft[n0 + j]) <= th[n0 + j])
             << j;
      s[k] = f;
    }
    const uint32_t* pt = plus_s + t * L * FW;
    const uint32_t* mt = minus_s + t * L * FW;
    const int* bt = bvec_s + t * L;
    for (int l = 0; l < L; ++l) {
      int r = 0;
#pragma unroll
      for (int k = 0; k < FW; ++k)
        r += __popc(s[k] & pt[l * FW + k]) - __popc(s[k] & mt[l * FW + k]);
      if (r == bt[l]) {
        const float* lv =
            leaf_val + (static_cast<size_t>(t0 + t) * L + l) * C;
#pragma unroll
        for (int c = 0; c < CMAX; ++c)
          if (c < C) acc[c] += static_cast<Acc>(__ldg(lv + c));
      }
    }
  }

  Acc* out = partial + (static_cast<size_t>(blockIdx.y) * B + row) * C;
#pragma unroll
  for (int c = 0; c < CMAX; ++c)
    if (c < C) out[c] = acc[c];
}

// out[i] = sum over chunks k = 0, 1, ... of partial[k, i], in that order.
template <typename Acc>
__global__ void gemm_reduce_kernel(const Acc* __restrict__ partial,
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
  const uint32_t* plus;
  const uint32_t* minus;
  const int* bvec;
  const float* leaf_val;
  int B, d, T, N, L, C, fire_words, tree_chunk;
  cudaStream_t stream;
};

template <int FW, int CMAX, typename Acc>
cudaError_t launch(const Args& a, Acc* partial, Acc* out) {
  const int n_chunks = (a.T + a.tree_chunk - 1) / a.tree_chunk;
  if (n_chunks > 0) {
    const size_t smem =
        sizeof(uint32_t) * chunk_words(a.tree_chunk, a.N, a.L, FW);
    const dim3 grid((a.B + kRowsPerBlock - 1) / kRowsPerBlock, n_chunks);
    gemm_tile_kernel<FW, CMAX, Acc><<<grid, kRowsPerBlock, smem, a.stream>>>(
        a.x, a.feat, a.thr, a.plus, a.minus, a.bvec, a.leaf_val, partial, a.B, a.d, a.T,
        a.N, a.L, a.C, a.tree_chunk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int n_out = a.B * a.C;
  gemm_reduce_kernel<Acc>
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
  switch (a.fire_words) {
    case 1: return dispatch_classes<1, Acc>(a, partial, out);
    case 2: return dispatch_classes<2, Acc>(a, partial, out);
    case 4: return dispatch_classes<4, Acc>(a, partial, out);
    default: return dispatch_classes<8, Acc>(a, partial, out);
  }
}

}  // namespace

extern "C" {

// Scores (B, C) into `out` (f32, or int32 when int_accum != 0), using
// `partial` (ceil(T / tree_chunk), B, C) of the same type as scratch.
// plus and minus are (T, L, fire_words) uint32: bit j of word k of leaf l
// is set where A[t, 32k + j, l] is +1 (plus) or -1 (minus).  Bvec is
// (T, L) int32; `fire_words` is 1, 2, 4 or 8, with 32 * fire_words >= N.
// Every array is contiguous and on the current device.  Returns a
// cudaError_t: 0 when both kernels were launched.
int gemm_forward_launch(const void* x, const void* feat, const void* thr,
                        const void* plus, const void* minus, const void* bvec,
                        const void* leaf_val, void* partial, void* out,
                        int B, int d, int T, int N, int L, int C,
                        int fire_words, int tree_chunk, int int_accum,
                        void* stream) {
  const bool fw_ok = fire_words == 1 || fire_words == 2 ||
                     fire_words == 4 || fire_words == 8;
  if (B < 1 || d < 1 || T < 0 || N < 0 || L < 1 || C < 1 || C > 16 ||
      !fw_ok || 32 * fire_words < N || tree_chunk < 1 ||
      sizeof(uint32_t) * chunk_words(tree_chunk, N, L, fire_words) >
          kMaxSharedBytes ||
      (T + tree_chunk - 1) / tree_chunk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(x),
         static_cast<const int*>(feat),
         static_cast<const float*>(thr),
         static_cast<const uint32_t*>(plus),
         static_cast<const uint32_t*>(minus),
         static_cast<const int*>(bvec),
         static_cast<const float*>(leaf_val),
         B, d, T, N, L, C, fire_words, tree_chunk,
         static_cast<cudaStream_t>(stream)};
  if (int_accum)
    return static_cast<int>(dispatch<int>(a, static_cast<int*>(partial),
                                          static_cast<int*>(out)));
  return static_cast<int>(dispatch<float>(a, static_cast<float*>(partial),
                                          static_cast<float*>(out)));
}

const char* gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
