// GQA flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_forward` in
// src/repro/kernels/flash_attention_kernel.py:86 (body `_flash_kernel`
// :38).  Same function: q (BH, Sq, hd) against k/v (BK, Sk, hd), BH =
// BK * n_rep, query row bh reading kv row bh / n_rep; scores q*scale . k
// in f32, the causal mask qpos >= kpos top-left aligned, an online softmax
// with m, l and acc in f32, and out = acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on an H100.  Per visible (q, k) pair the function does
// 4*hd operations (2*hd for q.k, 2*hd for p*v), and it must read q, k, v
// and write out once.  At the served smollm-360m prefill (8 sequences x
// 15 heads x 1024 positions, hd 64, causal: 62,976,000 visible pairs in
// bf16) that is 16.1 GFLOP, 0.0163 ms at the 989 TFLOP/s of bf16 tensor
// cores, against 42 MB, 0.0125 ms at 3.35 TB/s: bound by operations, and
// more so at S = 32768 (2.08 ms against 0.050 ms).
//
// What this first kernel does about it: little yet.  It is the simple
// version, f32 FMAs on the CUDA cores (67 TFLOP/s peak, a fifteenth of
// the tensor rate); mma.sync / wgmma and TMA are later work.  Its design:
//   * The TPU grid (BH, nq, nk) walks the key axis j in order with m, l,
//     acc in VMEM scratch.  Here the grid is (q tiles, BH) and the key
//     axis is a loop inside the block; m, l and acc stay in registers.
//   * A block holds kRows = 64 query rows.  Each row belongs to G lanes
//     (G = 1 for hd <= 16, 2 for hd 64, 4 for hd 96 and 128), each lane
//     keeping hd / G of q and acc as float4 chunks (at most 32 floats of
//     each), so hd 128 does not spill.  Lane g takes chunks g, g+G, ...,
//     so the G lanes of a row read neighbouring 16-byte words of shared
//     memory; the rows of a warp read the same key (a broadcast).  The
//     lanes' partial dot products meet by __shfl_xor_sync.
//   * K and V tiles (kTileK keys: 64, or 32 for hd > 64) are staged in
//     shared memory as f32, converted once from bf16 where the inputs are
//     bf16: 32 KB at hd 64, under the default 48 KB.
//   * Key tiles wholly above the causal diagonal of the block are never
//     visited (the Pallas kernel still loads them).  The loop starts at
//     key tile 0, and key 0 is visible to every query row, so each row's
//     running max is finite after its first sub-tile and a masked key
//     contributes exactly 0 (expf(-inf)).
//   * The softmax state is updated once per sub-tile of kSub = 16 keys:
//     scores in registers, one correction expf per sub-tile.  expf, not
//     __expf, so the f32 result holds the reference's 2e-5 tolerance.
//   * Blocks run the heaviest causal tiles (the last q tiles) first.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes
// (src/repro_torch/kernels/flash_attention_kernel.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kRows = 64;          // query rows of one block
constexpr int kSub = 16;           // keys per softmax update

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

template <int HD>
struct Shape {
  static constexpr int kChunks = HD / 4;                  // float4 per row
  static constexpr int kLanes = HD <= 16 ? 1 : (HD <= 64 ? 2 : 4);
  static constexpr int kPerLane = kChunks / kLanes;       // float4 per lane
  static constexpr int kTileK = HD <= 64 ? 64 : 32;       // keys per tile
  static constexpr int kThreads = kRows * kLanes;
  static_assert(HD % 4 == 0 && kChunks % kLanes == 0, "head_dim");
  static_assert(kTileK % kSub == 0, "tile");
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <int HD, typename T>
__global__ void __launch_bounds__(Shape<HD>::kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
             int n_rep, int causal, float scale) {
  using S = Shape<HD>;
  constexpr int G = S::kLanes;
  constexpr int C = S::kPerLane;
  constexpr int NC = S::kChunks;
  constexpr int TK = S::kTileK;
  __shared__ float4 k_s[TK][NC];
  __shared__ float4 v_s[TK][NC];

  const int bh = blockIdx.y;
  const int kvh = bh / n_rep;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;   // heaviest first
  const int row = threadIdx.x / G;
  const int g = threadIdx.x % G;
  const int qpos = q0 + row;
  const bool q_ok = qpos < Sq;

  float4 qr[C], acc[C];
  const T* qrow = q + (static_cast<size_t>(bh) * Sq + qpos) * HD;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float4 x = q_ok ? load4(qrow + 4 * (g + G * c))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[c] = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -1e30f, l = 0.f;

  // keys some row of this block sees: all of them, or those <= its last row
  const int k_end = causal ? min(Sk, q0 + kRows) : Sk;
  const T* kbase = k + static_cast<size_t>(kvh) * Sk * HD;
  const T* vbase = v + static_cast<size_t>(kvh) * Sk * HD;

  for (int k0 = 0; k0 < k_end; k0 += TK) {
    __syncthreads();                       // the last tile is read
    for (int i = threadIdx.x; i < TK * NC; i += S::kThreads) {
      const int j = i / NC, c = i % NC;
      const bool ok = k0 + j < Sk;
      const size_t off = static_cast<size_t>(k0 + j) * HD + 4 * c;
      k_s[j][c] = ok ? load4(kbase + off) : make_float4(0.f, 0.f, 0.f, 0.f);
      v_s[j][c] = ok ? load4(vbase + off) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();

    const int n_sub = min(TK, k_end - k0 + kSub - 1) / kSub;
    for (int sb = 0; sb < n_sub; ++sb) {
      float s[kSub];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const int j = sb * kSub + jj;
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float4 kv = k_s[j][g + G * c];
          d = fmaf(qr[c].x, kv.x, d);
          d = fmaf(qr[c].y, kv.y, d);
          d = fmaf(qr[c].z, kv.z, d);
          d = fmaf(qr[c].w, kv.w, d);
        }
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        const int kpos = k0 + j;
        const bool vis = kpos < Sk && (!causal || kpos <= qpos);
        s[jj] = vis ? d : neg_inf();
        mx = fmaxf(mx, s[jj]);
      }
      const float corr = expf(m - mx);
      l *= corr;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[c].x *= corr; acc[c].y *= corr;
        acc[c].z *= corr; acc[c].w *= corr;
      }
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const int j = sb * kSub + jj;
        const float p = expf(s[jj] - mx);
        l += p;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float4 vv = v_s[j][g + G * c];
          acc[c].x = fmaf(p, vv.x, acc[c].x);
          acc[c].y = fmaf(p, vv.y, acc[c].y);
          acc[c].z = fmaf(p, vv.z, acc[c].z);
          acc[c].w = fmaf(p, vv.w, acc[c].w);
        }
      }
      m = mx;
    }
  }

  if (!q_ok) return;
  const float inv_l = 1.f / fmaxf(l, 1e-30f);
  T* orow = out + (static_cast<size_t>(bh) * Sq + qpos) * HD;
#pragma unroll
  for (int c = 0; c < C; ++c)
    store4(orow + 4 * (g + G * c),
           make_float4(acc[c].x * inv_l, acc[c].y * inv_l,
                       acc[c].z * inv_l, acc[c].w * inv_l));
}

template <int HD, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int BH, int Sq, int Sk, int n_rep, int causal,
                   float scale, cudaStream_t stream) {
  const dim3 grid((Sq + kRows - 1) / kRows, BH);
  flash_kernel<HD, T><<<grid, Shape<HD>::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, n_rep, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     void* out, int BH, int Sq, int Sk, int n_rep,
                     int causal, float scale, cudaStream_t s) {
  switch (hd) {
    case 4: return launch<4, T>(q, k, v, out, BH, Sq, Sk, n_rep, causal,
                                scale, s);
    case 8: return launch<8, T>(q, k, v, out, BH, Sq, Sk, n_rep, causal,
                                scale, s);
    case 16: return launch<16, T>(q, k, v, out, BH, Sq, Sk, n_rep, causal,
                                  scale, s);
    case 64: return launch<64, T>(q, k, v, out, BH, Sq, Sk, n_rep, causal,
                                  scale, s);
    case 96: return launch<96, T>(q, k, v, out, BH, Sq, Sk, n_rep, causal,
                                  scale, s);
    case 128: return launch<128, T>(q, k, v, out, BH, Sq, Sk, n_rep, causal,
                                    scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// out (BH, Sq, hd) = attention of q (BH, Sq, hd) over k/v (BH / n_rep, Sk,
// hd), all contiguous, 16-byte aligned and on the current device, f32 or
// (is_bf16 != 0) bf16.  `scale_bits` is the f32 bit pattern of the score
// scale.  Returns a cudaError_t: 0 when the kernel was launched.
int flash_forward_launch(const void* q, const void* k, const void* v,
                         void* out, int BH, int Sq, int Sk, int hd,
                         int n_rep, int causal, int is_bf16, int scale_bits,
                         void* stream) {
  if (BH < 1 || BH > 65535 || Sq < 1 || Sk < 1 || n_rep < 1 ||
      BH % n_rep != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  float scale;
  static_assert(sizeof(scale) == sizeof(scale_bits), "bits");
  memcpy(&scale, &scale_bits, sizeof(scale));
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return static_cast<int>(dispatch<__nv_bfloat16>(
        hd, q, k, v, out, BH, Sq, Sk, n_rep, causal, scale, s));
  return static_cast<int>(dispatch<float>(hd, q, k, v, out, BH, Sq, Sk,
                                          n_rep, causal, scale, s));
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
