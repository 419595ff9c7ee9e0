// GQA flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_forward` in
// src/repro/kernels/flash_attention_kernel.py:86 (body `_flash_kernel`
// :38).  Same function: q (BH, Sq, hd) against k/v (BK, Sk, hd), BH =
// BK * n_rep, query row bh reading kv row bh / n_rep; scores q*scale . k
// with an f32 sum, the causal mask qpos >= kpos top-left aligned, an
// online softmax with m, l and acc in f32, and out = acc / max(l, 1e-30)
// in q's dtype.
//
// What bounds it on an H100.  Per visible (q, k) pair the function does
// 4*hd operations (2*hd for q.k, 2*hd for p*v), and it must read q, k, v
// and write out once.  At the served smollm-360m prefill (8 sequences x
// 15 heads x 1024 positions, hd 64, causal: 62,976,000 visible pairs in
// bf16) that is 16.1 GFLOP, 0.0163 ms at the 989 TFLOP/s of bf16 tensor
// cores, against 42 MB, 0.0125 ms at 3.35 TB/s: bound by operations, and
// more so at S = 32768 (2.08 ms against 0.050 ms).
//
// Two kernels, chosen by dtype alone (the wrapper counts each route):
//
// bf16: `flash_wgmma_kernel`, on the tensor cores.
//   * A block owns WGS * 64 query rows of one head row bh: WGS consumer
//     warpgroups of 64 rows, plus one producer warp.  WGS = 1 (160
//     threads) at head widths up to 64 lets two blocks share an SM, so one
//     block's start (barriers, the first TMA loads) overlaps the other's
//     work; at 96 and 128, where two such blocks would not fit an SM's
//     shared memory, WGS = 2 (288 threads, one block an SM) shares each
//     K/V tile between 128 rows (warpgroups<HDP>()).
//     The key axis is a loop inside the block, heaviest causal q tiles
//     first.
//   * The producer warp's lane 0 loads Q once and then K/V tiles of kN
//     keys (128 at head widths up to 64, 64 at 96 and 128) with TMA
//     (cp.async.bulk.tensor from CUtensorMaps made on the host per call)
//     into a three-stage ring with full and empty mbarriers, so later
//     tiles' copies are in flight while tile j is computed.  Tiles stay
//     bf16 in shared memory, in the swizzled layout TMA writes and wgmma
//     reads (128B swizzle at head widths 64 and 128, 32B at 16).
//   * S = Q.K^T: wgmma.mma_async m64nkN k16, Q and K from shared memory,
//     both K-major, f32 accumulate.
//   * The online softmax runs on the accumulator fragment in registers:
//     a thread holds two rows (lane/4 and lane/4 + 8 of its warp's 16),
//     and the row max and sum meet across the quad by __shfl_xor_sync.
//     The scale times log2(e) is folded into one FFMA per score before
//     ex2.approx (2^x in one MUFU op, 2 ulp: not expf, whose accuracy the
//     bf16 P does not keep anyway).  Tiles that cross the causal diagonal
//     or the key end are masked on the fragment; tiles wholly above the
//     diagonal are never loaded.
//   * O += P.V: P is rounded to bf16 in registers, where the accumulator
//     layout of S is the A-fragment layout of the next wgmma (m64n(hd)k16,
//     A from registers, V from shared memory as an MN-major B operand).
//     That rounding is the one the plain version (f32 p @ v) does not
//     make; SDPA makes it too.  l sums the f32 probabilities.
//   * Within a warpgroup, S_j is issued with PV_{j-1} queued behind it:
//     the tensor cores run PV_{j-1} while the warpgroup does tile j's
//     softmax (wgmma.wait_group 1, then 0 before O is rescaled).
//   * Head widths: the tile is 16 wide at hd 8 and 16, 64 at 64, 128 at
//     96 and 128; TMA fills the columns past hd with zeros, which adds
//     nothing to q.k and gives output columns that are not written.  The
//     wrapper widens hd 4 to 8 (TMA cannot address a row under 16 bytes).
//   * Not done yet: warp-specialised register split (setmaxnreg) and the
//     ping-pong of two warpgroups between softmax and wgmma; the two
//     warpgroups of a block interleave only as the SM's warp schedulers
//     let them.
//
// f32: `flash_kernel`, the first kernel, on the CUDA cores (a TF32
//   tensor-core path would miss the reference's 2e-5):
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
//     shared memory: 32 KB at hd 64, under the default 48 KB.
//   * Key tiles wholly above the causal diagonal of the block are never
//     visited (the Pallas kernel still loads them).  The loop starts at
//     key tile 0, and key 0 is visible to every query row, so each row's
//     running max is finite after its first sub-tile and a masked key
//     contributes exactly 0 (expf(-inf)).  The same holds in the bf16
//     kernel.
//   * The softmax state is updated once per sub-tile of kSub = 16 keys:
//     scores in registers, one correction expf per sub-tile.  expf, not
//     __expf, so the f32 result holds the reference's 2e-5 tolerance.
//   * Blocks run the heaviest causal tiles (the last q tiles) first.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (wgmma needs the `a` of sm_90a) and called through ctypes
// (src/repro_torch/kernels/flash_attention_kernel.py).  cuTensorMapEncodeTiled
// belongs to the CUDA driver API: it is looked up with
// cudaGetDriverEntryPoint, so the library links no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// ------------------------------------------------------------------------
// f32: the CUDA-core kernel
// ------------------------------------------------------------------------

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

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
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
cudaError_t dispatch_simt(int hd, const void* q, const void* k,
                          const void* v, void* out, int BH, int Sq, int Sk,
                          int n_rep, int causal, float scale,
                          cudaStream_t s) {
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

// ------------------------------------------------------------------------
// bf16: wgmma + TMA
// ------------------------------------------------------------------------

constexpr int kWgRows = 64;                      // query rows of a warpgroup
constexpr int kStages = 3;                       // K/V ring depth

// A block of WGS consumer warpgroups and one producer warp.
template <int WGS>
struct Block {
  static constexpr int kRows = WGS * kWgRows;
  static constexpr int kThreads = WGS * 128 + 32;
  static constexpr int kMinBlocks = 3 - WGS;
};

// The tile shape of a padded head width HDP: kN keys per tile and the
// swizzle span SW in bytes (one TMA box and one swizzle atom are SW bytes
// wide, AW = SW / 2 bf16 columns; a tile is HDP / AW atoms side by side).
template <int HDP>
struct Tile {
  static constexpr int kN = HDP <= 64 ? 128 : 64;
  static constexpr int SW = HDP == 16 ? 32 : 128;
  static constexpr int AW = SW / 2;
  static constexpr int kAtoms = HDP / AW;
  static constexpr int kQBytes = kWgRows * HDP * 2;      // one warpgroup
  static constexpr int kKVBytes = kN * HDP * 2;          // one K or V tile
  static_assert(HDP % AW == 0 && kN % 16 == 0, "tile");
};

// Dynamic shared bytes of a block: Q of each warpgroup, then the K and V
// rings, then 1 + 2 * kStages mbarriers; 1024 for the alignment of the
// 128B swizzle.
template <int HDP, int WGS>
constexpr int smem_bytes() {
  return WGS * Tile<HDP>::kQBytes + 2 * kStages * Tile<HDP>::kKVBytes + 64 +
         1024;
}

// Consumer warpgroups of a block at head width HDP: one where two such
// blocks fit an SM's 228 KB of shared memory (1 KB of it reserved per
// block), so one block's start (barriers, the first TMA loads) overlaps
// the other's work; else two, which share each K/V tile between 128 rows
// in one block an SM.  On an H100 (scripts/torch_flash_warpgroups.py,
// PERF.md section 6) one was faster at hd 64 and S = 1024 and level at
// S = 32768; two were faster at hd 96 and 128.  FLASH_WGMMA_WARPGROUPS,
// where defined at build time, sets the count at every width instead.
template <int HDP>
constexpr int warpgroups() {
#ifdef FLASH_WGMMA_WARPGROUPS
  return FLASH_WGMMA_WARPGROUPS;
#else
  return 2 * (smem_bytes<HDP, 1>() + 1024) <= 233472 ? 1 : 2;
#endif
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Spin until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// One TMA box of a rank-3 tensor map at element coordinates (c0, c1, c2)
// into shared memory; completion counts its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this thread's committed wgmma groups are
// pending (groups complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator and
// A-fragment registers across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r]) :: "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (all >> 4), and the swizzle mode (1: 128B, 3: 32B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int sw) {
  const uint64_t mode = sw == 128 ? 1 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// K-major operand of `rows` rows (Q, or a K tile): the 16 columns of
// k-step kk.  Rows are SW bytes apart inside an atom, 8-row groups 8*SW;
// a k-step inside an atom advances the start address by 32 bytes.
template <int HDP>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int rows,
                                                int kk) {
  using S = Tile<HDP>;
  const int col = kk * 16;
  const uint32_t addr = base + (col / S::AW) * rows * S::SW +
                        (col % S::AW) * 2;
  return make_desc(addr, 16, 8 * S::SW, S::SW);
}

// MN-major B operand (a V tile, keys x HDP with HDP contiguous): the 16
// keys of k-step kk.  8-key groups are 8*SW bytes apart (SBO); atoms
// along the head width are kN*SW bytes apart (LBO).
template <int HDP>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t base, int kk) {
  using S = Tile<HDP>;
  return make_desc(base + kk * 16 * S::SW, S::kN * S::SW, 8 * S::SW, S::SW);
}

// S = A * B^T over one k-step, A and B K-major in shared memory; N/2 f32
// accumulators a thread.  scale_d = 0 overwrites d.
template <int N>
struct SS;

// d += A * B over one k-step, A (64 x 16 bf16) from four registers a
// thread, B MN-major in shared memory.
template <int N>
struct RS;

template <>
struct SS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct SS<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct RS<16> {
  static __device__ __forceinline__ void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct RS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct RS<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x in one MUFU op (ex2.approx, 2 ulp; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one key tile on the S accumulator fragment: s
// holds raw scores q.k in, probabilities 2^(s * scale_log2 - m) out (s[4i
// + e] is this thread's row e >> 1, key column 8i + 2 quad + (e & 1)).
// Keys past Sk or above the diagonal are masked first (only on tiles
// that reach them).  m (log2 units) and l are the row's running max and
// quad-partial sum; corr is what the tile scales the old O by.  The
// scale is positive, so the max is taken on raw scores; one FFMA and one
// MUFU op per score.
template <int KN>
__device__ __forceinline__ void online_softmax(
    float (&s)[KN / 2], float (&m)[2], float (&l)[2], float (&corr)[2],
    const int (&row)[2], int quad, int k0, int Sk, int causal, int qrow,
    float scale_log2) {
  if (k0 + KN > Sk || (causal && k0 + KN - 1 > qrow)) {
#pragma unroll
    for (int i = 0; i < KN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * i + 2 * quad + (e & 1);
        if (col >= Sk || (causal && col > row[e >> 1]))
          s[4 * i + e] = neg_inf();
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = neg_inf();
#pragma unroll
    for (int i = 0; i < KN / 8; ++i)
      mx = fmaxf(mx, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // finite after tile 0: key 0 is seen by every row
    const float m_new = fmaxf(m[r], mx * scale_log2);
    corr[r] = ex2(m[r] - m_new);         // 0 on tile 0 (m = -inf)
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < KN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * i + 2 * r + e];
        x = ex2(fmaf(x, scale_log2, -m_new));
        sum += x;
      }
    l[r] = l[r] * corr[r] + sum;         // quad-partial; summed at the end
  }
}

// P in bf16 as the A fragments of the PV product: k-step kk takes the
// accumulator columns 16kk ... 16kk + 15 (the S accumulator layout is the
// A-fragment layout).
template <int KN>
__device__ __forceinline__ void pack_p(const float (&s)[KN / 2],
                                       uint32_t (&pa)[KN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < KN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

template <int HDP, int WGS>
__global__ void __launch_bounds__(Block<WGS>::kThreads,
                                  Block<WGS>::kMinBlocks)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, int Sq, int Sk, int hd,
                   int n_rep, int causal, float scale_log2) {
  using S = Tile<HDP>;
  constexpr int KN = S::kN;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment for the 128B swizzle of TMA and wgmma
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* q_s = smem;
  uint8_t* k_s = q_s + WGS * S::kQBytes;
  uint8_t* v_s = k_s + kStages * S::kKVBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + kStages * S::kKVBytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;                    // [kStages]
  uint64_t* empty = bars + 1 + kStages;         // [kStages]

  const int bh = blockIdx.y;
  // heaviest causal tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * Block<WGS>::kRows;
  // key tiles some row of the block sees
  const int k_end = causal ? min(Sk, q0 + Block<WGS>::kRows) : Sk;
  const int n_tiles = (k_end + KN - 1) / KN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WGS * 4);            // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WGS * 4) {
    // producer: Q once, then K/V tiles through the ring
    if (lane == 0) {
      const int kvh = bh / n_rep;
      mbar_expect_tx(q_full, WGS * S::kQBytes);
      for (int g = 0; g < WGS; ++g)
        for (int a = 0; a < S::kAtoms; ++a)
          tma_load(q_s + g * S::kQBytes + a * kWgRows * S::SW, &tq, q_full,
                   a * S::AW, q0 + g * kWgRows, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        mbar_wait(&empty[st], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * S::kKVBytes);
        for (int a = 0; a < S::kAtoms; ++a) {
          const int off = st * S::kKVBytes + a * KN * S::SW;
          tma_load(k_s + off, &tk, &full[st], a * S::AW, j * KN, kvh);
          tma_load(v_s + off, &tv, &full[st], a * S::AW, j * KN, kvh);
        }
      }
    }
    return;
  }

  // consumer warpgroup g: rows q0 + 64g ... ; this thread's two rows
  const int g = warp / 4;
  const int wrow = (warp % 4) * 16 + lane / 4;
  const int qrow = q0 + g * kWgRows;
  const int row[2] = {qrow + wrow, qrow + wrow + 8};
  const int quad = lane % 4;
  // key tiles this warpgroup's rows see
  const int wg_end = causal ? min(Sk, qrow + kWgRows) : Sk;
  const int wg_tiles = (wg_end + KN - 1) / KN;

  float s[KN / 2], o[HDP / 2], corr[2];
  uint32_t pa[KN / 16][4];
#pragma unroll
  for (int i = 0; i < KN / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
  const uint32_t q_base = smem_u32(q_s + g * S::kQBytes);
  auto k_base = [&](int j) {
    return smem_u32(k_s + (j % kStages) * S::kKVBytes);
  };
  auto v_base = [&](int j) {
    return smem_u32(v_s + (j % kStages) * S::kKVBytes);
  };
  auto issue_s = [&](int j) {            // S = Q K_j^T
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      SS<KN>::mma(s, kmajor_desc<HDP>(q_base, kWgRows, kk),
                  kmajor_desc<HDP>(k_base(j), KN, kk), kk > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int j) {           // O += P_j V_j
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk)
      RS<HDP>::mma(o, pa[kk], mnmajor_desc<HDP>(v_base(j), kk));
    wgmma_commit();
  };
  auto release = [&](int j) {            // tile j's stage is read
    if (lane == 0) mbar_arrive(&empty[j % kStages]);
  };

  // The pipeline: S_j is issued with PV_{j-1} behind it, so the tensor
  // cores run PV_{j-1} while this warpgroup does tile j's softmax.
  mbar_wait(q_full, 0);
  mbar_wait(&full[0], 0);
  wgmma_fence();
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(s);
  online_softmax<KN>(s, m, l, corr, row, quad, 0, Sk, causal, qrow,
                     scale_log2);
  pack_p<KN>(s, pa);
  for (int j = 1; j < wg_tiles; ++j) {
    mbar_wait(&full[j % kStages], (j / kStages) & 1);
    wgmma_fence();
    issue_s(j);
    issue_pv(j - 1);
    wgmma_wait<1>();                     // S_j is done, PV_{j-1} may not be
    fence_regs(s);
    online_softmax<KN>(s, m, l, corr, row, quad, j * KN, Sk, causal, qrow,
                       scale_log2);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    release(j - 1);
#pragma unroll
    for (int i = 0; i < HDP / 8; ++i) {
      o[4 * i + 0] *= corr[0];
      o[4 * i + 1] *= corr[0];
      o[4 * i + 2] *= corr[1];
      o[4 * i + 3] *= corr[1];
    }
    pack_p<KN>(s, pa);
  }
  wgmma_fence();
  issue_pv(wg_tiles - 1);
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(pa);
  release(wg_tiles - 1);
  // tiles wholly above this warpgroup's rows: read by the other one
  for (int j = wg_tiles; j < n_tiles; ++j) {
    mbar_wait(&full[j % kStages], (j / kStages) & 1);
    release(j);
  }

  // out = O / max(l, 1e-30); a quad's four lanes hold a row's columns
  const size_t head = static_cast<size_t>(bh) * Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    if (row[r] >= Sq) continue;
    __nv_bfloat16* orow = out + (head + row[r]) * hd;
#pragma unroll
    for (int i = 0; i < HDP / 8; ++i) {
      const int col = 8 * i + 2 * quad;
      if (col < hd)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
    }
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// the library needs no -lcuda; null if the driver lacks it.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A rank-3 map over (rows, S, hd) bf16, boxes of AW columns x box_rows
// rows of one row of the first axis; columns and rows past the tensor
// read as zeros.
template <int HDP>
bool tensor_map(CUtensorMap* map, const void* base, int rows, int S, int hd,
                int box_rows) {
  using T = Tile<HDP>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(S) * hd * 2};
  const cuuint32_t box[3] = {T::AW, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  EncodeTiled encode = encode_tiled();
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                T::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, int BH, int Sq, int Sk, int hd,
                         int n_rep, int causal, float scale,
                         cudaStream_t stream) {
  constexpr int WGS = warpgroups<HDP>();
  constexpr int smem = smem_bytes<HDP, WGS>();
  static_assert(smem <= 232448, "227 KB of shared memory a block");
  CUtensorMap tq, tk, tv;
  if (!tensor_map<HDP>(&tq, q, BH, Sq, hd, kWgRows) ||
      !tensor_map<HDP>(&tk, k, BH / n_rep, Sk, hd, Tile<HDP>::kN) ||
      !tensor_map<HDP>(&tv, v, BH / n_rep, Sk, hd, Tile<HDP>::kN))
    return cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma_kernel<HDP, WGS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Sq + Block<WGS>::kRows - 1) / Block<WGS>::kRows, BH);
  flash_wgmma_kernel<HDP, WGS><<<grid, Block<WGS>::kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Sk, hd, n_rep,
      causal, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

cudaError_t dispatch_wgmma(int hd, const void* q, const void* k,
                           const void* v, void* out, int BH, int Sq, int Sk,
                           int n_rep, int causal, float scale,
                           cudaStream_t s) {
  if (hd % 8 != 0) return cudaErrorInvalidValue;   // rows of 16 bytes
  if (hd <= 16)
    return launch_wgmma<16>(q, k, v, out, BH, Sq, Sk, hd, n_rep, causal,
                            scale, s);
  if (hd <= 64)
    return launch_wgmma<64>(q, k, v, out, BH, Sq, Sk, hd, n_rep, causal,
                            scale, s);
  if (hd <= 128)
    return launch_wgmma<128>(q, k, v, out, BH, Sq, Sk, hd, n_rep, causal,
                             scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out (BH, Sq, hd) = attention of q (BH, Sq, hd) over k/v (BH / n_rep, Sk,
// hd), all contiguous, 16-byte aligned and on the current device: bf16
// (is_bf16 != 0) through the wgmma kernel, with hd a multiple of 8; f32
// through the CUDA-core kernel.  `scale_bits` is the f32 bit pattern of
// the score scale.  Returns a cudaError_t: 0 when the kernel was launched.
int flash_forward_launch(const void* q, const void* k, const void* v,
                         void* out, int BH, int Sq, int Sk, int hd,
                         int n_rep, int causal, int is_bf16, int scale_bits,
                         void* stream) {
  if (BH < 1 || BH > 65535 || Sq < 1 || Sk < 1 || n_rep < 1 ||
      BH % n_rep != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
      16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  float scale;
  static_assert(sizeof(scale) == sizeof(scale_bits), "bits");
  memcpy(&scale, &scale_bits, sizeof(scale));
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return static_cast<int>(dispatch_wgmma(hd, q, k, v, out, BH, Sq, Sk,
                                           n_rep, causal, scale, s));
  return static_cast<int>(dispatch_simt<float>(hd, q, k, v, out, BH, Sq, Sk,
                                               n_rep, causal, scale, s));
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
