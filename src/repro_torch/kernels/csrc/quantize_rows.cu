// The forest kernels' input transform for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package quantizes a call's rows in NumPy
// on the host (src/repro/core/quantize.py `quantize_inputs`), and so did the
// port: in a bulk call of the MSN-1 forest that host work took about 55% of
// the call while the card sat idle.  This kernel builds the forest kernels'
// padded feed on the card from the caller's raw rows, so the host only
// copies them over.
//
// Same function as `quantize_inputs(forest, X).astype(np.float32)`, bit for
// bit, for rows r < n and feature j < d:
//   v = X[r, cols[j]]                   (cols: the forest's feat_map, or j;
//                                        X row-major or column-major)
//   v = (v - lo[j]) / span[j]           (float64; span = hi - lo, computed
//                                        on the host as NumPy computes it)
//   v = clip(v, 0, 1)                   (NaN passes through, as np.clip)
//   v = floor(scale * v)
//   v = clip(v, qmin, qmax)             (the int grid, int16 or int8)
//   out[r, j] = float(int(v)), or nan_value for NaN (what the host's cast
//                                        gives NaN; -0.0 becomes +0.0)
// Rows n <= r < rows are the bucket's padding and are written as 0.0.  The
// rounding intrinsics keep the float64 ops apart: nvcc may contract a
// multiply and an add into an FMA, and a true division must stay one.
//
// What bounds it on an H100: bytes.  At the MSN bulk shape (8192 rows of
// 136 f32 values) it reads 4.46 MB and writes 4.46 MB: 2.7 us at
// 3.35 TB/s.  The float64 divide costs a few dozen instructions a value,
// far from the card's FP64 rate at 1.1 M values.  Each thread writes four
// consecutive outputs as one 16-byte store and reads their four inputs,
// which lie side by side in a row-major X; a warp covers 128 consecutive
// outputs.  A column-major X (a caller's columns, copied as they lie) is
// read with its own strides: the warp's reads of one column then span a
// few dozen consecutive rows, which L1 merges.  The grid strides over the
// whole (rows, d) feed.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (src/repro_torch/kernels/quantize_kernel.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;          // one float4 store
constexpr int kMaxBlocks = 132 * 32;   // the grid strides beyond this

struct Grid {
  const double* lo;
  const double* span;
  const int* cols;                     // nullptr: the identity
  int64_t row_stride, col_stride;      // X[r, c]: r * row_stride + c * ...
  int n, rows, d;
  double scale, qmin, qmax;
  float nan_value;
};

template <typename T>
__device__ __forceinline__ float quantize(const T* __restrict__ x,
                                          const Grid& g, int r, int j) {
  if (r >= g.n) return 0.0f;
  const int c = g.cols != nullptr ? __ldg(g.cols + j) : j;
  double v = static_cast<double>(x[r * g.row_stride + c * g.col_stride]);
  v = __ddiv_rn(__dsub_rn(v, __ldg(g.lo + j)), __ldg(g.span + j));
  v = v < 0.0 ? 0.0 : v;
  v = v > 1.0 ? 1.0 : v;
  v = floor(__dmul_rn(g.scale, v));
  v = v < g.qmin ? g.qmin : v;
  v = v > g.qmax ? g.qmax : v;
  if (isnan(v)) return g.nan_value;
  return static_cast<float>(static_cast<int>(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quantize_rows_kernel(const T* __restrict__ x, float* __restrict__ out,
                         const Grid g) {
  const int64_t total = static_cast<int64_t>(g.rows) * g.d;
  const int64_t stride =
      static_cast<int64_t>(gridDim.x) * kThreads * kPerThread;
  for (int64_t i0 = (static_cast<int64_t>(blockIdx.x) * kThreads +
                     threadIdx.x) * kPerThread;
       i0 < total; i0 += stride) {
    int r = static_cast<int>(i0 / g.d);
    int j = static_cast<int>(i0 - static_cast<int64_t>(r) * g.d);
    float y[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      y[k] = i0 + k < total ? quantize(x, g, r, j) : 0.0f;
      if (++j == g.d) {
        j = 0;
        ++r;
      }
    }
    if (i0 + kPerThread <= total) {
      *reinterpret_cast<float4*>(out + i0) =
          make_float4(y[0], y[1], y[2], y[3]);
    } else {
      for (int k = 0; i0 + k < total; ++k) out[i0 + k] = y[k];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, float* out, const Grid& g,
                   cudaStream_t stream) {
  const int64_t quads =
      (static_cast<int64_t>(g.rows) * g.d + kPerThread - 1) / kPerThread;
  const int64_t want = (quads + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  quantize_rows_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), out, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The (rows, d) f32 feed into `out` from the n rows `x` (f64 when
// x_f64 != 0, else f32; X[r, c] at r * row_stride + c * col_stride
// elements), the grid's float64 `lo` and `span` (d each) and int32 `cols`
// (d, or null for the identity; every entry a column of x).  `out` is
// contiguous and 16-byte aligned.  Every array is on the current device.
// Returns a cudaError_t: 0 when the kernel was launched.
int quantize_rows_launch(const void* x, const void* lo, const void* span,
                         const void* cols, void* out, int n, int rows, int d,
                         int row_stride, int col_stride, int x_f64,
                         double scale, double qmin, double qmax,
                         double nan_value, void* stream) {
  if (n < 0 || rows < 1 || n > rows || d < 1 || row_stride < 1 ||
      col_stride < 1 || (n > 0 && x == nullptr) || lo == nullptr ||
      span == nullptr || out == nullptr ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Grid g{static_cast<const double*>(lo),
               static_cast<const double*>(span),
               static_cast<const int*>(cols),
               row_stride,
               col_stride,
               n,
               rows,
               d,
               scale,
               qmin,
               qmax,
               static_cast<float>(nan_value)};
  auto s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  return static_cast<int>(x_f64 ? launch<double>(x, o, g, s)
                                : launch<float>(x, o, g, s));
}

const char* quantize_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
