// K6 W8A16 matmul: out[M, N] = (x[M, K] @ q[K, N]) * scale[N].
//
// Replaces aigw_tpu/ops/pallas/qmatmul.py::w8a16_matmul (Pallas kernel
// _kernel, called at qmatmul.py:91).
//
// x is bfloat16 or float32, q int8 row-major (N contiguous), scale one
// float32 per output column. Each int8 weight is converted to float in
// registers (exact for |q| <= 127), the products are summed in float32,
// and the column scale multiplies the sum before the cast to x's dtype,
// as the TPU kernel does (scaling after the contraction commutes with
// it, so the weight never exists dequantized).
//
// What bounds it on the H100: at decode M (8 rows) every weight byte is
// read once for 8 multiply-adds, far below the card's balance point, so
// the kernel is bound by the int8 bytes it streams from HBM. The design
// serves that:
// - a block owns 128 output columns; each thread reads 8 consecutive
//   columns of a weight row with one 8-byte load, and a warp's loads
//   cover two rows of 128 contiguous bytes each (coalesced);
// - the 16 "k-lanes" of a block walk interleaved groups of 4 weight
//   rows, 4 loads in flight per thread, and keep an [8 rows x 8 columns]
//   float32 accumulator in registers;
// - when the columns alone give the card too few blocks (N = 1024 gives
//   8), K is split across blocks (grid.y) into float32 partial sums that
//   a second small kernel adds in a fixed order, scales and casts, so
//   the result does not depend on scheduling;
// - M above 8 loops over row tiles of 8 inside the block, re-reading the
//   block's weight tile from L2 (prefill-sized M only).
// The multiply-adds run on the CUDA cores in float32; at M = 8 they are
// close to the CUDA cores' rate for the bytes streamed, so tensor cores
// (mma.sync / wgmma on dequantized bf16 tiles) are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define AIGW_F32 0
#define AIGW_BF16 1

namespace aigw_q {

constexpr int THREADS = 256;
constexpr int BLOCK_N = 128;    // output columns per block
constexpr int COLS = 8;         // columns per thread (one 8-byte load)
constexpr int KLANES = 16;      // THREADS / (BLOCK_N / COLS)
constexpr int ROWS = 4;         // weight rows per thread per step
constexpr int MT = 8;           // x rows per accumulator tile
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 4 consecutive x elements (8- or 16-byte aligned) as float32.
__device__ __forceinline__ void load4(const float* p, float (&v)[ROWS]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[ROWS]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// 8 int8 weights packed in a uint2 → float32.
__device__ __forceinline__ void int8x8(uint2 w, float (&f)[COLS]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = (float)(int8_t)(w.x >> (8 * i));
    f[4 + i] = (float)(int8_t)(w.y >> (8 * i));
  }
}

// grid (N / BLOCK_N, splits), THREADS threads. Split s covers weight
// rows [s * k_rows, min(K, (s + 1) * k_rows)), a multiple of
// KLANES * ROWS rows.
template <typename TX>
__global__ void __launch_bounds__(THREADS, 2)
    w8a16_kernel(const TX* __restrict__ x,         // [M, K]
                 const int8_t* __restrict__ q,     // [K, N]
                 const float* __restrict__ scale,  // [N]
                 float* __restrict__ part,         // [splits, M, N]
                 TX* __restrict__ out,             // [M, N]
                 int M, int K, int N, int k_rows) {
  __shared__ float red[WARPS][MT][BLOCK_N];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int cg = t % (BLOCK_N / COLS), kl = t / (BLOCK_N / COLS);
  const int n0 = blockIdx.x * BLOCK_N;
  const int split = blockIdx.y;
  const int k_begin = split * k_rows;
  const int k_end = min(K, k_begin + k_rows);
  const bool single = gridDim.y == 1;

  for (int mt = 0; mt < M; mt += MT) {
    const TX* xrow[MT];
#pragma unroll
    for (int r = 0; r < MT; ++r)
      xrow[r] = x + (int64_t)min(mt + r, M - 1) * K;  // clamped, unused
    float acc[MT][COLS];
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[r][c] = 0.f;

#pragma unroll 2
    for (int k = k_begin + kl * ROWS; k < k_end; k += KLANES * ROWS) {
      const int8_t* qp = q + (int64_t)k * N + n0 + cg * COLS;
      uint2 w[ROWS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
        w[j] = __ldg(reinterpret_cast<const uint2*>(qp + (int64_t)j * N));
      float wf[ROWS][COLS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j) int8x8(w[j], wf[j]);
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        float xv[ROWS];
        load4(xrow[r] + k, xv);
#pragma unroll
        for (int j = 0; j < ROWS; ++j)
#pragma unroll
          for (int c = 0; c < COLS; ++c)
            acc[r][c] = fmaf(xv[j], wf[j][c], acc[r][c]);
      }
    }

    // the two k-lanes of a warp (lanes l and l ^ 16) share columns
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], 16);
    if (lane < 16) {
#pragma unroll
      for (int r = 0; r < MT; ++r)
#pragma unroll
        for (int c = 0; c < COLS; ++c) red[warp][r][cg * COLS + c] = acc[r][c];
    }
    __syncthreads();
    for (int i = t; i < MT * BLOCK_N; i += THREADS) {
      const int r = i / BLOCK_N, col = i % BLOCK_N;
      const int m = mt + r, n = n0 + col;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[w][r][col];
      if (m < M) {
        if (single) {
          out[(int64_t)m * N + n] = from_f<TX>(s * scale[n]);
        } else {
          part[((int64_t)split * M + m) * N + n] = s;
        }
      }
    }
    __syncthreads();  // red is reused by the next row tile
  }
}

// out[m, n] = cast((sum over splits of part[s, m, n]) * scale[n]),
// splits added in order.
template <typename TX>
__global__ void w8a16_reduce(const float* __restrict__ part,
                             const float* __restrict__ scale,
                             TX* __restrict__ out, int M, int N,
                             int splits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)M * N) return;
  const int n = (int)(i % N);
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(int64_t)k * M * N + i];
  out[i] = from_f<TX>(s * scale[n]);
}

template <typename TX>
int launch(const void* x, const int8_t* q, const float* scale, float* part,
           void* out, int M, int K, int N, int splits, int k_rows,
           cudaStream_t stream) {
  const dim3 grid(N / BLOCK_N, splits);
  w8a16_kernel<TX><<<grid, THREADS, 0, stream>>>(
      (const TX*)x, q, scale, part, (TX*)out, M, K, N, k_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int64_t total = (int64_t)M * N;
  w8a16_reduce<TX><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      part, scale, (TX*)out, M, N, splits);
  return (int)cudaGetLastError();
}

}  // namespace aigw_q

extern "C" {

// Returns cudaGetLastError() after the launches (0 = launched). part is
// [splits, M, N] float32 scratch (unused when splits == 1).
int aigw_w8a16_matmul(const void* x, const void* q, const void* scale,
                      void* part, void* out, int M, int K, int N,
                      int splits, int k_rows, int x_dtype, void* stream) {
  using namespace aigw_q;
  if (M < 1 || N % BLOCK_N != 0 || K % (KLANES * ROWS) != 0 ||
      k_rows % (KLANES * ROWS) != 0 || splits < 1 ||
      (int64_t)splits * k_rows < K) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == AIGW_F32) {
    return launch<float>(x, (const int8_t*)q, (const float*)scale,
                         (float*)part, out, M, K, N, splits, k_rows, s);
  }
  if (x_dtype == AIGW_BF16) {
    return launch<__nv_bfloat16>(x, (const int8_t*)q, (const float*)scale,
                                 (float*)part, out, M, K, N, splits, k_rows,
                                 s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
