// K6 W8A16 matmul: out[M, N] = (x[M, K] @ q[K, N]) * scale[N].
//
// Replaces aigw_tpu/ops/pallas/qmatmul.py::w8a16_matmul (Pallas kernel
// _kernel, called at qmatmul.py:91).
//
// x is bfloat16 (served) or float32 (tests), q int8 row-major (N
// contiguous, the layout models/quant.py writes; no repacked copy),
// scale one float32 per output column. The products are summed in
// float32 and the column scale multiplies the sum before the cast to x's
// dtype, as the TPU kernel does (scaling after the contraction commutes
// with it, so the weight never exists dequantized in HBM).
//
// What bounds it on the H100: at decode M (8 rows) each weight byte is
// read once for 8 multiply-adds, far below the card's balance point, so
// the floor is the int8 bytes streamed from HBM (7.5 GB per Llama-3-8B
// decode step, 2.26 ms at 3.35 TB/s). The first version missed it by 3x
// because its arithmetic, not its bytes, set the pace: float32 FMAs on
// the CUDA cores, one slow int-to-float conversion per weight, x rows
// re-read every 4 weight rows, 8-byte loads, and a second launch for the
// split-K sum. This version (bf16 x):
// - runs the products on the tensor cores, mma.sync.m16n8k16 (bf16 in,
//   float32 accumulate) with A and B swapped: out^T [N, M] = W^T [N, K]
//   x^T [K, M]. Sixteen weight columns form the A operand and the batch
//   the n = 8 side, so M = 8 fills the instruction; M up to 64 reuses
//   the converted A fragments from registers for each 8-row tile of x;
// - streams the weight tile [64 rows x 128 columns] and x's matching
//   [M x 64] slice through a 4-stage shared-memory ring with 16-byte
//   cp.async, so each x element is read once per block and several
//   stages of weights are in flight while the warps compute;
// - permutes the contraction index inside each 16-row step so that a
//   lane's A values are 4 consecutive weight rows of 4 consecutive
//   columns: four 32-bit shared loads per step (16-byte chunks XOR
//   swizzled by row, so the warp's loads hit 32 distinct banks), and the
//   matching x values are one 8-byte load;
// - converts int8 to bf16 with integer and float ALU operations only:
//   byte_perm places q + 128 in the mantissa of 2^23, one float
//   subtraction leaves q exactly, and the upper half of that float is
//   q's bf16 (exact for |q| <= 127);
// - splits K across blocks only where the column tiles alone leave the
//   card short (N = 1024: 8 tiles), and folds the float32 partials in
//   the same launch: the last block of a column tile to arrive
//   (last_arrival, attn_common.cuh) adds them in split order, so two
//   calls on the same inputs give the same bits.
// Measured in place (PERF.md), this version streams a decode step's
// weights at about half of HBM's rate; the short shapes (N = 1024) pay
// the fold's latency, the long ones the per-SM instruction rate of the
// conversion.
// float32 x keeps the CUDA-core kernel (w8a16_f32_kernel): the tensor
// cores would round x to bf16, and the tests hold float32 x to 1e-5 of
// the output's scale. It folds its splits the same way.

#include "attn_common.cuh"

namespace aigw_q {

using aigw::cp_async16;
using aigw::cp_async_commit;
using aigw::cp_async_wait;
using aigw::last_arrival;
using aigw::mma_bf16;

constexpr int BLOCK_N = 128;  // output columns per block (both kernels)

// -- bf16 x: tensor cores ---------------------------------------------------
constexpr int BK = 64;        // weight rows per pipeline stage
constexpr int STAGES = 4;
constexpr int TC_WARPS = 4;   // each warp owns 32 of the block's columns
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int W_TILE = BK * BLOCK_N;  // bytes of one staged weight tile
// bytes of one staged x row: 64 bf16 and 32 bytes of padding, so the 8
// rows a warp reads at once start on distinct banks
constexpr int X_ROW = BK * 2 + 32;

template <int MT>  // MT tiles of 8 x rows
constexpr int tc_smem_bytes() {
  return STAGES * (W_TILE + MT * 8 * X_ROW);
}

// q from byte j of u, where u holds q + 128 in each byte: 2^23 + q + 128
// as a float, minus 2^23 + 128.
template <int J>
__device__ __forceinline__ float int8_at(uint32_t u) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | J)) -
         8388736.f;
}
// bf16x2 of two small integers held exactly in float32 (their low 16
// bits are zero): the upper halves, lo in the low half.
__device__ __forceinline__ uint32_t bf16x2_hi(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// grid (N / BLOCK_N, splits), TC_THREADS threads, tc_smem_bytes<MT>()
// dynamic shared memory. Split s covers weight rows [s * k_rows,
// min(K, (s + 1) * k_rows)), a whole number of BK-row stages. Lane (g =
// lane / 4, tq = lane % 4) of warp w owns columns 32 w + 4 g + [0, 4)
// of the block: the rows g, g + 8 of two 16-row A tiles; within each
// 16-row step of K it reads weight rows 4 tq + [0, 4), the mma's logical
// contraction indices {2 tq, 2 tq + 1, 2 tq + 8, 2 tq + 9} (the same
// permutation on A and B leaves the sum's terms unchanged).
template <int MT>
__global__ void __launch_bounds__(TC_THREADS)
    w8a16_tc_kernel(const __nv_bfloat16* __restrict__ x,  // [M, K]
                    const int8_t* __restrict__ q,         // [K, N]
                    const float* __restrict__ scale,      // [N]
                    float* part,         // [splits, M, N] (splits > 1)
                    unsigned* counters,  // [N / BLOCK_N] (splits > 1)
                    __nv_bfloat16* __restrict__ out,  // [M, N]
                    int M, int K, int N, int k_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* w_ring = smem;                   // [STAGES][BK][BLOCK_N]
  unsigned char* x_ring = smem + STAGES * W_TILE;  // [STAGES][MT * 8][X_ROW]
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int g = lane / 4, tq = lane % 4;
  const int n0 = blockIdx.x * BLOCK_N;
  const int split = blockIdx.y, splits = gridDim.y;
  const int k_begin = split * k_rows;
  const int steps = (min(K, k_begin + k_rows) - k_begin) / BK;

  // stage `step` of this split into ring slot `slot`: the weight rows'
  // 16-byte chunk c of row r lands at chunk c ^ (2 * ((r / 4) % 4));
  // x rows >= M are zero-filled
  auto load = [&](int step, int slot) {
    const int k0 = k_begin + step * BK;
    unsigned char* w = w_ring + slot * W_TILE;
    for (int i = t; i < W_TILE / 16; i += TC_THREADS) {
      const int r = i / (BLOCK_N / 16), c = i % (BLOCK_N / 16);
      cp_async16(w + r * BLOCK_N + ((c ^ (((r >> 2) & 3) << 1)) * 16),
                 q + (int64_t)(k0 + r) * N + n0 + c * 16);
    }
    unsigned char* xs = x_ring + slot * (MT * 8 * X_ROW);
    for (int i = t; i < MT * 8 * (BK * 2 / 16); i += TC_THREADS) {
      const int m = i / (BK * 2 / 16), c = i % (BK * 2 / 16);
      const bool in = m < M;
      cp_async16(xs + m * X_ROW + c * 16,
                 x + (int64_t)(in ? m : 0) * K + k0 + c * 8, in ? 16 : 0);
    }
  };

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][a][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  // this lane's swizzled chunk: the same for its 4 rows of every step
  const int chunk = (2 * warp + g / 4) ^ (tq << 1);
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage `it` landed; slot (it - 1) % STAGES is free
    if (it + STAGES - 1 < steps)
      load(it + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_async_commit();
    const unsigned char* w = w_ring + (it % STAGES) * W_TILE;
    const unsigned char* xs = x_ring + (it % STAGES) * (MT * 8 * X_ROW);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const unsigned char* wp =
          w + (kk * 16 + 4 * tq) * BLOCK_N + chunk * 16 + (g % 4) * 4;
      // u[i]: row 4 tq + i, columns 4 g + [0, 4), each byte q + 128
      uint32_t u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        u[i] = *reinterpret_cast<const uint32_t*>(wp + i * BLOCK_N) ^
               0x80808080u;
      float f[4][4];  // [row i][column j]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        f[i][0] = int8_at<0>(u[i]);
        f[i][1] = int8_at<1>(u[i]);
        f[i][2] = int8_at<2>(u[i]);
        f[i][3] = int8_at<3>(u[i]);
      }
      // A tile a: row g = column 2a, row g + 8 = column 2a + 1; logical
      // k (2tq, 2tq+1) = rows (0, 1), (2tq+8, 2tq+9) = rows (2, 3)
      uint32_t a[2][4];
#pragma unroll
      for (int ti = 0; ti < 2; ++ti) {
        a[ti][0] = bf16x2_hi(f[0][2 * ti], f[1][2 * ti]);
        a[ti][1] = bf16x2_hi(f[0][2 * ti + 1], f[1][2 * ti + 1]);
        a[ti][2] = bf16x2_hi(f[2][2 * ti], f[3][2 * ti]);
        a[ti][3] = bf16x2_hi(f[2][2 * ti + 1], f[3][2 * ti + 1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // B: x row mt * 8 + g at the same 4 rows of K
        const uint2 b = *reinterpret_cast<const uint2*>(
            xs + (mt * 8 + g) * X_ROW + (kk * 16 + 4 * tq) * 2);
        mma_bf16(acc[mt][0], a[0], b.x, b.y);
        mma_bf16(acc[mt][1], a[1], b.x, b.y);
      }
    }
  }

  // C fragment (tile a, element e): output column 4 g + 2 a + e / 2, x
  // row mt * 8 + 2 tq + e % 2. This lane's row m has 4 consecutive
  // columns from `col`.
  const int col = n0 + 32 * warp + 4 * g;
  const float4 sc = *reinterpret_cast<const float4*>(scale + col);
  auto scaled = [&](float4 v) {
    return make_float4(v.x * sc.x, v.y * sc.y, v.z * sc.z, v.w * sc.w);
  };
  if (splits == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = mt * 8 + 2 * tq + e;
        if (m < M)
          store4(out + (int64_t)m * N + col,
                 scaled(make_float4(acc[mt][0][e], acc[mt][0][2 + e],
                                    acc[mt][1][e], acc[mt][1][2 + e])));
      }
    return;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = mt * 8 + 2 * tq + e;
      if (m < M)
        *reinterpret_cast<float4*>(part + ((int64_t)split * M + m) * N + col) =
            make_float4(acc[mt][0][e], acc[mt][0][2 + e], acc[mt][1][e],
                        acc[mt][1][2 + e]);
    }
  if (!last_arrival(counters + blockIdx.x, splits)) return;
  // the last block: each lane folds the positions it wrote, in split
  // order, FOLD partials' loads in flight at a time
  constexpr int FOLD = 8;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = mt * 8 + 2 * tq + e;
      if (m >= M) continue;
      const float* p = part + (int64_t)m * N + col;
      const int64_t stride = (int64_t)M * N;  // between splits
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int sp0 = 0; sp0 < splits; sp0 += FOLD) {
        float4 v[FOLD];
#pragma unroll
        for (int u = 0; u < FOLD; ++u)
          if (sp0 + u < splits)
            v[u] = __ldcg(reinterpret_cast<const float4*>(
                p + (sp0 + u) * stride));
#pragma unroll
        for (int u = 0; u < FOLD; ++u) {
          if (sp0 + u >= splits) break;
          s.x += v[u].x;
          s.y += v[u].y;
          s.z += v[u].z;
          s.w += v[u].w;
        }
      }
      store4(out + (int64_t)m * N + col, scaled(s));
    }
}

// -- float32 x: CUDA cores --------------------------------------------------
constexpr int THREADS = 256;
constexpr int COLS = 8;         // columns per thread (one 8-byte load)
constexpr int KLANES = 16;      // THREADS / (BLOCK_N / COLS)
constexpr int ROWS = 4;         // weight rows per thread per step
constexpr int F_MT = 8;         // x rows per accumulator tile
constexpr int WARPS = THREADS / 32;

// 8 int8 weights packed in a uint2 -> float32.
__device__ __forceinline__ void int8x8(uint2 w, float (&f)[COLS]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = (float)(int8_t)(w.x >> (8 * i));
    f[4 + i] = (float)(int8_t)(w.y >> (8 * i));
  }
}

// grid (N / BLOCK_N, splits), THREADS threads; split s covers weight
// rows [s * k_rows, min(K, (s + 1) * k_rows)), a multiple of KLANES *
// ROWS rows. A block owns 128 columns; its 16 k-lanes walk interleaved
// groups of 4 weight rows with an [8 x rows][8 columns] float32
// accumulator per thread, and the warps' sums meet in shared memory.
__global__ void __launch_bounds__(THREADS, 2)
    w8a16_f32_kernel(const float* __restrict__ x,       // [M, K]
                     const int8_t* __restrict__ q,      // [K, N]
                     const float* __restrict__ scale,   // [N]
                     float* part,                       // [splits, M, N]
                     unsigned* counters,                // [N / BLOCK_N]
                     float* __restrict__ out,           // [M, N]
                     int M, int K, int N, int k_rows) {
  __shared__ float red[WARPS][F_MT][BLOCK_N];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int cg = t % (BLOCK_N / COLS), kl = t / (BLOCK_N / COLS);
  const int n0 = blockIdx.x * BLOCK_N;
  const int split = blockIdx.y;
  const int k_begin = split * k_rows;
  const int k_end = min(K, k_begin + k_rows);
  const bool single = gridDim.y == 1;

  for (int mt = 0; mt < M; mt += F_MT) {
    const float* xrow[F_MT];
#pragma unroll
    for (int r = 0; r < F_MT; ++r)
      xrow[r] = x + (int64_t)min(mt + r, M - 1) * K;  // clamped, unused
    float acc[F_MT][COLS];
#pragma unroll
    for (int r = 0; r < F_MT; ++r)
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
      for (int r = 0; r < F_MT; ++r) {
        const float4 xv = __ldg(reinterpret_cast<const float4*>(xrow[r] + k));
        const float xs[ROWS] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int j = 0; j < ROWS; ++j)
#pragma unroll
          for (int c = 0; c < COLS; ++c)
            acc[r][c] = fmaf(xs[j], wf[j][c], acc[r][c]);
      }
    }

    // the two k-lanes of a warp (lanes l and l ^ 16) share columns
#pragma unroll
    for (int r = 0; r < F_MT; ++r)
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], 16);
    if (lane < 16) {
#pragma unroll
      for (int r = 0; r < F_MT; ++r)
#pragma unroll
        for (int c = 0; c < COLS; ++c) red[warp][r][cg * COLS + c] = acc[r][c];
    }
    __syncthreads();
    for (int i = t; i < F_MT * BLOCK_N; i += THREADS) {
      const int r = i / BLOCK_N, c = i % BLOCK_N;
      const int m = mt + r, n = n0 + c;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[w][r][c];
      if (m < M) {
        if (single) {
          out[(int64_t)m * N + n] = s * scale[n];
        } else {
          part[((int64_t)split * M + m) * N + n] = s;
        }
      }
    }
    __syncthreads();  // red is reused by the next row tile
  }
  if (single || !last_arrival(counters + blockIdx.x, gridDim.y)) return;
  for (int i = t; i < M * BLOCK_N; i += THREADS) {
    const int m = i / BLOCK_N, n = n0 + i % BLOCK_N;
    float s = 0.f;
    for (int sp = 0; sp < (int)gridDim.y; ++sp)
      s += __ldcg(part + ((int64_t)sp * M + m) * N + n);
    out[(int64_t)m * N + n] = s * scale[n];
  }
}

template <int MT>
int launch_tc(const void* x, const int8_t* q, const float* scale, float* part,
              unsigned* counters, void* out, int M, int K, int N, int splits,
              int k_rows, cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<MT>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      w8a16_tc_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  w8a16_tc_kernel<MT><<<dim3(N / BLOCK_N, splits), TC_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)x, q, scale, part, counters, (__nv_bfloat16*)out,
      M, K, N, k_rows);
  return (int)cudaGetLastError();
}

}  // namespace aigw_q

extern "C" {

// One launch; returns cudaGetLastError() after it (0 = launched). part is
// [splits, M, N] float32 scratch and counters N / 128 zeroed uint32 (both
// unused when splits == 1); the kernel leaves the counters zero.
int aigw_w8a16_matmul(const void* x, const void* q, const void* scale,
                      void* part, void* counters, void* out, int M, int K,
                      int N, int splits, int k_rows, int x_dtype,
                      void* stream) {
  using namespace aigw_q;
  if (M < 1 || M > 64 || N % BLOCK_N != 0 || K % BK != 0 ||
      k_rows % BK != 0 || k_rows < BK || splits < 1 || splits > 65535 ||
      (int64_t)splits * k_rows < K || (int64_t)(splits - 1) * k_rows >= K ||
      (splits > 1 && (part == nullptr || counters == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const int8_t* qp = (const int8_t*)q;
  const float* sp = (const float*)scale;
  float* pp = (float*)part;
  unsigned* cp = (unsigned*)counters;
  if (x_dtype == AIGW_F32) {
    w8a16_f32_kernel<<<dim3(N / BLOCK_N, splits), THREADS, 0, s>>>(
        (const float*)x, qp, sp, pp, cp, (float*)out, M, K, N, k_rows);
    return (int)cudaGetLastError();
  }
  if (x_dtype != AIGW_BF16) return (int)cudaErrorInvalidValue;
  const int mt = (M + 7) / 8;  // 8-row tiles of x, rounded up to 1, 2, 4, 8
  auto* launch = mt == 1   ? launch_tc<1>
                 : mt == 2 ? launch_tc<2>
                 : mt <= 4 ? launch_tc<4>
                           : launch_tc<8>;
  return launch(x, qp, sp, pp, cp, out, M, K, N, splits, k_rows, s);
}

}  // extern "C"
