// K1 ragged prefill attention and K3 chained paged decode attention.
//
// K1 replaces aigw_tpu/ops/pallas/paged_attention.py::
// ragged_prefill_attention (Pallas kernel _ragged_prefill_kernel).
// K3 replaces aigw_tpu/ops/pallas/paged_attention.py::
// paged_attention_decode_v2 (Pallas kernel _decode_kernel_v2).
//
// What bounds them on the H100: K3 reads each cached K/V byte once for
// ~2 FLOPs per byte, so it is bound by HBM bytes (3.35 TB/s); its blocks
// split each sequence's keys over eight warps so that many 16-byte loads
// are in flight per sequence. K1 does O(rows x keys) work per sequence:
// at prefill lengths of hundreds of tokens it has tens of FLOPs per pool
// byte, under the tensor cores' balance point but above what float32
// dot products on the CUDA cores sustain, so this version is bound by
// its own arithmetic (see PERF.md for the measured gap); the rows of one
// block read the same keys, which the L1 cache serves after the first.
//
// Design. The TPU kernel walked a grid (query block, sequence, page)
// and revisited a query block once per sequence it overlapped, carrying
// the softmax state in VMEM scratch across the sequential page axis.
// Here nothing spans two sequences: the K1 grid is (query tile within
// the sequence, sequence b, KV head), each warp of the block owns one
// packed row (query position) and walks that row's causal key range
// [0, start_pos[b] + row] in registers (warp_walk, attn_common.cuh).
// Blocks whose tile starts past the sequence's length exit at once, so
// the grid is sized from the packed length T without a host sync. Rows
// owned by no sequence stay zero: the wrapper zero-fills the output.

#include "attn_common.cuh"

namespace aigw {

constexpr int PREFILL_WARPS = 4;  // packed rows per K1 block
constexpr int DECODE_WARPS = 8;   // warps sharing one K3 (b, h)

// grid (ceil(T / PREFILL_WARPS), B, Hkv), block PREFILL_WARPS warps
template <int G, typename TQ, typename TKV>
__global__ void __launch_bounds__(PREFILL_WARPS * WARP)
    ragged_prefill_kernel(const TQ* __restrict__ q,        // [T, H, D]
                          const TKV* __restrict__ k_pool,  // [slots, Hkv, D]
                          const TKV* __restrict__ v_pool,
                          const int* __restrict__ page_table,  // [B, P]
                          const int* __restrict__ cu,          // [B + 1]
                          const int* __restrict__ start_pos,   // [B]
                          TQ* __restrict__ out,                // [T, H, D]
                          int P, int H, int Hkv, int D, int page_size,
                          float sqrt_d) {
  const int b = blockIdx.y, h = blockIdx.z;
  const int lo = cu[b], len = cu[b + 1] - lo;
  const int row = blockIdx.x * PREFILL_WARPS + threadIdx.x / WARP;
  if (row >= len) return;  // no block-wide barrier follows
  const int grp = H / Hkv;
  const int lane = threadIdx.x % WARP;
  const int e0 = (lane % (D / VEC)) * VEC;
  const int64_t t = lo + row;
  const TQ* qt = q + (t * H + (int64_t)h * grp) * D;
  float qr[G][VEC];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    float x[VEC] = {};
    if (r < grp) load8(qt + r * D + e0, x);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[r][e] = __fdiv_rn(x[e], sqrt_d);
  }
  RowState<G> st;
  st.init();
  // causal: the row at absolute position start + row attends <= it
  // prefill keeps fewer chunks in flight (its keys are mostly cache
  // hits) for fewer registers and more resident warps
  warp_walk<G, G <= 4 ? 2 : 1>(st, qr, grp, NativePool<TKV>{k_pool, v_pool},
                               page_table + (int64_t)b * P, page_size,
                               Hkv, h, D, start_pos[b] + row + 1, 0, 1);
  if (lane < D / VEC) {
    TQ* ot = out + (t * H + (int64_t)h * grp) * D;
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (r >= grp) break;
      const float inv = 1.f / fmaxf(st.l[r], 1e-30f);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        ot[r * D + e0 + e] = from_f<TQ>(st.acc[r][e] * inv);
    }
  }
}

// grid (B, Hkv), block DECODE_WARPS warps
template <int G, typename TQ, typename TKV>
__global__ void __launch_bounds__(DECODE_WARPS * WARP)
    paged_decode_kernel(const TQ* __restrict__ q,        // [B, H, D]
                        const TKV* __restrict__ k_pool,  // [slots, Hkv, D]
                        const TKV* __restrict__ v_pool,
                        const int* __restrict__ page_table,  // [B, P]
                        const int* __restrict__ lengths,     // [B]
                        TQ* __restrict__ out,                // [B, H, D]
                        int P, int H, int Hkv, int D, int page_size,
                        float sqrt_d) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int grp = H / Hkv;
  const int e0 = (threadIdx.x % WARP % (D / VEC)) * VEC;
  const TQ* qb = q + ((int64_t)b * H + (int64_t)h * grp) * D;
  float qr[G][VEC];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    float x[VEC] = {};
    if (r < grp) load8(qb + r * D + e0, x);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[r][e] = __fdiv_rn(x[e], sqrt_d);
  }
  decode_attend<G>(qr, grp, NativePool<TKV>{k_pool, v_pool},
                   page_table + (int64_t)b * P,
                   page_size, Hkv, h, D, lengths[b],
                   out + ((int64_t)b * H + (int64_t)h * grp) * D, smem);
}

}  // namespace aigw

using namespace aigw;

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int aigw_ragged_prefill(const void* q, const void* k_pool,
                        const void* v_pool, const int* page_table,
                        const int* cu, const int* start_pos, void* out,
                        int T, int B, int P, int H, int Hkv, int D,
                        int page_size, int q_dtype, int kv_dtype,
                        void* stream) {
  const int grp = H / Hkv;
  if (!AIGW_SHAPES_OK(D, grp) || T < 1 || B < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((T + PREFILL_WARPS - 1) / PREFILL_WARPS, B, Hkv);
  const float sqrt_d = sqrtf((float)D);
#define LAUNCH(G, TQ, TKV)                                                  \
  ragged_prefill_kernel<G, TQ, TKV>                                         \
      <<<grid, PREFILL_WARPS * WARP, 0, (cudaStream_t)stream>>>(            \
          (const TQ*)q, (const TKV*)k_pool, (const TKV*)v_pool, page_table, \
          cu, start_pos, (TQ*)out, P, H, Hkv, D, page_size, sqrt_d)
  AIGW_DISPATCH(grp, q_dtype, kv_dtype, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}

int aigw_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                      const int* page_table, const int* lengths, void* out,
                      int B, int P, int H, int Hkv, int D, int page_size,
                      int q_dtype, int kv_dtype, void* stream) {
  const int grp = H / Hkv;
  if (!AIGW_SHAPES_OK(D, grp) || B < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, Hkv);
  const float sqrt_d = sqrtf((float)D);
#define LAUNCH(G, TQ, TKV)                                                  \
  {                                                                         \
    const int smem = DECODE_WARPS * G * (D + 2) * (int)sizeof(float);       \
    auto kern = paged_decode_kernel<G, TQ, TKV>;                            \
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                         smem);                                             \
    kern<<<grid, DECODE_WARPS * WARP, smem, (cudaStream_t)stream>>>(        \
        (const TQ*)q, (const TKV*)k_pool, (const TKV*)v_pool, page_table,   \
        lengths, (TQ*)out, P, H, Hkv, D, page_size, sqrt_d);                \
  }
  AIGW_DISPATCH(grp, q_dtype, kv_dtype, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
