// K1 ragged prefill attention, K3 chained paged decode attention, K4
// split paged decode attention and K5 speculative verify attention.
//
// K1 replaces aigw_tpu/ops/pallas/paged_attention.py::
// ragged_prefill_attention (Pallas kernel _ragged_prefill_kernel).
// K3 replaces aigw_tpu/ops/pallas/paged_attention.py::
// paged_attention_decode_v2 (Pallas kernel _decode_kernel_v2).
// K4 replaces aigw_tpu/ops/pallas/paged_attention.py::
// paged_attention_decode (v1, Pallas kernel _decode_kernel).
// K5 replaces aigw_tpu/ops/pallas/paged_attention.py::
// paged_attention_verify (Pallas kernel _verify_kernel).
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
//
// K5 (verify) is S decode rows per sequence, query s at position
// pos0 + s attending keys <= it: grid (B, Hkv, S), each block K3's
// walk over pos0 + s + 1 keys (none for a slot that is off, pos0 <= -S).
// Keeping one query position per block holds a warp's registers at K3's
// G rows; holding all S x G rows in one warp would spill. The S blocks of
// a (b, h) re-read the same pages, mostly from L2 since they run
// together; K5 is bound by the bytes of one read of each sequence's
// cached K/V, which it does not reach at S = 5 (PERF.md).
//
// K4 (decode v1) computes K3's function. The TPU's v1 grid walked one
// page per grid step along a sequential page axis; here that axis
// becomes a split over keys across blocks: grid (B, Hkv, n_split), block
// `sp` walks pages [sp * pps, (sp + 1) * pps) and writes its float32
// partial state (running max, denominator, unnormalized accumulator),
// and a second launch folds the n_split partials in a fixed order. The
// split fills the card where K3's B x Hkv blocks do not (batch 8: 64
// blocks on 132 SMs); the wrapper sizes n_split from the page-table
// width, with no host sync.

#include "attn_common.cuh"

namespace aigw {

constexpr int PREFILL_WARPS = 4;  // packed rows per K1 block
constexpr int DECODE_WARPS = 8;   // warps sharing one K3/K4/K5 block
constexpr int COMBINE_THREADS = 128;  // K4's fold of the partials

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

// The G query rows of KV head h at row `row` (= (token) * H + h * grp
// head rows) as this lane's float32 slice, divided by sqrt(D).
template <int G, typename TQ>
__device__ __forceinline__ void load_q(const TQ* q, int64_t row, int grp,
                                       int D, float sqrt_d,
                                       float (&qr)[G][VEC]) {
  const int e0 = (threadIdx.x % WARP % (D / VEC)) * VEC;
#pragma unroll
  for (int r = 0; r < G; ++r) {
    float x[VEC] = {};
    if (r < grp) load8(q + (row + r) * D + e0, x);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[r][e] = __fdiv_rn(x[e], sqrt_d);
  }
}

// K5: grid (B, Hkv, S), block DECODE_WARPS warps
template <int G, typename TQ, typename TKV>
__global__ void __launch_bounds__(DECODE_WARPS * WARP)
    paged_verify_kernel(const TQ* __restrict__ q,        // [B, S, H, D]
                        const TKV* __restrict__ k_pool,  // [slots, Hkv, D]
                        const TKV* __restrict__ v_pool,
                        const int* __restrict__ page_table,  // [B, P]
                        const int* __restrict__ positions,   // [B]
                        TQ* __restrict__ out,                // [B, S, H, D]
                        int S, int P, int H, int Hkv, int D, int page_size,
                        float sqrt_d) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int grp = H / Hkv;
  const int64_t row = ((int64_t)b * S + s) * H + (int64_t)h * grp;
  float qr[G][VEC];
  load_q<G>(q, row, grp, D, sqrt_d, qr);
  // query s attends keys <= pos0 + s, within the table's P pages (a
  // query past them is past its slot's limit: its output is discarded)
  const int n_keys = max(0, min(positions[b] + s + 1, P * page_size));
  decode_attend<G>(qr, grp, NativePool<TKV>{k_pool, v_pool},
                   page_table + (int64_t)b * P, page_size, Hkv, h, D,
                   n_keys, out + row * D, smem);
}

// K4, first launch: grid (B, Hkv, n_split), block DECODE_WARPS warps.
// Split sp writes, for its pages [sp * pps, (sp + 1) * pps) of sequence
// b, the partial state of each group row r: part_acc[(i * grp + r) * D
// + d], part_m[i * grp + r], part_l[i * grp + r], i = (b * Hkv + h) *
// n_split + sp.
template <int G, typename TQ, typename TKV>
__global__ void __launch_bounds__(DECODE_WARPS * WARP)
    paged_split_kernel(const TQ* __restrict__ q,        // [B, H, D]
                       const TKV* __restrict__ k_pool,  // [slots, Hkv, D]
                       const TKV* __restrict__ v_pool,
                       const int* __restrict__ page_table,  // [B, P]
                       const int* __restrict__ lengths,     // [B]
                       float* __restrict__ part_acc, float* __restrict__ part_m,
                       float* __restrict__ part_l, int P, int H, int Hkv,
                       int D, int page_size, int pps, int n_split,
                       float sqrt_d) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int grp = H / Hkv;
  float qr[G][VEC];
  load_q<G>(q, (int64_t)b * H + (int64_t)h * grp, grp, D, sqrt_d, qr);
  // this split's keys, counted from its first page (the walk reads key
  // j of the split at page_row[j / page_size], page_row = its first page)
  const int k_lo = sp * pps * page_size;
  const int n_keys =
      max(0, min(min(lengths[b], P * page_size) - k_lo, pps * page_size));
  const int64_t i = ((int64_t)b * Hkv + h) * n_split + sp;
  float* acc = part_acc + i * grp * D;
  float* pm = part_m + i * grp;
  float* pl = part_l + i * grp;
  block_attend<G>(qr, grp, NativePool<TKV>{k_pool, v_pool},
                  page_table + (int64_t)b * P + (int64_t)sp * pps, page_size,
                  Hkv, h, D, n_keys, smem,
                  [acc, pm, pl, D](int r, int d, float m, float l, float a) {
                    acc[r * D + d] = a;
                    if (d == 0) {
                      pm[r] = m;
                      pl[r] = l;
                    }
                  });
}

// K4, second launch: grid (B, Hkv), COMBINE_THREADS threads; folds the
// n_split partials of each group row in split order (the same rescaled
// sums as decode_attend's fold of its warps) and writes out [B, H, D].
template <typename TQ>
__global__ void __launch_bounds__(COMBINE_THREADS)
    paged_combine_kernel(const float* __restrict__ part_acc,
                         const float* __restrict__ part_m,
                         const float* __restrict__ part_l,
                         TQ* __restrict__ out, int H, int Hkv, int D,
                         int n_split) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int grp = H / Hkv;
  const int64_t i0 = ((int64_t)b * Hkv + h) * n_split;
  TQ* ob = out + ((int64_t)b * H + (int64_t)h * grp) * D;
  for (int t = threadIdx.x; t < grp * D; t += blockDim.x) {
    const int r = t / D, d = t % D;
    float mm = NEG;
    for (int sp = 0; sp < n_split; ++sp)
      mm = fmaxf(mm, part_m[(i0 + sp) * grp + r]);
    float l = 0.f, a = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const int64_t j = (i0 + sp) * grp + r;
      const float sc = __expf(part_m[j] - mm);
      l += part_l[j] * sc;
      a += part_acc[j * D + d] * sc;
    }
    ob[r * D + d] = from_f<TQ>(a / fmaxf(l, 1e-30f));
  }
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

int aigw_paged_verify(const void* q, const void* k_pool, const void* v_pool,
                      const int* page_table, const int* positions, void* out,
                      int B, int S, int P, int H, int Hkv, int D,
                      int page_size, int q_dtype, int kv_dtype,
                      void* stream) {
  const int grp = H / Hkv;
  if (!AIGW_SHAPES_OK(D, grp) || B < 1 || S < 1 || S > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(B, Hkv, S);
  const float sqrt_d = sqrtf((float)D);
#define LAUNCH(G, TQ, TKV)                                                  \
  {                                                                         \
    const int smem = DECODE_WARPS * G * (D + 2) * (int)sizeof(float);       \
    auto kern = paged_verify_kernel<G, TQ, TKV>;                            \
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                         smem);                                             \
    kern<<<grid, DECODE_WARPS * WARP, smem, (cudaStream_t)stream>>>(        \
        (const TQ*)q, (const TKV*)k_pool, (const TKV*)v_pool, page_table,   \
        positions, (TQ*)out, S, P, H, Hkv, D, page_size, sqrt_d);           \
  }
  AIGW_DISPATCH(grp, q_dtype, kv_dtype, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}

// part: float32 scratch of n_split * B * Hkv * grp * (D + 2) elements
// (accumulators, then maxima, then denominators).
int aigw_paged_decode_split(const void* q, const void* k_pool,
                            const void* v_pool, const int* page_table,
                            const int* lengths, void* out, float* part,
                            int B, int P, int H, int Hkv, int D,
                            int page_size, int pps, int n_split,
                            int q_dtype, int kv_dtype, void* stream) {
  const int grp = H / Hkv;
  if (!AIGW_SHAPES_OK(D, grp) || B < 1 || pps < 1 || n_split < 1 ||
      n_split > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t rows = (int64_t)B * Hkv * n_split * grp;
  float* part_acc = part;
  float* part_m = part_acc + rows * D;
  float* part_l = part_m + rows;
  const dim3 grid(B, Hkv, n_split);
  const float sqrt_d = sqrtf((float)D);
#define LAUNCH(G, TQ, TKV)                                                  \
  {                                                                         \
    const int smem = DECODE_WARPS * G * (D + 2) * (int)sizeof(float);       \
    auto kern = paged_split_kernel<G, TQ, TKV>;                             \
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                         smem);                                             \
    kern<<<grid, DECODE_WARPS * WARP, smem, (cudaStream_t)stream>>>(        \
        (const TQ*)q, (const TKV*)k_pool, (const TKV*)v_pool, page_table,   \
        lengths, part_acc, part_m, part_l, P, H, Hkv, D, page_size, pps,    \
        n_split, sqrt_d);                                                   \
  }
  AIGW_DISPATCH(grp, q_dtype, kv_dtype, LAUNCH);
#undef LAUNCH
  const dim3 grid2(B, Hkv);
  if (q_dtype == AIGW_F32) {
    paged_combine_kernel<float>
        <<<grid2, COMBINE_THREADS, 0, (cudaStream_t)stream>>>(
            part_acc, part_m, part_l, (float*)out, H, Hkv, D, n_split);
  } else {
    paged_combine_kernel<__nv_bfloat16>
        <<<grid2, COMBINE_THREADS, 0, (cudaStream_t)stream>>>(
            part_acc, part_m, part_l, (__nv_bfloat16*)out, H, Hkv, D,
            n_split);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
