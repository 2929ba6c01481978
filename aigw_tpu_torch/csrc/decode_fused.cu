// K2 fused decode step, native-dtype rung.
//
// Replaces aigw_tpu/ops/pallas/decode_fused.py::fused_paged_decode
// (Pallas kernel _fused_kernel) for bfloat16/float32 pools.
//
// One launch per layer per decode step does, for each (slot b, KV head
// h): interleaved RoPE of the group's query heads and of the new key
// from per-step cos/sin tables, the in-place append of the new K/V row
// into its page, and the online-softmax walk over the slot's pool rows
// up to and including the new one.
//
// What bounds it on the H100: like the chained decode kernel, reading
// the cached K/V bytes of the batch (~2 FLOPs per byte). Fusing RoPE
// and the append into the walk saves the separate rope, scatter and
// their HBM round trips of the chained rung; the walk itself is the
// shared decode_attend (attn_common.cuh): eight warps per (b, h) over
// interleaved key chunks, 16-byte loads, the softmax state in registers.
//
// Design. The TPU kernel folded the new token in at its finalize step
// because its pipeline wrote the append block only at the end of the
// page axis. Here the block appends first and then walks rows
// [0, position] — scatter-then-walk, the same arithmetic as the plain
// version (paged_decode_walk after the scatter). Rounding follows the
// reference: RoPE in float32 without FMA contraction (so the rotated row
// is bit-identical to the PyTorch elementwise version), q rounded to its
// dtype and then divided by sqrt(D), the new key rounded to k_new's
// dtype and then stored in the pool dtype.
//
// Append semantics (pool bytes must match the reference):
// - active slot, position % page != 0: write row position % page of
//   page page_table[b, position / page], head h;
// - active slot, position % page == 0 (a fresh page): zero every row of
//   that page for head h, then write row 0;
// - inactive slot: zero every row of the dump page (the pool's last
//   page) for head h, and attend nothing (output zeros).
// Blocks of different heads write disjoint columns. All inactive slots
// write the same zeros into the dump page, so their overlapping writes
// are benign; no page table references the dump page, so no block
// reads it.

#include "attn_common.cuh"

namespace aigw {

constexpr int FUSED_WARPS = 8;  // warps sharing one (b, h)

// RoPE of element pair (x[2i], x[2i+1]) with the interleaved tables
// (column d carries angle(pos, d / 2)); no FMA contraction.
__device__ __forceinline__ void rope_pair(float x0, float x1, float c0,
                                          float s0, float c1, float s1,
                                          float* o0, float* o1) {
  *o0 = __fsub_rn(__fmul_rn(x0, c0), __fmul_rn(x1, s0));
  *o1 = __fadd_rn(__fmul_rn(x1, c1), __fmul_rn(x0, s1));
}

// grid (B, Hkv), block FUSED_WARPS warps
template <int G, typename TQ, typename TKV>
__global__ void __launch_bounds__(FUSED_WARPS * WARP)
    fused_decode_kernel(const TQ* __restrict__ q,      // [B, H, D] unroped
                        const TQ* __restrict__ k_new,  // [B, Hkv, D] unroped
                        const TQ* __restrict__ v_new,  // [B, Hkv, D]
                        const float* __restrict__ cos_t,  // [B, D]
                        const float* __restrict__ sin_t,  // [B, D]
                        TKV* k_pool,  // [slots, Hkv, D], updated in place
                        TKV* v_pool,
                        const int* __restrict__ page_table,  // [B, P]
                        const int* __restrict__ positions,   // [B]
                        const int* __restrict__ active,      // [B] 0/1
                        TQ* __restrict__ out,                // [B, H, D]
                        int P, int H, int Hkv, int D, int page_size,
                        int dump_page, float sqrt_d) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int grp = H / Hkv;
  const bool act = active[b] != 0;
  const int pos = positions[b];
  const float* cs = cos_t + (int64_t)b * D;
  const float* sn = sin_t + (int64_t)b * D;

  // 1. append (see the header note for the page semantics)
  const int* row_pt = page_table + (int64_t)b * P;
  const int app_row = act ? pos % page_size : 0;
  const int app_page =
      act ? row_pt[min(pos / page_size, P - 1)] : dump_page;
  const int64_t page_base = (int64_t)app_page * page_size;
  if (app_row == 0) {  // fresh page (or the dump page): zero the rest
    for (int i = threadIdx.x; i < (page_size - 1) * D; i += blockDim.x) {
      const int64_t slot = page_base + 1 + i / D;
      const int64_t off = (slot * Hkv + h) * D + i % D;
      k_pool[off] = from_f<TKV>(0.f);
      v_pool[off] = from_f<TKV>(0.f);
    }
  }
  for (int i = threadIdx.x; i < D / 2; i += blockDim.x) {
    const int j = 2 * i;
    const int64_t src = ((int64_t)b * Hkv + h) * D;
    const int64_t dst = ((page_base + app_row) * Hkv + h) * D;
    float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
    if (act) {
      float o0, o1;
      rope_pair(to_f(k_new[src + j]), to_f(k_new[src + j + 1]), cs[j],
                sn[j], cs[j + 1], sn[j + 1], &o0, &o1);
      k0 = to_f(from_f<TQ>(o0));  // rounded through k_new's dtype
      k1 = to_f(from_f<TQ>(o1));
      v0 = to_f(v_new[src + j]);
      v1 = to_f(v_new[src + j + 1]);
    }
    k_pool[dst + j] = from_f<TKV>(k0);
    k_pool[dst + j + 1] = from_f<TKV>(k1);
    v_pool[dst + j] = from_f<TKV>(v0);
    v_pool[dst + j + 1] = from_f<TKV>(v1);
  }

  // 2. this lane's slice of the roped query rows -> q dtype -> / sqrt(D)
  const int e0 = (threadIdx.x % WARP % (D / VEC)) * VEC;
  const TQ* qb = q + ((int64_t)b * H + (int64_t)h * grp) * D;
  float c[VEC], s[VEC];
  load8(cs + e0, c);
  load8(sn + e0, s);
  float qr[G][VEC];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    float x[VEC] = {};
    if (r < grp) load8(qb + r * D + e0, x);
#pragma unroll
    for (int j = 0; j < VEC; j += 2) {
      float o0, o1;
      rope_pair(x[j], x[j + 1], c[j], s[j], c[j + 1], s[j + 1], &o0, &o1);
      qr[r][j] = __fdiv_rn(to_f(from_f<TQ>(o0)), sqrt_d);
      qr[r][j + 1] = __fdiv_rn(to_f(from_f<TQ>(o1)), sqrt_d);
    }
  }
  // the walk reads the appended row back from global memory:
  // __syncthreads makes this block's global writes visible to it
  __syncthreads();

  // 3. online softmax over rows [0, pos] (nothing when inactive)
  decode_attend<G>(qr, grp, (const TKV*)k_pool, (const TKV*)v_pool, row_pt,
                   page_size, Hkv, h, D, act ? pos + 1 : 0,
                   out + ((int64_t)b * H + (int64_t)h * grp) * D, smem);
}

}  // namespace aigw

using namespace aigw;

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int aigw_fused_decode(const void* q, const void* k_new, const void* v_new,
                      const float* cos_t, const float* sin_t, void* k_pool,
                      void* v_pool, const int* page_table,
                      const int* positions, const int* active, void* out,
                      int B, int P, int H, int Hkv, int D, int page_size,
                      int n_slots, int q_dtype, int kv_dtype, void* stream) {
  const int grp = H / Hkv;
  if (!AIGW_SHAPES_OK(D, grp) || B < 1 || n_slots % page_size != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(B, Hkv);
  const int dump_page = n_slots / page_size - 1;
  const float sqrt_d = sqrtf((float)D);
#define LAUNCH(G, TQ, TKV)                                                  \
  {                                                                         \
    const int smem = FUSED_WARPS * G * (D + 2) * (int)sizeof(float);        \
    auto kern = fused_decode_kernel<G, TQ, TKV>;                            \
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                         smem);                                             \
    kern<<<grid, FUSED_WARPS * WARP, smem, (cudaStream_t)stream>>>(         \
        (const TQ*)q, (const TQ*)k_new, (const TQ*)v_new, cos_t, sin_t,     \
        (TKV*)k_pool, (TKV*)v_pool, page_table, positions, active,          \
        (TQ*)out, P, H, Hkv, D, page_size, dump_page, sqrt_d);              \
  }
  AIGW_DISPATCH(grp, q_dtype, kv_dtype, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
