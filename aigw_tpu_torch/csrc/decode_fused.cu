// K2 fused decode step (native rung) and K7 (its int8/int4 rung).
//
// Replaces aigw_tpu/ops/pallas/decode_fused.py::fused_paged_decode
// (Pallas kernel _fused_kernel): K2 for bfloat16/float32 pools, K7 for
// int8 and packed-int4 pools with float32 scales [slots, Hkv].
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
// K7 reads (D + 4) bytes (int8) or (D / 2 + 4) bytes (int4) per cached
// row and head instead of 2 D: each lane loads its 8 elements with one
// 8- or 4-byte load plus the row's scale and dequantizes in registers
// (Int8Pool / Int4Pool), so the quantized pages never exist at full
// width in HBM.
//
// Design. The TPU kernel folded the new token in at its finalize step
// because its pipeline wrote the append block only at the end of the
// page axis. Here the block appends first and then walks rows
// [0, position] — scatter-then-walk, the same arithmetic as the plain
// version (paged_decode_walk after the scatter). Rounding follows the
// reference: RoPE in float32 without FMA contraction (so the rotated row
// is bit-identical to the PyTorch elementwise version), q rounded to its
// dtype and then divided by sqrt(D), the new key rounded to k_new's
// dtype and then stored in the pool dtype. K7 quantizes the new K and V
// rows by the kvq recipe: absmax over the head's D elements (a block
// reduction; max is exact in any order), scale = absmax * (1 / qmax) (1
// when zero; the float32 reciprocal, as the reference's compiled
// programs compute it), q = clip(rint(x / scale), +-qmax) with IEEE
// division and round-half-to-even, so the bytes equal the plain
// version's. The walk
// then reads the appended row back, so the current token attends
// exactly the q * scale that later steps read. In the int4 pool one
// thread owns an element pair and writes its whole byte (both nibbles):
// no two threads share a byte.
//
// Append semantics (pool bytes must match the reference):
// - active slot, position % page != 0: write row position % page of
//   page page_table[b, position / page], head h (and its scales);
// - active slot, position % page == 0 (a fresh page): zero every row of
//   that page for head h, scales included, then write row 0;
// - inactive slot: zero every row of the dump page (the pool's last
//   page) for head h, write a zero row with scale 0, and attend nothing
//   (output zeros).
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

// Zero of a pool element type.
template <typename TKV>
__device__ __forceinline__ TKV zero_of() {
  if constexpr (sizeof(TKV) == 1) {
    return TKV(0);
  } else {
    return from_f<TKV>(0.f);
  }
}

// Max of v over the block (every thread passes a value; every thread
// gets the result). buf holds one float per warp; max is exact in any
// order.
__device__ __forceinline__ float block_max(float v, float* buf) {
  for (int o = WARP / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  if (threadIdx.x % WARP == 0) buf[threadIdx.x / WARP] = v;
  __syncthreads();
  float m = buf[0];
  for (int w = 1; w < FUSED_WARPS; ++w) m = fmaxf(m, buf[w]);
  return m;
}

// The kvq recipe for one element: clip(rint(x / scale), +-qmax).
__device__ __forceinline__ int quantize(float x, float scale, float qmax) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -qmax), qmax);
}

// grid (B, Hkv), block FUSED_WARPS warps. QBITS 0: native pool of TKV;
// 8: int8 pool (TKV int8_t); 4: packed int4 pool (TKV uint8_t). The
// scale pointers are used only when QBITS > 0.
template <int G, typename TQ, typename TKV, int QBITS>
__global__ void __launch_bounds__(FUSED_WARPS * WARP)
    fused_decode_kernel(const TQ* __restrict__ q,      // [B, H, D] unroped
                        const TQ* __restrict__ k_new,  // [B, Hkv, D] unroped
                        const TQ* __restrict__ v_new,  // [B, Hkv, D]
                        const float* __restrict__ cos_t,  // [B, D]
                        const float* __restrict__ sin_t,  // [B, D]
                        TKV* k_pool,  // [slots, Hkv, D or D/2], in place
                        TKV* v_pool,
                        float* k_scale,  // [slots, Hkv], in place
                        float* v_scale,
                        const int* __restrict__ page_table,  // [B, P]
                        const int* __restrict__ positions,   // [B]
                        const int* __restrict__ active,      // [B] 0/1
                        TQ* __restrict__ out,                // [B, H, D]
                        int P, int H, int Hkv, int D, int page_size,
                        int dump_page, float sqrt_d) {
  extern __shared__ float smem[];
  __shared__ float s_max[FUSED_WARPS];
  const int b = blockIdx.x, h = blockIdx.y;
  const int grp = H / Hkv;
  const bool act = active[b] != 0;
  const int pos = positions[b];
  const float* cs = cos_t + (int64_t)b * D;
  const float* sn = sin_t + (int64_t)b * D;
  const int RW = QBITS == 4 ? D / 2 : D;  // stored elements per row

  // 1. append (see the header note for the page semantics)
  const int* row_pt = page_table + (int64_t)b * P;
  const int app_row = act ? pos % page_size : 0;
  const int app_page =
      act ? row_pt[min(pos / page_size, P - 1)] : dump_page;
  const int64_t page_base = (int64_t)app_page * page_size;
  if (app_row == 0) {  // fresh page (or the dump page): zero the rest
    for (int i = threadIdx.x; i < (page_size - 1) * RW; i += blockDim.x) {
      const int64_t slot = page_base + 1 + i / RW;
      const int64_t off = (slot * Hkv + h) * RW + i % RW;
      k_pool[off] = zero_of<TKV>();
      v_pool[off] = zero_of<TKV>();
    }
    if constexpr (QBITS > 0) {
      for (int i = threadIdx.x; i < page_size - 1; i += blockDim.x) {
        k_scale[(page_base + 1 + i) * Hkv + h] = 0.f;
        v_scale[(page_base + 1 + i) * Hkv + h] = 0.f;
      }
    }
  }
  // thread i < D / 2 owns element pair (2i, 2i + 1); blockDim >= D / 2
  const int i = threadIdx.x;
  const int j = 2 * i;
  const bool owns = i < D / 2;
  const int64_t src = ((int64_t)b * Hkv + h) * D;
  const int64_t dst_row = (page_base + app_row) * Hkv + h;
  float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
  if (owns && act) {
    float o0, o1;
    rope_pair(to_f(k_new[src + j]), to_f(k_new[src + j + 1]), cs[j],
              sn[j], cs[j + 1], sn[j + 1], &o0, &o1);
    k0 = to_f(from_f<TQ>(o0));  // rounded through k_new's dtype
    k1 = to_f(from_f<TQ>(o1));
    v0 = to_f(v_new[src + j]);
    v1 = to_f(v_new[src + j + 1]);
  }
  if constexpr (QBITS == 0) {
    if (owns) {
      k_pool[dst_row * D + j] = from_f<TKV>(k0);
      k_pool[dst_row * D + j + 1] = from_f<TKV>(k1);
      v_pool[dst_row * D + j] = from_f<TKV>(v0);
      v_pool[dst_row * D + j + 1] = from_f<TKV>(v1);
    }
  } else {
    constexpr float qmax = QBITS == 8 ? 127.f : 7.f;
    constexpr float inv_qmax = 1.f / qmax;  // rounded once, to float32
    const float k_amax = block_max(fmaxf(fabsf(k0), fabsf(k1)), s_max);
    __syncthreads();  // s_max is reused
    const float v_amax = block_max(fmaxf(fabsf(v0), fabsf(v1)), s_max);
    const float k_s = k_amax > 0.f ? __fmul_rn(k_amax, inv_qmax) : 1.f;
    const float v_s = v_amax > 0.f ? __fmul_rn(v_amax, inv_qmax) : 1.f;
    if (owns) {
      const int kq0 = quantize(k0, k_s, qmax), kq1 = quantize(k1, k_s, qmax);
      const int vq0 = quantize(v0, v_s, qmax), vq1 = quantize(v1, v_s, qmax);
      if constexpr (QBITS == 8) {
        k_pool[dst_row * D + j] = (int8_t)kq0;
        k_pool[dst_row * D + j + 1] = (int8_t)kq1;
        v_pool[dst_row * D + j] = (int8_t)vq0;
        v_pool[dst_row * D + j + 1] = (int8_t)vq1;
      } else {  // one byte: element 2i low nibble, 2i + 1 high nibble
        k_pool[dst_row * RW + i] = (uint8_t)((kq0 & 0xF) | ((kq1 & 0xF) << 4));
        v_pool[dst_row * RW + i] = (uint8_t)((vq0 & 0xF) | ((vq1 & 0xF) << 4));
      }
    }
    if (threadIdx.x == 0) {
      k_scale[dst_row] = act ? k_s : 0.f;
      v_scale[dst_row] = act ? v_s : 0.f;
    }
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
    for (int e = 0; e < VEC; e += 2) {
      float o0, o1;
      rope_pair(x[e], x[e + 1], c[e], s[e], c[e + 1], s[e + 1], &o0, &o1);
      qr[r][e] = __fdiv_rn(to_f(from_f<TQ>(o0)), sqrt_d);
      qr[r][e + 1] = __fdiv_rn(to_f(from_f<TQ>(o1)), sqrt_d);
    }
  }
  // the walk reads the appended row back from global memory:
  // __syncthreads makes this block's global writes visible to it
  __syncthreads();

  // 3. online softmax over rows [0, pos] (nothing when inactive)
  const int n_keys = act ? pos + 1 : 0;
  TQ* ob = out + ((int64_t)b * H + (int64_t)h * grp) * D;
  if constexpr (QBITS == 0) {
    decode_attend<G>(qr, grp, NativePool<TKV>{k_pool, v_pool}, row_pt,
                     page_size, Hkv, h, D, n_keys, ob, smem);
  } else if constexpr (QBITS == 8) {
    decode_attend<G>(qr, grp, Int8Pool{k_pool, v_pool, k_scale, v_scale},
                     row_pt, page_size, Hkv, h, D, n_keys, ob, smem);
  } else {
    decode_attend<G>(qr, grp, Int4Pool{k_pool, v_pool, k_scale, v_scale},
                     row_pt, page_size, Hkv, h, D, n_keys, ob, smem);
  }
}

}  // namespace aigw

using namespace aigw;

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched). kv_dtype
// AIGW_F32 / AIGW_BF16: native pool, scales unused (null); AIGW_I8 /
// AIGW_I4: quantized pool with its [slots, Hkv] float32 scales.
int aigw_fused_decode(const void* q, const void* k_new, const void* v_new,
                      const float* cos_t, const float* sin_t, void* k_pool,
                      void* v_pool, void* k_scale, void* v_scale,
                      const int* page_table, const int* positions,
                      const int* active, void* out, int B, int P, int H,
                      int Hkv, int D, int page_size, int n_slots,
                      int q_dtype, int kv_dtype, void* stream) {
  const int grp = H / Hkv;
  if (!AIGW_SHAPES_OK(D, grp) || B < 1 || n_slots % page_size != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(B, Hkv);
  const int dump_page = n_slots / page_size - 1;
  const float sqrt_d = sqrtf((float)D);
#define LAUNCH_Q(G, TQ, TKV, QB)                                            \
  {                                                                         \
    const int smem = FUSED_WARPS * G * (D + 2) * (int)sizeof(float);        \
    auto kern = fused_decode_kernel<G, TQ, TKV, QB>;                        \
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                         smem);                                             \
    kern<<<grid, FUSED_WARPS * WARP, smem, (cudaStream_t)stream>>>(         \
        (const TQ*)q, (const TQ*)k_new, (const TQ*)v_new, cos_t, sin_t,     \
        (TKV*)k_pool, (TKV*)v_pool, (float*)k_scale, (float*)v_scale,       \
        page_table, positions, active, (TQ*)out, P, H, Hkv, D, page_size,   \
        dump_page, sqrt_d);                                                 \
  }
#define LAUNCH(G, TQ, TKV) LAUNCH_Q(G, TQ, TKV, 0)
#define LAUNCH_I8(G, TQ, TKV) LAUNCH_Q(G, TQ, int8_t, 8)
#define LAUNCH_I4(G, TQ, TKV) LAUNCH_Q(G, TQ, uint8_t, 4)
  if (kv_dtype == AIGW_I8 || kv_dtype == AIGW_I4) {
    if (k_scale == nullptr || v_scale == nullptr) {
      return (int)cudaErrorInvalidValue;
    }
    // the quantized rungs dispatch on the query dtype alone
    if (kv_dtype == AIGW_I8) {
      AIGW_DISPATCH(grp, q_dtype, q_dtype, LAUNCH_I8);
    } else {
      AIGW_DISPATCH(grp, q_dtype, q_dtype, LAUNCH_I4);
    }
  } else {
    AIGW_DISPATCH(grp, q_dtype, kv_dtype, LAUNCH);
  }
#undef LAUNCH_I4
#undef LAUNCH_I8
#undef LAUNCH
#undef LAUNCH_Q
  return (int)cudaGetLastError();
}

}  // extern "C"
