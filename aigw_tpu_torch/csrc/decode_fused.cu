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
// What bounds it on the H100: reading the cached K/V bytes of the batch
// (~2 FLOPs per byte), ~10 us for batch 8 at 1000 cached tokens in bf16.
// The first version took 78 us there: its grid (B, Hkv) gave 64 blocks
// to 132 SMs, and each warp ran a dependent chain per step (a page-table
// read, then U = 4 16-byte K/V loads in flight, shuffles, a rescale).
// This version:
// - splits each sequence's keys over blocks: grid (B, Hkv, n_split),
//   split s walks keys [s * pps * page, (s + 1) * pps * page), with
//   (pps, n_split) from the shapes alone (split_pages in
//   ops/decode_fused.py, no host sync); splits past the sequence exit at
//   once;
// - stages keys through shared memory (attn_staged.cuh, shared with
//   K3/K5): the block loads its split's page rows once, then 16-byte
//   cp.async copies bring the K and V rows (the quantized rungs: their
//   int8 or int4 bytes and scales, a half or a quarter of the bytes) of
//   4096 / D keys per stage into a 3-stage ring, so two stages are in
//   flight while the warps run the online softmax on the third
//   (attn_common.cuh's warp_step, two keys per lane group per stage).
//   No load waits on a page-table read of its own;
// - folds the splits in the same launch: each split writes its float32
//   (m, l, acc) partial, and the last block of the (b, h) to arrive
//   (last_arrival) folds them in split order and writes the output. A
//   sequence whose keys fit one split writes its output directly.
// The dequantization stays in registers (q * scale, one float32
// product, the plain version's), so the quantized pages never exist at
// full width in HBM. Measured (PERF.md), this version is no longer
// bound by its bytes but by the walk's per-key instructions: 16 lanes
// share a key, so every row and key pays a 4-level shuffle, and int4
// pages run barely faster than bf16 ones for a quarter of the bytes.
//
// Numerics follow the reference: RoPE in float32 without FMA
// contraction (so the rotated row is bit-identical to the PyTorch
// elementwise version), q rounded to its dtype and then divided by
// sqrt(D), the new key rounded to k_new's dtype and then stored in the
// pool dtype. K7 quantizes the new K and V rows by the kvq recipe:
// absmax over the head's D elements (a block reduction; max is exact in
// any order), scale = absmax * (1 / qmax) (1 when zero; the float32
// reciprocal, as the reference's compiled programs compute it), q =
// clip(rint(x / scale), +-qmax) with IEEE division and
// round-half-to-even, so the bytes equal the plain version's. The walk
// then reads the appended row back, so the current token attends exactly
// the q * scale that later steps read. In the int4 pool one thread owns
// an element pair and writes its whole byte (both nibbles).
//
// Append semantics (pool bytes must match the reference); only the
// block whose split holds the position appends (split 0 for an inactive
// slot):
// - active slot, position % page != 0: write row position % page of
//   page page_table[b, position / page], head h (and its scales);
// - active slot, position % page == 0 (a fresh page): zero every row of
//   that page for head h, scales included, then write row 0;
// - inactive slot: zero every row of the dump page (the pool's last
//   page) for head h, write a zero row with scale 0, and attend nothing
//   (output zeros).
// No other block reads the appended row or the zeroed rows (all at or
// past the position, in the appending split's own pages), so the blocks
// need no ordering. Blocks of different heads write disjoint columns.
// All inactive slots write the same zeros into the dump page, so their
// overlapping writes are benign; no page table references the dump
// page, so no block reads it.

#include "attn_staged.cuh"

namespace aigw {

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

// grid (B, Hkv, n_split), block FUSED_WARPS warps. QBITS 0: native pool
// of TKV; 8: int8 pool (TKV int8_t); 4: packed int4 pool (TKV uint8_t).
// The scale pointers are used only when QBITS > 0. part holds, for the
// splits of each (b, h), float32 accumulators [B, Hkv, n_split, grp, D],
// then maxima and denominators [B, Hkv, n_split, grp]; counters one per
// (b, h). A (b, h) whose keys fit one split uses neither.
// Up to 4 rows per warp fit two blocks per SM in registers (more
// resident warps hide the walk's shuffle and exp chains); 8 rows take one.
template <int G, typename TQ, typename TKV, int QBITS>
__global__ void __launch_bounds__(FUSED_WARPS * WARP, G <= 4 ? 2 : 1)
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
                        float* part, unsigned* counters, int P, int H,
                        int Hkv, int D, int page_size, int dump_page,
                        int pps, float sqrt_d) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_max[FUSED_WARPS];
  const int b = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int n_split = gridDim.z;
  const int grp = H / Hkv;
  const bool act = active[b] != 0;
  const int pos = positions[b];
  const int span = pps * page_size;  // keys per split
  const int n_keys = act ? min(pos + 1, P * page_size) : 0;
  // splits that hold keys; the last of them appends (split 0 when
  // inactive)
  const int n_used = max(1, (n_keys + span - 1) / span);
  if (sp >= n_used) return;
  const int* row_pt = page_table + (int64_t)b * P;
  int* s_pages = reinterpret_cast<int*>(smem);  // this split's page rows
  unsigned char* ring = smem + pages_bytes(pps);
  for (int i = threadIdx.x; i < pps; i += blockDim.x)
    s_pages[i] = row_pt[min(sp * pps + i, P - 1)];
  const float* cs = cos_t + (int64_t)b * D;
  const float* sn = sin_t + (int64_t)b * D;

  // 1. append (see the header note for the page semantics)
  if (sp == n_used - 1) {
    const int RW = QBITS == 4 ? D / 2 : D;  // stored elements per row
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
          k_pool[dst_row * RW + i] =
              (uint8_t)((kq0 & 0xF) | ((kq1 & 0xF) << 4));
          v_pool[dst_row * RW + i] =
              (uint8_t)((vq0 & 0xF) | ((vq1 & 0xF) << 4));
        }
      }
      if (threadIdx.x == 0) {
        k_scale[dst_row] = act ? k_s : 0.f;
        v_scale[dst_row] = act ? v_s : 0.f;
      }
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
  // the walk reads the appended row back from global memory, and the
  // page rows from shared memory: __syncthreads makes both visible
  __syncthreads();

  // 3. online softmax over this split's share of rows [0, pos]
  const int k_lo = sp * span;
  const int n_mine = max(0, min(n_keys - k_lo, span));
  TQ* ob = out + ((int64_t)b * H + (int64_t)h * grp) * D;
  const int64_t rows = (int64_t)gridDim.x * gridDim.y * n_split * grp;
  float* p_acc = part;  // [rows, D]
  float* p_m = part + rows * D;  // [rows]
  float* p_l = p_m + rows;  // [rows]
  const int64_t i0 = ((int64_t)b * Hkv + h) * n_split;  // this (b, h)
  const StagedPool<TKV, QBITS> pool{
      reinterpret_cast<const unsigned char*>(k_pool),
      reinterpret_cast<const unsigned char*>(v_pool), k_scale, v_scale, Hkv,
      h, D};
  staged_attend<G>(qr, grp, pool, s_pages, page_size, D, n_mine, ring,
                   [&](int r, int d, float m, float l, float a) {
                     if (n_used == 1) {
                       ob[r * D + d] = from_f<TQ>(a / fmaxf(l, 1e-30f));
                       return;
                     }
                     const int64_t row = (i0 + sp) * grp + r;
                     p_acc[row * D + d] = a;
                     if (d == 0) {
                       p_m[row] = m;
                       p_l[row] = l;
                     }
                   });
  if (n_used == 1 || !last_arrival(counters + (int64_t)b * Hkv + h, n_used))
    return;
  // 4. the last split of (b, h) to finish folds the partials in split
  // order (the rescaled sums of block_merge's fold of its warps)
  fold_splits(p_acc, p_m, p_l, i0, n_used, grp, 0, grp, D,
              [&](int r, int d, float o) { ob[r * D + d] = from_f<TQ>(o); });
}

}  // namespace aigw

using namespace aigw;

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched). kv_dtype
// AIGW_F32 / AIGW_BF16: native pool, scales unused (null); AIGW_I8 /
// AIGW_I4: quantized pool with its [slots, Hkv] float32 scales. The
// split plan is n_split splits of pps pages each; with n_split > 1, part
// is float32 scratch of n_split * B * H * (D + 2) elements and counters
// B * Hkv zeroed uint32, which the kernel leaves zero.
int aigw_fused_decode(const void* q, const void* k_new, const void* v_new,
                      const float* cos_t, const float* sin_t, void* k_pool,
                      void* v_pool, void* k_scale, void* v_scale,
                      const int* page_table, const int* positions,
                      const int* active, void* out, void* part,
                      void* counters, int B, int P, int H, int Hkv, int D,
                      int page_size, int n_slots, int pps, int n_split,
                      int q_dtype, int kv_dtype, void* stream) {
  const int grp = H / Hkv;
  if (!AIGW_SHAPES_OK(D, grp) || B < 1 || n_slots % page_size != 0 ||
      pps < 1 || n_split < 1 || n_split > 65535 ||
      (int64_t)(n_split - 1) * pps >= P || (int64_t)n_split * pps < P ||
      (n_split > 1 && (part == nullptr || counters == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(B, Hkv, n_split);
  const int dump_page = n_slots / page_size - 1;
  const float sqrt_d = sqrtf((float)D);
#define LAUNCH_Q(G, TQ, TKV, QB)                                            \
  {                                                                         \
    const int ring = RING * stage_bytes<TKV, QB>(D);                        \
    const int merge = FUSED_WARPS * G * (D + 2) * (int)sizeof(float);       \
    const int smem = pages_bytes(pps) + (ring > merge ? ring : merge);      \
    auto kern = fused_decode_kernel<G, TQ, TKV, QB>;                        \
    /* the largest size allowed so far: one runtime call per new size, */\
    /* none on the launch path (and none inside a CUDA graph capture) */   \
    static int smem_set = 0;                                                \
    if (smem > smem_set) {                                                  \
      const cudaError_t e = cudaFuncSetAttribute(                           \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);         \
      if (e != cudaSuccess) return (int)e;                                  \
      smem_set = smem;                                                      \
    }                                                                       \
    kern<<<grid, FUSED_WARPS * WARP, smem, (cudaStream_t)stream>>>(         \
        (const TQ*)q, (const TQ*)k_new, (const TQ*)v_new, cos_t, sin_t,     \
        (TKV*)k_pool, (TKV*)v_pool, (float*)k_scale, (float*)v_scale,       \
        page_table, positions, active, (TQ*)out, (float*)part,              \
        (unsigned*)counters, P, H, Hkv, D, page_size, dump_page, pps,       \
        sqrt_d);                                                            \
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
