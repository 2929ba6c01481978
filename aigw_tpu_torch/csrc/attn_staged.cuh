// The staged split walk over a paged KV pool, shared by K2/K7 (fused
// decode, decode_fused.cu) and K3-K5 (the multi-query decode and verify
// body, paged_attention.cu); K1's tensor-core kernel stages its keys
// through the same ring (ring_walk).
//
// A (sequence, KV head)'s keys are split over blocks: split s of pps
// pages holds keys [s * pps * page, (s + 1) * pps * page), with (pps,
// n_split) from the shapes alone (split_pages in ops/decode_fused.py).
// A block loads its split's page rows into shared memory once
// (pages_bytes), then 16-byte cp.async copies bring chunks of K and V
// rows into a RING-stage shared-memory ring (ring_walk), so two stages
// are in flight while the warps work on the third; no load waits on a
// page-table read of its own. StagedPool and staged_attend are the
// CUDA-core form of the walk (K2/K7, and K3/K5 for float32 pools): each
// lane group of D / 8 lanes takes one staged key at a time through
// warp_step_rows. The tensor-core form of K3/K5 stages swizzled bf16
// rows through the same ring_walk (paged_attention.cu). After the walk a
// split writes float32 partials (m, l, acc), and the last block of the
// group to arrive (last_arrival) folds them in split order
// (fold_splits), so repeats are bit-identical.

#pragma once

#include "attn_common.cuh"

namespace aigw {

constexpr int FUSED_WARPS = 8;  // warps sharing one staged (b, h, split)
constexpr int RING = 3;         // stages of the key ring
constexpr int STAGE_STEPS = 2;  // keys per lane group per ring stage

// The ring's loop: fetch(chunk, slot) issues the cp.async copies of
// chunk `chunk` into ring slot `slot` (the caller's layout; this loop
// commits), consume(chunk, slot) reads a landed chunk. Chunk c is
// consumed while chunks c + 1 .. c + STAGES - 1 are in flight. Every
// thread of the block must call it; on return every copy has landed and
// every thread is done with the ring.
template <int STAGES, typename Fetch, typename Consume>
__device__ __forceinline__ void ring_walk(int n_chunks, Fetch fetch,
                                          Consume consume) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) fetch(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c landed; slot (c - 1) % STAGES is free
    const int nx = c + STAGES - 1;
    if (nx < n_chunks) fetch(nx, nx % STAGES);
    cp_async_commit();
    consume(c, c % STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Keys per ring stage: STAGE_STEPS per lane group of every warp (D / 8
// lanes per key, 256 / D lane groups per warp).
__host__ __device__ constexpr int stage_keys(int D) {
  return STAGE_STEPS * FUSED_WARPS * 256 / D;
}

// Bytes of one stored pool row of one head: QBITS 0: D elements of TKV;
// 8: D int8; 4: D / 2 bytes of packed int4.
template <typename TKV, int QBITS>
__host__ __device__ constexpr int row_bytes(int D) {
  return QBITS == 4 ? D / 2 : D * (int)sizeof(TKV);
}

// One ring stage: the K rows of its CK keys, their V rows ([CK][RB]
// bytes each), then (quantized pools) their K and V scales ([CK] float32
// each).
template <typename TKV, int QBITS>
__host__ __device__ constexpr int stage_bytes(int D) {
  return 2 * stage_keys(D) * row_bytes<TKV, QBITS>(D) +
         (QBITS > 0 ? 8 * stage_keys(D) : 0);
}

// The pool rows of KV head h as the ring stages and reads them. The
// pool pointers carry no __restrict__: the appending block reads back
// the row (and scales) it wrote earlier in the same launch.
template <typename TKV, int QBITS>
struct StagedPool {
  const unsigned char* k;  // [slots, Hkv, RB] bytes
  const unsigned char* v;
  const float* ks;  // [slots, Hkv] (QBITS > 0)
  const float* vs;
  int Hkv, h, D;

  __device__ __forceinline__ int bytes() const {  // of one ring stage
    return stage_bytes<TKV, QBITS>(D);
  }

  // Copy keys [key0, key0 + CK) below n_keys of the split whose page
  // rows are `pages` into the stage at dst (cp.async; the caller
  // commits). Keys at or past n_keys are not copied.
  __device__ __forceinline__ void fetch(unsigned char* dst, const int* pages,
                                        int page_size, int key0,
                                        int n_keys) const {
    const int CK = stage_keys(D), RB = row_bytes<TKV, QBITS>(D);
    const int cu = min(16, RB);  // bytes per copy
    // copies per row and keys per stage are powers of two: shifts
    const int upr_sh = __ffs(RB / cu) - 1, ck_sh = __ffs(CK) - 1;
    const int n_rows = 2 * CK << upr_sh;
    const int total = n_rows + (QBITS > 0 ? 2 * CK : 0);
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      int kv, j, u = -1;
      if (i < n_rows) {
        kv = i >> (ck_sh + upr_sh);
        j = (i >> upr_sh) & (CK - 1);
        u = i & ((1 << upr_sh) - 1);
      } else {
        kv = (i - n_rows) >> ck_sh;
        j = (i - n_rows) & (CK - 1);
      }
      const int key = key0 + j;
      if (key >= n_keys) continue;
      const int64_t row =
          ((int64_t)pages[key / page_size] * page_size + key % page_size) *
              Hkv + h;
      if (u < 0) {
        cp_async_small<4>(dst + 2 * CK * RB + (kv * CK + j) * 4,
                          (kv ? vs : ks) + row);
        continue;
      }
      const unsigned char* src = (kv ? v : k) + row * RB + u * cu;
      unsigned char* d = dst + (kv * CK + j) * RB + u * cu;
      if (cu == 16) {
        cp_async16(d, src);
      } else if (cu == 8) {
        cp_async_small<8>(d, src);
      } else {
        cp_async_small<4>(d, src);
      }
    }
  }

  // K and V elements [e0, e0 + 8) of the stage's key j, as float32.
  __device__ __forceinline__ void read(const unsigned char* stage, int j,
                                       int e0, float (&kx)[VEC],
                                       float (&vx)[VEC]) const {
    const int CK = stage_keys(D), RB = row_bytes<TKV, QBITS>(D);
    const unsigned char* kr = stage + j * RB;
    const unsigned char* vr = stage + (CK + j) * RB;
    if constexpr (QBITS == 0) {
      load8(reinterpret_cast<const TKV*>(kr) + e0, kx);
      load8(reinterpret_cast<const TKV*>(vr) + e0, vx);
    } else {
      const float* sc = reinterpret_cast<const float*>(stage + 2 * CK * RB);
      if constexpr (QBITS == 8) {
        deq8(*reinterpret_cast<const uint2*>(kr + e0), sc[j], kx);
        deq8(*reinterpret_cast<const uint2*>(vr + e0), sc[CK + j], vx);
      } else {
        deq4(*reinterpret_cast<const uint32_t*>(kr + e0 / 2), sc[j], kx);
        deq4(*reinterpret_cast<const uint32_t*>(vr + e0 / 2), sc[CK + j], vx);
      }
    }
  }

  // int8: element value q * scale, one float32 product (the plain
  // version's dequant).
  __device__ __forceinline__ static void deq8(uint2 u, float s,
                                              float (&x)[VEC]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = __fmul_rn((float)(int8_t)(u.x >> (8 * i)), s);
      x[4 + i] = __fmul_rn((float)(int8_t)(u.y >> (8 * i)), s);
    }
  }
  // int4 packed two per byte (element 2i in the low nibble of byte i,
  // two's complement).
  __device__ __forceinline__ static void deq4(uint32_t u, float s,
                                              float (&x)[VEC]) {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      x[e] = __fmul_rn((float)((int32_t)(u << (28 - 4 * e)) >> 28), s);
  }
};

// The block's online-softmax walk over keys [0, n_keys) of one split
// (its page rows in `pages`), staged through `ring` (RING stages; it
// holds at least FUSED_WARPS * G * (D + 2) floats, which the final
// block_merge reuses); then block_merge with `emit`. Row r attends key j
// of the split only where mask(r, j) holds too. Every thread of the
// block must call it.
template <int G, typename SP, typename Emit, typename Mask = AllRows>
__device__ __forceinline__ void staged_attend(const float (&q)[G][VEC],
                                              int grp, const SP& pool,
                                              const int* pages, int page_size,
                                              int D, int n_keys,
                                              unsigned char* ring, Emit emit,
                                              Mask mask = {}) {
  const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
  const int LG = D / VEC, NG = WARP / LG;
  const int sl = lane / LG, e0 = (lane % LG) * VEC;
  const int CK = stage_keys(D);  // = STAGE_STEPS * FUSED_WARPS * NG
  const int sb = pool.bytes();
  RowState<G> st;
  st.init();
  ring_walk<RING>(
      (n_keys + CK - 1) / CK,
      [&](int c, int slot) {
        pool.fetch(ring + slot * sb, pages, page_size, c * CK, n_keys);
      },
      [&](int c, int slot) {
        const unsigned char* stage = ring + slot * sb;
        float kx[STAGE_STEPS][VEC], vx[STAGE_STEPS][VEC];
        bool valid[STAGE_STEPS];
        int key[STAGE_STEPS];
#pragma unroll
        for (int u = 0; u < STAGE_STEPS; ++u) {
          const int j = (u * FUSED_WARPS + warp) * NG + sl;
          key[u] = c * CK + j;
          valid[u] = key[u] < n_keys;
          if (valid[u]) {
            pool.read(stage, j, e0, kx[u], vx[u]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) kx[u][e] = vx[u][e] = 0.f;
          }
        }
        // every one of the G rows (rows past grp have a zero q and are
        // never emitted): with no exit inside the row loop, the compiler
        // interleaves the rows' shuffle and exp chains
        warp_step_rows<G, STAGE_STEPS>(st, q, G, LG, kx, vx, valid, key,
                                       mask);
      });
  merge_lane_groups<G>(st, grp, LG);
  // ring_walk left every warp done with the ring: block_merge reuses it
  block_merge<G>(st, grp, D, reinterpret_cast<float*>(ring), emit);
}

// Bytes before the ring in dynamic shared memory: the split's page rows.
__host__ __device__ constexpr int pages_bytes(int pps) {
  return (pps * 4 + 15) / 16 * 16;
}

// The fold of a group's split partials, in split order: partial row i of
// split k sits at (i0 + k) * rows + r0 + i (accumulators p_acc[row * D +
// d], maxima p_m[row], denominators p_l[row]); out(i, d, value) receives
// acc / max(l, 1e-30) for rows i < nr (zero for a row with no keys in
// any split). Read with __ldcg, past the SM's L1 (the partials were
// written by other blocks).
template <typename Out>
__device__ __forceinline__ void fold_splits(const float* p_acc,
                                            const float* p_m,
                                            const float* p_l, int64_t i0,
                                            int n_used, int rows, int r0,
                                            int nr, int D, Out out) {
  for (int t = threadIdx.x; t < nr * D; t += blockDim.x) {
    const int r = t / D, d = t % D;
    float mm = NEG;
    for (int k = 0; k < n_used; ++k)
      mm = fmaxf(mm, __ldcg(p_m + (i0 + k) * rows + r0 + r));
    float l = 0.f, a = 0.f;
    for (int k = 0; k < n_used; ++k) {
      const int64_t row = (i0 + k) * rows + r0 + r;
      const float sc = __expf(__ldcg(p_m + row) - mm);
      l += __ldcg(p_l + row) * sc;
      a += __ldcg(p_acc + row * D + d) * sc;
    }
    out(r, d, a / fmaxf(l, 1e-30f));
  }
}

}  // namespace aigw
