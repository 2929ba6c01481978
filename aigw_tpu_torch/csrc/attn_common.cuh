// Shared device code of the paged-attention kernels (K1 ragged prefill,
// K2/K7 fused decode, K3/K4 paged decode, K5 verify), the tensor-core
// fragments K1, K3/K5 and K6 (qmatmul.cu) use, and the asynchronous-copy
// and split-fold helpers of K1, K2/K7, K3/K5 and K6.
//
// Work split. One warp carries the query rows of one query position
// that share a KV head (the GQA group, at most G = 4 or 8 rows) as
// float32 registers. Lane l holds head-dim elements [8 * (l % LG), +8)
// of every row, where LG = D / 8 lanes span one head row, so the warp
// covers NG = 32 / LG keys at a time, one per group of LG lanes. Each
// lane loads its 8 elements of the key's K and V rows with one 16-byte
// load (bf16; two for float32), the lane group sums the partial q.k
// dots with shuffles, and every lane keeps its lane group's
// online-softmax state (running max m, denominator l, accumulator acc)
// in registers. After the walk the NG lane groups merge their states
// with shuffles; the staged walk's warps then merge theirs through
// shared memory (block_merge). K1's CUDA-core kernel gives each warp its
// own query position and needs no merge across warps.
//
// This replaces the TPU kernels' sequential page axis, whose softmax
// state lived in VMEM scratch across grid steps: here the page walk is
// a loop inside the warp and the state never leaves registers.
//
// Bound on the H100: the decode walks read every cached K/V byte once
// for ~2 FLOPs per byte, far below the card's ~295 FLOPs/byte balance
// point, so their floor is HBM bytes. What holds the register walk
// (warp_walk: K1 on the CUDA cores) above it is latency: each warp runs
// a dependent chain per step (a page-table read, then 16-byte K/V loads
// in flight, shuffles, a rescale). The staged walk (attn_staged.cuh:
// K2/K7, K3-K5, and K1's tensor-core kernel) removes that chain: its
// blocks stage whole chunks of keys into a shared-memory ring with
// cp.async while the warps work on the chunk before; the decode walks'
// split over keys then folds in the same launch through last_arrival.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace aigw {

constexpr int WARP = 32;
constexpr int VEC = 8;           // head-dim elements one lane holds
constexpr float NEG = -1e30f;    // initial running max, as the plain versions
constexpr unsigned FULL = 0xffffffffu;

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
  return __float2bfloat16_rn(x);  // round to nearest even, like astype
}

// 8 consecutive elements at p (16-byte aligned) as float32.
__device__ __forceinline__ void load8(const float* p, float (&x)[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Online-softmax state of G query rows, one lane's slice of the head dim.
template <int G>
struct RowState {
  float m[G], l[G], acc[G][VEC];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      m[r] = NEG;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
    }
  }

  // Fold another state (m2, l2, acc2) of row r into this one.
  __device__ __forceinline__ void merge_row(int r, float m2, float l2,
                                            const float (&acc2)[VEC]) {
    const float mm = fmaxf(m[r], m2);
    const float a1 = __expf(m[r] - mm), a2 = __expf(m2 - mm);
    l[r] = l[r] * a1 + l2 * a2;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = acc[r][e] * a1 + acc2[e] * a2;
    m[r] = mm;
  }
};

// Pool view of the register walk: how it reads the K and V elements
// [e0, e0 + 8) of pool slot `slot`, KV head h, as float32.
template <typename TKV>
struct NativePool {  // [slots, Hkv, D] float32 / bfloat16
  const TKV* k;
  const TKV* v;
  __device__ __forceinline__ void load(int64_t slot, int Hkv, int h, int D,
                                       int e0, float (&kx)[VEC],
                                       float (&vx)[VEC]) const {
    const int64_t off = (slot * Hkv + h) * D + e0;
    load8(k + off, kx);
    load8(v + off, vx);
  }
};

// K and V elements [e0, e0 + 8) of key position `key` of one sequence,
// KV head h; zeros when key >= n_keys. Key position j lives at pool
// slot page_row[j / page_size] * page_size + j % page_size.
template <typename Pool>
__device__ __forceinline__ void load_key(const Pool& pool,
                                         const int* __restrict__ page_row,
                                         int page_size, int Hkv, int h, int D,
                                         int e0, int key, int n_keys,
                                         float (&kx)[VEC], float (&vx)[VEC]) {
  if (key < n_keys) {
    const int64_t slot =
        (int64_t)page_row[key / page_size] * page_size + key % page_size;
    pool.load(slot, Hkv, h, D, e0, kx, vx);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) kx[e] = vx[e] = 0.f;
  }
}

// Every (row, key) pair is attended: the mask of the decode walks, whose
// rows share one key range.
struct AllRows {
  __device__ __forceinline__ bool operator()(int, int) const { return true; }
};

// One online-softmax step of a warp over U keys per lane group: the
// lane group's K/V slices kx[u], vx[u] of key u (valid[u] false: skipped),
// LG = D / VEC lanes per key. One softmax rescale per step, not per key.
// q holds this lane's slice of the query rows, already divided by
// sqrt(D); rows >= grp are skipped (grp is uniform across the warp, so
// are the shuffles). Row r attends key u only where mask(r, key[u])
// holds as well (the multi-query walk's per-row causal limit).
template <int G, int U, typename Mask>
__device__ __forceinline__ void warp_step_rows(
    RowState<G>& st, const float (&q)[G][VEC], int grp, int LG,
    const float (&kx)[U][VEC], const float (&vx)[U][VEC],
    const bool (&valid)[U], const int (&key)[U], Mask mask) {
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (r >= grp) break;
    float s[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = valid[u] && mask(r, key[u]);
      s[u] = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) s[u] = fmaf(q[r][e], kx[u][e], s[u]);
    }
    for (int o = LG / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) s[u] += __shfl_xor_sync(FULL, s[u], o);
    }
    float m_new = st.m[r];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (ok[u]) m_new = fmaxf(m_new, s[u]);
    const float alpha = __expf(st.m[r] - m_new);
    st.l[r] *= alpha;
#pragma unroll
    for (int e = 0; e < VEC; ++e) st.acc[r][e] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      const float p = __expf(s[u] - m_new);
      st.l[r] += p;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        st.acc[r][e] = fmaf(p, vx[u][e], st.acc[r][e]);
    }
    st.m[r] = m_new;
  }
}

// warp_step_rows where every row attends every valid key.
template <int G, int U>
__device__ __forceinline__ void warp_step(RowState<G>& st,
                                          const float (&q)[G][VEC], int grp,
                                          int LG, const float (&kx)[U][VEC],
                                          const float (&vx)[U][VEC],
                                          const bool (&valid)[U]) {
  const int key[U] = {};
  warp_step_rows<G, U>(st, q, grp, LG, kx, vx, valid, key, AllRows{});
}

// Merge the lane groups of a warp (lanes with the same e0 sit LG apart):
// afterwards every lane group holds the warp's state.
template <int G>
__device__ __forceinline__ void merge_lane_groups(RowState<G>& st, int grp,
                                                  int LG) {
  for (int o = LG; o < WARP; o <<= 1) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (r >= grp) break;
      const float m2 = __shfl_xor_sync(FULL, st.m[r], o);
      const float l2 = __shfl_xor_sync(FULL, st.l[r], o);
      float acc2[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc2[e] = __shfl_xor_sync(FULL, st.acc[r][e], o);
      st.merge_row(r, m2, l2, acc2);
    }
  }
}

// One warp's online-softmax walk over the keys c * NG + (lane group) for
// key chunks c = c0, c0 + c_step, ... below n_keys, U chunks per step:
// U independent K/V loads in flight per lane (each a page-table read,
// then the row's loads). Ends with the lane groups' states merged.
template <int G, int U, typename Pool>
__device__ __forceinline__ void warp_walk(RowState<G>& st,
                                          const float (&q)[G][VEC], int grp,
                                          const Pool& pool,
                                          const int* __restrict__ page_row,
                                          int page_size, int Hkv, int h,
                                          int D, int n_keys, int c0,
                                          int c_step) {
  const int lane = threadIdx.x % WARP;
  const int LG = D / VEC, NG = WARP / LG;
  const int slot_in_chunk = lane / LG;
  const int e0 = (lane % LG) * VEC;
  for (int c = c0; c * NG < n_keys; c += U * c_step) {
    float kx[U][VEC], vx[U][VEC];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = (c + u * c_step) * NG + slot_in_chunk;
      valid[u] = key < n_keys;
      load_key(pool, page_row, page_size, Hkv, h, D, e0, key, n_keys,
               kx[u], vx[u]);
    }
    warp_step<G, U>(st, q, grp, LG, kx, vx, valid);
  }
  merge_lane_groups<G>(st, grp, LG);
}

// The fold of block_merge: the states of nwarps warps in smem (float32
// accumulators [nwarps][G][D], then maxima and denominators [nwarps][G])
// rescaled to their common maximum and summed in warp order; emit(r, d,
// m, l, a) receives each element d of rows r < grp. The caller
// synchronizes the block after writing smem.
template <typename Emit>
__device__ __forceinline__ void fold_warps(int nwarps, int G, int grp, int D,
                                           const float* smem, Emit emit) {
  const float* s_acc = smem;                  // [nwarps][G][D]
  const float* s_m = s_acc + nwarps * G * D;  // [nwarps][G]
  const float* s_l = s_m + nwarps * G;        // [nwarps][G]
  for (int i = threadIdx.x; i < grp * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    float mm = NEG;
    for (int w = 0; w < nwarps; ++w) mm = fmaxf(mm, s_m[w * G + r]);
    float l = 0.f, a = 0.f;
    for (int w = 0; w < nwarps; ++w) {
      const float sc = __expf(s_m[w * G + r] - mm);
      l += s_l[w * G + r] * sc;
      a += s_acc[(w * G + r) * D + d] * sc;
    }
    emit(r, d, mm, l, a);
  }
}

// The block's warps merge their states (each already merged over its
// lane groups) through shared memory; emit(r, d, m, l, a) then receives,
// once per element d of each group row r, the block's merged running max
// m, denominator l and unnormalized accumulator a. smem holds nwarps * G
// * (D + 2) floats. Every thread of the block must call it.
template <int G, typename Emit>
__device__ __forceinline__ void block_merge(const RowState<G>& st, int grp,
                                            int D, float* smem, Emit emit) {
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int nwarps = blockDim.x / WARP;
  float* s_acc = smem;                       // [nwarps][G][D]
  float* s_m = s_acc + nwarps * G * D;       // [nwarps][G]
  float* s_l = s_m + nwarps * G;             // [nwarps][G]
  const int LG = D / VEC;
  if (lane < LG) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (r >= grp) break;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        s_acc[(warp * G + r) * D + lane * VEC + e] = st.acc[r][e];
      if (lane == 0) {
        s_m[warp * G + r] = st.m[r];
        s_l[warp * G + r] = st.l[r];
      }
    }
  }
  __syncthreads();
  fold_warps(nwarps, G, grp, D, smem, emit);
}

// -- asynchronous copies into shared memory (K2/K7's page ring, K6's
// weight ring) -----------------------------------------------------------
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared through L2 only; src_bytes < 16 zero-fills
// the rest (0: nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
// N = 4 or 8 bytes global -> shared.
template <int N>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(N));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- tensor-core fragments (K6, and K1's and K3/K5's bf16 paths) ----------
// c += a b: one m16n8k16 product, bf16 in, float32 accumulate. Lane (g =
// lane / 4, t = lane % 4) holds A (row-major 16 x 16) elements (g, 2t..),
// (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..) in a[0..3], two per
// register; B (16 x 8, k by n) elements (2t.., g) in b0 and (2t + 8.., g)
// in b1; C elements (g, 2t..) in c[0..1] and (g + 8, 2t..) in c[2..3].
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Four 8 x 8 bf16 matrices from shared memory: lane i gives the address
// of row i % 8 of matrix i / 8; r[j] receives matrix j's elements (lane /
// 4, 2 (lane % 4) ..).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// The same, transposed: r[j] receives matrix j's elements (2 (lane % 4)
// .., lane / 4).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// Two floats as a bf16x2 register (lo in the low half), rounded to
// nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// -- the fold of split partials inside one launch (K2/K7, K6) -------------
// Every block of a group of `arrivals` blocks calls this once, after
// writing its partial result to global memory; it returns true, in every
// thread, in the block that arrives last, which then folds the group's
// partials (reading them with __ldcg, past its SM's L1). The fence
// before the count orders each block's partial stores before its
// arrival; the one after it orders the last block's reads after every
// arrival. The last block resets the counter to 0, so the next launch
// finds it zero.
__device__ __forceinline__ bool last_arrival(unsigned* counter,
                                             unsigned arrivals) {
  __shared__ unsigned s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned prev = atomicAdd(counter, 1u);
    s_last = prev + 1 == arrivals;
    if (s_last) atomicExch(counter, 0u);
  }
  __syncthreads();
  const bool last = s_last != 0;
  if (last) __threadfence();
  return last;
}

}  // namespace aigw

// dtype codes shared with the Python wrappers (AIGW_I8 / AIGW_I4: the
// fused decode kernel's quantized pools, int8 and packed-int4 uint8)
#define AIGW_F32 0
#define AIGW_BF16 1
#define AIGW_I8 2
#define AIGW_I4 3

// Dispatch a templated launch over (rows per warp G, query dtype, pool
// dtype): G = 4 for GQA groups up to 4, else 8.
#define AIGW_DISPATCH(GRP, QDT, KVDT, LAUNCH)                          \
  do {                                                                 \
    if ((GRP) <= 4) {                                                  \
      AIGW_DISPATCH_DT(4, QDT, KVDT, LAUNCH);                          \
    } else {                                                           \
      AIGW_DISPATCH_DT(8, QDT, KVDT, LAUNCH);                          \
    }                                                                  \
  } while (0)

#define AIGW_DISPATCH_DT(G, QDT, KVDT, LAUNCH)                         \
  do {                                                                 \
    if ((QDT) == AIGW_F32 && (KVDT) == AIGW_F32) {                     \
      LAUNCH(G, float, float);                                         \
    } else if ((QDT) == AIGW_F32 && (KVDT) == AIGW_BF16) {             \
      LAUNCH(G, float, __nv_bfloat16);                                 \
    } else if ((QDT) == AIGW_BF16 && (KVDT) == AIGW_F32) {             \
      LAUNCH(G, __nv_bfloat16, float);                                 \
    } else if ((QDT) == AIGW_BF16 && (KVDT) == AIGW_BF16) {            \
      LAUNCH(G, __nv_bfloat16, __nv_bfloat16);                         \
    } else {                                                           \
      return (int)cudaErrorInvalidValue;                               \
    }                                                                  \
  } while (0)

// Shapes every kernel of this family accepts: D a multiple of 8 with
// D / 8 lanes dividing the warp (D in 8..256), a GQA group of at most 8.
#define AIGW_SHAPES_OK(D, GRP) \
  ((D) % 8 == 0 && (D) >= 8 && (D) <= 256 && (32 % ((D) / 8)) == 0 && \
   (GRP) >= 1 && (GRP) <= 8)
