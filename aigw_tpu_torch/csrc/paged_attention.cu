// K1 ragged prefill attention, and K3 chained paged decode, K4 paged
// decode (v1) and K5 speculative verify attention on one body.
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
// What bounds them on the H100: K3-K5 read each cached K/V byte once
// per (sequence, KV head) for ~2 FLOPs per byte and query row, far below
// the card's ~295 FLOPs per byte, so their floor is HBM bytes (3.35
// TB/s). K1 does O(rows x keys) work per sequence: at prefill lengths of
// hundreds of tokens and a GQA group of 4 it does hundreds of FLOPs per
// pool byte, so its floor is the tensor cores' rate (PERF.md states both
// bounds).
//
// K1. The TPU kernel walked a grid (query block, sequence, page) and
// revisited a query block once per sequence it overlapped, carrying the
// softmax state in VMEM scratch across the sequential page axis. Here a
// block owns one tile of one sequence and one KV head, and nothing spans
// two sequences. For bf16 q over a bf16 pool (ragged_prefill_tc_kernel)
// it is FlashAttention-2's forward pass over pages:
// - a tile's PF_ROWS rows are (query, head in the GQA group) pairs, whole
//   queries of the group: floor(PF_ROWS / G) queries (16 at G 4, 9 at G
//   7), so the G heads of the group share every K/V stage;
// - the warps split the rows, not the keys: each owns one m16 row tile
//   for every key of a stage, so no merge follows the walk;
// - the sequence's K and V rows come through attn_staged.cuh's cp.async
//   ring (ring_walk) in stages of PF_CK keys, from key 0 to the tile's
//   last row's limit, 16-byte chunks XOR-swizzled by row (swz); keys past
//   the limit are zero-filled (0 source bytes), so a masked key's V is
//   never NaN. A thread's keys of a stage take one division and
//   independent page-table reads, all issued before its copies;
// - per stage S = q k^T by m16n8k16 (ldmatrix for q and K), scaled by
//   log2(e) / sqrt(D) in float32, so the online softmax, (m, l) float32
//   per row, takes one ex2 a probability; P v with P as two bf16 terms
//   (hi + lo, as K3/K5's body) and the score fragment reused as the A
//   operand (V by ldmatrix.trans). Only a step crossing some row's
//   causal limit applies a per-row mask;
// - the grid, (tiles bound) x Hkv blocks, is sized from T with no host
//   sync; each block finds its tile from cu and start_pos
//   (prefill_tile): tiles in descending order of their key count (the
//   last tile of the longest sequence first), so the triangle's light
//   tiles, not a heavy one, end the launch; blocks past the tile count
//   exit. The plan is mirrored in Python (ops/paged_attention.py,
//   prefill_tile) and tested on the CPU.
// float32 pools, mixed dtypes and D = 8 keep the first port on the CUDA
// cores (ragged_prefill_kernel): a warp per packed row walks its causal
// keys in registers (warp_walk, attn_common.cuh).
//
// K3 and K5 are one body: K5's query s of sequence b attends keys <=
// positions[b] + s, and K3 is K5 at S = 1 over lengths[b] keys; K4
// computes K3's function and launches the same body. The first K5 ran a
// block per query (grid (B, Hkv, S)), so each of the S blocks of a
// (sequence, KV head) re-walked the same pages, and every key cost each
// block a dependent chain (a page-table read, loads, shuffles, a
// rescale) for its G rows on the CUDA cores. Here one block holds all S
// x G rows of a (sequence, KV head) (more than 32 rows: further row
// groups, each re-reading the keys) and reads every key once for them:
// - the keys split over blocks as K2's do (grid (B * row groups, Hkv,
//   n_split), split_pages), staged through attn_staged.cuh's cp.async
//   ring after the split's page rows are loaded once; splits past the
//   group's keys exit at once, and the splits fold in the same launch
//   (last_arrival, fold_splits, in split order);
// - for bf16 q over a bf16 pool the products run on the tensor cores
//   (mq_tc_kernel): each warp takes 16 keys of a 64-key stage (the
//   warps split keys, not rows: 20 rows at S 5 are two m16 tiles, too
//   few to share out) and merges with the others through shared memory
//   after the walk (fold_warps); the ring's rows are XOR-swizzled by
//   16-byte chunk, since 256-byte rows would put every ldmatrix row on
//   the same banks. The scores are scaled by 1 / sqrt(D) in float32 and
//   the softmax state (m, l) of each row stays float32;
// - float32 pools, mixed dtypes and D = 8 take the same split, ring and
//   fold on the CUDA cores (mq_staged_kernel: K2's warp_step_rows with
//   each row's causal limit as its mask, groups of up to 8 rows).
// A row's causal limit matters only in the chunk that holds its
// sequence's last S keys; a row with no keys (a slot that is off,
// positions[b] <= -S, or the first queries of a window starting below
// zero) comes out zero.

#include <type_traits>

#include "attn_staged.cuh"

namespace aigw {

// Physical 16-byte chunk of logical chunk c of row r, for rows of nc
// chunks (a power of two): the 8 rows an ldmatrix reads at one logical
// chunk land on 8 distinct 16-byte bank groups.
__device__ __forceinline__ int swz(int r, int c, int nc) {
  return nc >= 8 ? c ^ (r & 7) : c ^ ((r * nc >> 3) & (nc - 1));
}

// -- K1 on the CUDA cores ----------------------------------------------------
constexpr int PREFILL_WARPS = 4;  // packed rows per K1 CUDA-core block

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

// -- K1 on the tensor cores ----------------------------------------------------
constexpr int PF_WARPS = 4;               // warps of a K1 tensor-core block
constexpr int PF_ROWS = 16 * PF_WARPS;    // (query, head) rows of a tile
constexpr int PF_CK = 64;                 // keys per ring stage

// Tiles of a sequence of len queries starting at absolute position start,
// qt queries a tile: tile j holds queries [j qt, min((j + 1) qt, len)) and
// weighs start + min((j + 1) qt, len) keys (its last query's). How many
// of them weigh at least w.
__device__ __forceinline__ int tiles_ge(int len, int start, int qt, int w) {
  if (len <= 0 || w > start + len) return 0;
  const int n = (len + qt - 1) / qt;
  const int j = w <= start ? 0 : (w - start + qt - 1) / qt - 1;
  return n - min(j, n - 1);
}

// The tile of rank t when the tiles of all sequences are ordered by
// weight, heaviest first (ties: lower b first): its sequence b and index
// j; false when there are t or fewer tiles. A binary search on the
// weight of rank t, then the k-th sequence holding a tile of that
// weight. Every lane of the warp calls it and gets the same answer; lane
// l keeps sequence l's length and start in registers (sequences past the
// warp's 32 are read again at each count).
__device__ __forceinline__ bool prefill_tile(const int* cu,
                                             const int* start_pos, int B,
                                             int qt, int t, int& b_out,
                                             int& j_out) {
  const int lane = threadIdx.x % WARP;
  const int len0 = lane < B ? cu[lane + 1] - cu[lane] : 0;
  const int st0 = lane < B ? start_pos[lane] : 0;
  // tiles of all B sequences weighing at least w (every lane gets it)
  auto count_ge = [&](int w) {
    int c = tiles_ge(len0, st0, qt, w);
    for (int b = lane + WARP; b < B; b += WARP)
      c += tiles_ge(cu[b + 1] - cu[b], start_pos[b], qt, w);
    return __reduce_add_sync(FULL, c);
  };
  int w_max = len0 > 0 ? st0 + len0 : 0;
  for (int b = lane + WARP; b < B; b += WARP) {
    const int len = cu[b + 1] - cu[b];
    if (len > 0) w_max = max(w_max, start_pos[b] + len);
  }
  w_max = __reduce_max_sync(FULL, w_max);
  if (w_max < 1 || count_ge(1) <= t) return false;
  int lo = 1, hi = w_max;  // count_ge(lo) > t
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    if (count_ge(mid) > t) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  // rank t weighs lo; count_ge(lo + 1) tiles rank before every tile of
  // that weight, and each sequence holds at most one of them
  int k = t - count_ge(lo + 1);
  for (int b0 = 0; b0 < B; b0 += WARP) {
    const int b = b0 + lane;
    int len = len0, st = st0, n_ge = 0;
    if (b0 > 0 && b < B) {
      len = cu[b + 1] - cu[b];
      st = start_pos[b];
    }
    if (b < B) n_ge = tiles_ge(len, st, qt, lo);
    const bool has = b < B && n_ge - tiles_ge(len, st, qt, lo + 1) == 1;
    unsigned m = __ballot_sync(FULL, has);
    if (k < __popc(m)) {
      for (int i = 0; i < k; ++i) m &= m - 1;  // drop the k lower hits
      const int src = __ffs(m) - 1;
      const int n = (len + qt - 1) / qt;
      b_out = b0 + src;
      j_out = __shfl_sync(FULL, n - n_ge, src);
      return true;
    }
    k -= __popc(m);
  }
  return false;
}

// 2^x, approximate (MUFU.EX2; -inf gives +0), the power of two __expf
// computes.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows of out outside the sequences' packed range [cu[0], cu[B]) come
// out zero: every block of the grid zeroes its share.
__device__ __forceinline__ void zero_outside(__nv_bfloat16* out,
                                             const int* cu, int B, int T,
                                             int row_elems) {
  const int lo = min(max(cu[0], 0), T), hi = min(max(cu[B], lo), T);
  const int64_t per_row = row_elems / 8;  // 16-byte chunks
  const int64_t n_head = (int64_t)lo * per_row;
  const int64_t n = n_head + (int64_t)(T - hi) * per_row;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t c = i < n_head ? i : i - n_head + (int64_t)hi * per_row;
    reinterpret_cast<uint4*>(out)[c] = make_uint4(0, 0, 0, 0);
  }
}

// bf16 q over a bf16 pool, D a multiple of 16: grid (tiles bound * Hkv),
// PF_WARPS warps; block i is KV head i % Hkv of the tile of rank i / Hkv
// (prefill_tile). Row r of a tile is query q0 + r / G, head h G + r % G.
// Dynamic shared memory: the q tile [PF_ROWS][D] bf16 (the output tile
// after the walk), then the ring: RING stages of PF_CK K rows and as many
// V rows, 16-byte chunks swizzled (swz). Warp w owns rows [16 w, 16 w +
// 16) and takes every key of a stage, KS keys per softmax step.
template <int D>
__global__ void __launch_bounds__(PF_WARPS * WARP, 2)
    ragged_prefill_tc_kernel(const __nv_bfloat16* __restrict__ q,  // [T, H, D]
                             const __nv_bfloat16* __restrict__ k_pool,
                             const __nv_bfloat16* __restrict__ v_pool,
                             const int* __restrict__ page_table,  // [B, P]
                             const int* __restrict__ cu,          // [B + 1]
                             const int* __restrict__ start_pos,   // [B]
                             __nv_bfloat16* __restrict__ out,     // [T, H, D]
                             int T, int B, int P, int H, int Hkv,
                             int page_size, int qt, float scale_log2) {
  constexpr int NC = D / 8, RB = D * 2, CK = PF_CK, SB = 2 * CK * RB;
  // keys of one softmax step: 64 keep 96 float32 registers of scores and
  // accumulators a lane at D 128; 16 at D 256
  constexpr int KS = D <= 128 ? 64 : 16;
  // the fetch: thread i copies 16-byte chunk i % NC of key rows i / NC +
  // KSTEP m, m < PER, of each stage (K and V)
  constexpr int NT = PF_WARPS * WARP, KSTEP = NT / NC, PER = CK / KSTEP;
  extern __shared__ __align__(16) unsigned char pf_smem[];
  unsigned char* s_q = pf_smem;  // [PF_ROWS][RB], swizzled
  unsigned char* ring = s_q + PF_ROWS * RB;
  zero_outside(out, cu, B, T, H * D);
  const int h = blockIdx.x % Hkv;
  int b, j;
  if (!prefill_tile(cu, start_pos, B, qt, blockIdx.x / Hkv, b, j)) return;
  const int grp = H / Hkv;
  const int lo = cu[b], st = start_pos[b];
  const int q0 = j * qt, nq = min(qt, cu[b + 1] - lo - q0);
  const int nrow = nq * grp;  // the tile's valid rows
  const int cap = P * page_size;
  const int n_keys = min(st + q0 + nq, cap);  // its last row's keys
  // the keys of tile row r (0 for a row past the tile)
  auto row_lim = [&](int r) {
    return r < nrow ? min(st + q0 + r / grp + 1, cap) : 0;
  };
  for (int i = threadIdx.x; i < PF_ROWS * NC; i += blockDim.x) {
    const int r = i / NC, c = i % NC;
    unsigned char* dst = s_q + r * RB + swz(r, c, NC) * 16;
    if (r < nrow) {
      cp_async16(dst, q + ((int64_t)(lo + q0 + r / grp) * H +
                           (int64_t)h * grp + r % grp) * D + c * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  // (the q copies land with the ring's first stage)

  const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;
  // this warp's least and greatest key count over its valid rows (rows
  // ascend, so do their limits); a warp with none skips the walk
  const bool busy = r0 < nrow;
  const int w_lo = row_lim(r0), w_hi = row_lim(min(r0 + 15, nrow - 1));
  const int lim[2] = {row_lim(r0 + g), row_lim(r0 + g + 8)};
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  // rows a lane addresses in ldmatrix: K (keys (lane / 16) 8 + lane % 8
  // at chunk offset (lane / 8) % 2), V and q (rows ((lane / 8) % 2) 8 +
  // lane % 8 at chunk offset lane / 16)
  const int kr = (lane / 16) * 8 + lane % 8, kc = (lane / 8) % 2;
  const int vr = ((lane / 8) % 2) * 8 + lane % 8, qc = lane / 16;
  const int qrow = r0 + vr;
  const int* row_pt = page_table + (int64_t)b * P;
  const int f_row = threadIdx.x / NC, f_ch = threadIdx.x % NC;

  // one softmax step over keys [kb, kb + KS) of the stage at ks / vs
  // (rows kb0 .. kb0 + KS of the stage); MASK: some row's limit falls
  // inside the step. Scores and the running max m are in log2 units
  // (scaled by log2(e) / sqrt(D)), so each probability is one ex2
  auto step = [&](auto mask_c, const unsigned char* ks,
                  const unsigned char* vs, int kb0, int kb) {
    constexpr bool MASK = decltype(mask_c)::value;
    float sc[KS / 8][4];
#pragma unroll
    for (int n = 0; n < KS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qf[4];
      ldsm_x4(qf, s_q + qrow * RB + swz(qrow, 2 * kk + qc, NC) * 16);
#pragma unroll
      for (int nk = 0; nk < KS / 16; ++nk) {
        uint32_t kf[4];  // B of keys 16 nk + 0-7 (kf[0..1]), + 8-15
        const int rr = kb0 + 16 * nk + kr;
        ldsm_x4(kf, ks + rr * RB + swz(rr, 2 * kk + kc, NC) * 16);
        mma_bf16(sc[2 * nk], qf, kf[0], kf[1]);
        mma_bf16(sc[2 * nk + 1], qf, kf[2], kf[3]);
      }
    }
    uint32_t ph[KS / 16][4], pl[KS / 16][4];  // P as A fragments
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      // this lane's keys of row g + 8 hh: kb + 8 n + 2 t + e; a masked
      // score is -inf, whose ex2 is 0 against the finite running max
      float mx = NEG;
#pragma unroll
      for (int n = 0; n < KS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = sc[n][2 * hh + e] * scale_log2;
          if (MASK && kb + 8 * n + 2 * t + e >= lim[hh]) v = -INFINITY;
          sc[n][2 * hh + e] = v;
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      const float alpha = ex2(m[hh] - m_new);
      m[hh] = m_new;
      float ls = 0.f;
#pragma unroll
      for (int n = 0; n < KS / 8; ++n) {
        const float p0 = ex2(sc[n][2 * hh] - m_new);
        const float p1 = ex2(sc[n][2 * hh + 1] - m_new);
        // P = hi + lo, two bf16 pairs; l sums the P that PV multiplies
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo2 = __floats2bfloat162_rn(p0 - hf.x,
                                                         p1 - hf.y);
        const float2 lf = __bfloat1622float2(lo2);
        ls += (hf.x + lf.x) + (hf.y + lf.y);
        // key tile n is half n % 2 of the 16-key group n / 2
        ph[n / 2][2 * (n % 2) + hh] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[n / 2][2 * (n % 2) + hh] = *reinterpret_cast<const uint32_t*>(&lo2);
      }
      l[hh] = l[hh] * alpha + ls;  // this lane's keys only
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[dt][2 * hh] *= alpha;
        acc[dt][2 * hh + 1] *= alpha;
      }
    }
#pragma unroll
    for (int kg = 0; kg < KS / 16; ++kg) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];  // B of columns 16 dp + [0, 8), + [8, 16)
        const int rr = kb0 + 16 * kg + vr;
        ldsm_x4_t(vf, vs + rr * RB + swz(rr, 2 * dp + qc, NC) * 16);
        mma_bf16(acc[2 * dp], ph[kg], vf[0], vf[1]);
        mma_bf16(acc[2 * dp], pl[kg], vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], ph[kg], vf[2], vf[3]);
        mma_bf16(acc[2 * dp + 1], pl[kg], vf[2], vf[3]);
      }
    }
  };

  ring_walk<RING>(
      (n_keys + CK - 1) / CK,
      [&](int c, int slot) {
        unsigned char* stage = ring + slot * SB;
        // this thread's PER keys: page and offset from one division,
        // then PER independent page-table reads before any copy
        const int key0 = c * CK + f_row;
        int pg = key0 / page_size, off = key0 - pg * page_size;
        int64_t row[PER];
#pragma unroll
        for (int m = 0; m < PER; ++m) {
          if (m > 0) {
            off += KSTEP;
            while (off >= page_size) {
              off -= page_size;
              ++pg;
            }
          }
          row[m] = key0 + KSTEP * m < n_keys
                       ? (int64_t)__ldg(row_pt + pg) * page_size + off
                       : -1;
        }
#pragma unroll
        for (int m = 0; m < PER; ++m) {
          const int jj = f_row + KSTEP * m;
          unsigned char* dk = stage + jj * RB + swz(jj, f_ch, NC) * 16;
          unsigned char* dv = dk + CK * RB;
          if (row[m] >= 0) {
            const int64_t e = (row[m] * Hkv + h) * D + f_ch * 8;
            cp_async16(dk, k_pool + e);
            cp_async16(dv, v_pool + e);
          } else {  // zeros: a masked key's v must not be NaN
            cp_async16(dk, k_pool, 0);
            cp_async16(dv, k_pool, 0);
          }
        }
      },
      [&](int c, int slot) {
        if (!busy) return;
        const unsigned char* ks = ring + slot * SB;
#pragma unroll
        for (int s = 0; s < CK / KS; ++s) {
          const int kb = c * CK + s * KS;
          if (kb >= w_hi) break;  // none of the warp's rows sees these
          if (kb + KS <= w_lo) {
            step(std::false_type{}, ks, ks + CK * RB, s * KS, kb);
          } else {
            step(std::true_type{}, ks, ks + CK * RB, s * KS, kb);
          }
        }
      });
  if (!busy) return;
  // the warp's rows, normalized, into its own rows of the q tile, then
  // out with 16-byte stores
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float ls = l[hh];
    ls += __shfl_xor_sync(FULL, ls, 1);
    ls += __shfl_xor_sync(FULL, ls, 2);
    ls = fmaxf(ls, 1e-30f);
    const int r = r0 + g + 8 * hh;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(s_q + r * RB + swz(r, dt, NC) * 16 +
                                   4 * t) =
          pack_bf16(acc[dt][2 * hh] / ls, acc[dt][2 * hh + 1] / ls);
  }
  __syncwarp();
  for (int i = lane; i < 16 * NC; i += WARP) {
    const int r = r0 + i / NC, c = i % NC;
    if (r >= nrow) break;
    *reinterpret_cast<uint4*>(
        out + ((int64_t)(lo + q0 + r / grp) * H + (int64_t)h * grp +
               r % grp) * D + c * 8) =
        *reinterpret_cast<const uint4*>(s_q + r * RB + swz(r, c, NC) * 16);
  }
}

// -- K3 and K5: the multi-query staged split body ---------------------------
// Row r of the (b, h) pair is query s = r / grp, head h * grp + r % grp
// of q [B, S, H, D]; it attends keys [0, clamp(xs[b] + s + off, 0, P *
// page)): K5 passes positions and off 1, K3 lengths, S 1 and off 0.
// Row groups of `rows` rows (the last may be short) run in separate
// blocks, each over the keys of its own last row.

constexpr int MQ_TC_WARPS = 4;   // warps of a tensor-core block
constexpr int MQ_TC_KEYS = 16;   // keys of one warp per ring stage
constexpr int MQ_TC_CK = MQ_TC_WARPS * MQ_TC_KEYS;  // keys per ring stage

// Which (sequence, row group, KV head, split) a block is, its rows' key
// limits, and where its results go. `live` is false for a split past
// the group's keys (the block exits at once).
template <typename TQ>
struct MqBlock {
  int b, rg, h, sp, n_split, n_rg, S, H, Hkv, grp, D, R, r0, nr;
  int x, off, cap, n_used, k_lo, n_mine;
  bool live;
  TQ* out;
  float* part;
  unsigned* counters;
  int64_t part_rows;  // rows of the partial arrays

  __device__ MqBlock(int rows, const int* xs, TQ* out_, float* part_,
                     unsigned* counters_, int S_, int P, int H_, int Hkv_,
                     int D_, int page_size, int pps, int n_rg_, int off_)
      : S(S_), H(H_), Hkv(Hkv_), D(D_), off(off_), out(out_), part(part_),
        counters(counters_) {
    n_rg = n_rg_;
    b = blockIdx.x / n_rg;
    rg = blockIdx.x % n_rg;
    h = blockIdx.y;
    sp = blockIdx.z;
    n_split = gridDim.z;
    grp = H / Hkv;
    R = S * grp;
    r0 = rg * rows;
    nr = min(rows, R - r0);
    x = xs[b];
    cap = P * page_size;
    const int span = pps * page_size;
    const int n_keys = row_keys(nr - 1);  // the group's most
    n_used = max(1, (n_keys + span - 1) / span);
    live = sp < n_used;
    k_lo = sp * span;
    n_mine = max(0, min(n_keys - k_lo, span));
    part_rows = (int64_t)(gridDim.x / n_rg) * Hkv * n_split * R;
  }
  // keys of group row r
  __device__ __forceinline__ int row_keys(int r) const {
    const int64_t k = (int64_t)x + (r0 + r) / grp + off;
    return (int)max((int64_t)0, min(k, (int64_t)cap));
  }
  // this split's keys [0, row_lim(r)) of group row r (none past nr)
  __device__ __forceinline__ int row_lim(int r) const {
    return r < nr ? min(row_keys(r) - k_lo, n_mine) : 0;
  }
  // element 0 of group row r in q and out
  __device__ __forceinline__ int64_t row_off(int r) const {
    const int s = (r0 + r) / grp, g = (r0 + r) % grp;
    return (((int64_t)b * S + s) * H + (int64_t)h * grp + g) * D;
  }
  // (m, l, a) of group row r, element d: the output when the group's
  // keys fit one split, else this split's partial
  __device__ __forceinline__ void emit(int r, int d, float m, float l,
                                       float a) const {
    if (n_used == 1) {
      out[row_off(r) + d] = from_f<TQ>(a / fmaxf(l, 1e-30f));
      return;
    }
    const int64_t row = (((int64_t)b * Hkv + h) * n_split + sp) * R + r0 + r;
    part[row * D + d] = a;
    if (d == 0) {
      part[part_rows * D + row] = m;
      part[part_rows * (D + 1) + row] = l;
    }
  }
  // The last split of the group to arrive folds the partials. Every
  // thread of the block must call it.
  __device__ __forceinline__ void finish() const {
    if (n_used == 1 ||
        !last_arrival(counters + ((int64_t)b * Hkv + h) * n_rg + rg, n_used))
      return;
    fold_splits(part, part + part_rows * D, part + part_rows * (D + 1),
                ((int64_t)b * Hkv + h) * n_split, n_used, R, r0, nr, D,
                [&](int r, int d, float o) {
                  out[row_off(r) + d] = from_f<TQ>(o);
                });
  }
};

// The split's page rows into shared memory (visible after the caller's
// next __syncthreads).
__device__ __forceinline__ void load_pages(int* s_pages, const int* row_pt,
                                           int sp, int pps, int P) {
  for (int i = threadIdx.x; i < pps; i += blockDim.x)
    s_pages[i] = row_pt[min(sp * pps + i, P - 1)];
}

// bf16 q over a bf16 pool, D a multiple of 16: the tensor-core body.
// grid (B * n_rg, Hkv, n_split), MQ_TC_WARPS warps; group rows 16 * MT.
// Dynamic shared memory: the split's page rows, the q tile [16 MT][D]
// bf16, then the ring: RING stages of MQ_TC_CK K rows and as many V
// rows, 16-byte chunks swizzled (swz); the warps' merge reuses the ring.
// In each stage warp w takes keys [16 w, 16 w + 16): S = q k^T by
// m16n8k16 (rows on M, keys on N, the head dim on K), the online softmax
// on the float32 fragment, then P v with P split into two bf16 terms
// (hi + lo: P rounded to bf16 alone would cost a short window's nearly
// cancelling outputs their tolerance), the fragment reused as the A
// operand (FlashAttention-2's register layout) and V read by
// ldmatrix.trans.
template <int MT, int D>
__global__ void __launch_bounds__(MQ_TC_WARPS * WARP, 2)
    mq_tc_kernel(const __nv_bfloat16* __restrict__ q,  // [B, S, H, D]
                 const __nv_bfloat16* __restrict__ k_pool,  // [slots, Hkv, D]
                 const __nv_bfloat16* __restrict__ v_pool,
                 const int* __restrict__ page_table,  // [B, P]
                 const int* __restrict__ xs,          // [B]
                 __nv_bfloat16* __restrict__ out,     // [B, S, H, D]
                 float* part, unsigned* counters, int S, int P, int H,
                 int Hkv, int page_size, int pps, int n_rg, int off,
                 float scale) {
  constexpr int ROWS = 16 * MT, NC = D / 8, RB = D * 2;
  constexpr int CK = MQ_TC_CK, SB = 2 * CK * RB;
  extern __shared__ __align__(16) unsigned char mq_smem[];
  const MqBlock<__nv_bfloat16> blk(ROWS, xs, out, part, counters, S, P, H,
                                   Hkv, D, page_size, pps, n_rg, off);
  if (!blk.live) return;
  int* s_pages = reinterpret_cast<int*>(mq_smem);
  unsigned char* s_q = mq_smem + pages_bytes(pps);  // [ROWS][RB], swizzled
  unsigned char* ring = s_q + ROWS * RB;
  load_pages(s_pages, page_table + (int64_t)blk.b * P, blk.sp, pps, P);
  for (int i = threadIdx.x; i < ROWS * NC; i += blockDim.x) {
    const int r = i / NC, c = i % NC;
    unsigned char* dst = s_q + r * RB + swz(r, c, NC) * 16;
    if (r < blk.nr) {
      cp_async16(dst, q + blk.row_off(r) + c * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();  // the page rows (the q copies land with chunk 0)

  const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
  const int g = lane / 4, t = lane % 4;
  int lim[MT][2];  // keys of this lane's rows g, g + 8 of each tile
  float m[MT][2], l[MT][2], acc[MT][D / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      lim[mt][hh] = blk.row_lim(mt * 16 + g + 8 * hh);
      m[mt][hh] = NEG;
      l[mt][hh] = 0.f;
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][dt][e] = 0.f;
  }
  const int Hkv_ = Hkv, h = blk.h, n_mine = blk.n_mine;
  // rows a lane addresses in ldmatrix: K (keys (lane / 16) 8 + lane % 8
  // at chunk offset (lane / 8) % 2), V and q (rows ((lane / 8) % 2) 8 +
  // lane % 8 at chunk offset lane / 16)
  const int kr = warp * MQ_TC_KEYS + (lane / 16) * 8 + lane % 8;
  const int kc = (lane / 8) % 2;
  const int vr = warp * MQ_TC_KEYS + ((lane / 8) % 2) * 8 + lane % 8;
  const int qr = ((lane / 8) % 2) * 8 + lane % 8, qc = lane / 16;

  ring_walk<RING>(
      (n_mine + CK - 1) / CK,
      [&](int c, int slot) {
        unsigned char* stage = ring + slot * SB;
        for (int i = threadIdx.x; i < 2 * CK * NC; i += blockDim.x) {
          const int kv = i / (CK * NC), j = (i / NC) % CK, ch = i % NC;
          const int key = c * CK + j;
          unsigned char* dst =
              stage + (kv * CK + j) * RB + swz(j, ch, NC) * 16;
          if (key < n_mine) {
            const int64_t row = ((int64_t)s_pages[key / page_size] *
                                     page_size + key % page_size) * Hkv_ + h;
            cp_async16(dst, (kv ? v_pool : k_pool) + row * D + ch * 8);
          } else {  // zeros: a masked key's v must not be NaN
            cp_async16(dst, k_pool, 0);
          }
        }
      },
      [&](int c, int slot) {
        const int kb = c * CK + warp * MQ_TC_KEYS;  // this warp's keys
        if (kb >= n_mine) return;
        const unsigned char* ks = ring + slot * SB;
        const unsigned char* vs = ks + CK * RB;
        float sc[MT][2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[mt][n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t kf[4];  // B of key tiles 0-7 (kf[0..1]), 8-15 (kf[2..3])
          ldsm_x4(kf, ks + kr * RB + swz(kr, 2 * kk + kc, NC) * 16);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t qf[4];
            const int r = mt * 16 + qr;
            ldsm_x4(qf, s_q + r * RB + swz(r, 2 * kk + qc, NC) * 16);
            mma_bf16(sc[mt][0], qf, kf[0], kf[1]);
            mma_bf16(sc[mt][1], qf, kf[2], kf[3]);
          }
        }
        uint32_t ph[MT][4], pl[MT][4];  // P as A fragments, hi and lo
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            // this lane's 4 keys of row g + 8 hh: kb + 8 n + 2 t + e
            float v[2][2];
            bool ok[2][2];
            float mx = NEG;
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                v[n][e] = sc[mt][n][2 * hh + e] * scale;
                ok[n][e] = kb + 8 * n + 2 * t + e < lim[mt][hh];
                if (ok[n][e]) mx = fmaxf(mx, v[n][e]);
              }
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
            const float m_new = fmaxf(m[mt][hh], mx);
            const float alpha = __expf(m[mt][hh] - m_new);
            m[mt][hh] = m_new;
            float ls = 0.f;
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              float p[2], hi[2], lo[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                p[e] = ok[n][e] ? __expf(v[n][e] - m_new) : 0.f;
                hi[e] = __bfloat162float(__float2bfloat16_rn(p[e]));
                lo[e] = __bfloat162float(__float2bfloat16_rn(p[e] - hi[e]));
                ls += hi[e] + lo[e];  // l sums the P that PV multiplies
              }
              ph[mt][2 * n + hh] = pack_bf16(hi[0], hi[1]);
              pl[mt][2 * n + hh] = pack_bf16(lo[0], lo[1]);
            }
            l[mt][hh] = l[mt][hh] * alpha + ls;  // this lane's keys only
#pragma unroll
            for (int dt = 0; dt < D / 8; ++dt) {
              acc[mt][dt][2 * hh] *= alpha;
              acc[mt][dt][2 * hh + 1] *= alpha;
            }
          }
        }
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t vf[4];  // B of columns 16 dp + [0, 8), + [8, 16)
          ldsm_x4_t(vf, vs + vr * RB + swz(vr, 2 * dp + qc, NC) * 16);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][2 * dp], ph[mt], vf[0], vf[1]);
            mma_bf16(acc[mt][2 * dp], pl[mt], vf[0], vf[1]);
            mma_bf16(acc[mt][2 * dp + 1], ph[mt], vf[2], vf[3]);
            mma_bf16(acc[mt][2 * dp + 1], pl[mt], vf[2], vf[3]);
          }
        }
      });
  // the warps' states into the ring (fold_warps' layout), then the fold
  float* s_acc = reinterpret_cast<float*>(ring);  // [warps][ROWS][D]
  float* s_m = s_acc + MQ_TC_WARPS * ROWS * D;     // [warps][ROWS]
  float* s_l = s_m + MQ_TC_WARPS * ROWS;           // [warps][ROWS]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = mt * 16 + g + 8 * hh;
      float ls = l[mt][hh];
      ls += __shfl_xor_sync(FULL, ls, 1);
      ls += __shfl_xor_sync(FULL, ls, 2);
      float* a = s_acc + (warp * ROWS + r) * D + 2 * t;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<float2*>(a + dt * 8) =
            make_float2(acc[mt][dt][2 * hh], acc[mt][dt][2 * hh + 1]);
      if (t == 0) {
        s_m[warp * ROWS + r] = m[mt][hh];
        s_l[warp * ROWS + r] = ls;
      }
    }
  }
  __syncthreads();
  fold_warps(MQ_TC_WARPS, ROWS, blk.nr, D, s_acc,
             [&](int r, int d, float mm, float ll, float a) {
               blk.emit(r, d, mm, ll, a);
             });
  blk.finish();
}

// float32 pools, mixed dtypes and D = 8: the same split, ring and fold
// on the CUDA cores (staged_attend, K2's walk, with each row's causal
// limit as its mask). grid (B * n_rg, Hkv, n_split), FUSED_WARPS warps;
// group rows NR.
template <int NR, typename TQ, typename TKV>
__global__ void __launch_bounds__(FUSED_WARPS * WARP)
    mq_staged_kernel(const TQ* __restrict__ q,  // [B, S, H, D]
                     const TKV* k_pool,         // [slots, Hkv, D]
                     const TKV* v_pool,
                     const int* __restrict__ page_table,  // [B, P]
                     const int* __restrict__ xs,          // [B]
                     TQ* __restrict__ out,                // [B, S, H, D]
                     float* part, unsigned* counters, int S, int P, int H,
                     int Hkv, int D, int page_size, int pps, int n_rg,
                     int off, float sqrt_d) {
  extern __shared__ __align__(16) unsigned char mq_smem[];
  const MqBlock<TQ> blk(NR, xs, out, part, counters, S, P, H, Hkv, D,
                        page_size, pps, n_rg, off);
  if (!blk.live) return;
  int* s_pages = reinterpret_cast<int*>(mq_smem);
  load_pages(s_pages, page_table + (int64_t)blk.b * P, blk.sp, pps, P);
  const int e0 = (threadIdx.x % WARP % (D / VEC)) * VEC;
  float qr[NR][VEC];
  int lim[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    float x[VEC] = {};
    if (r < blk.nr) load8(q + blk.row_off(r) + e0, x);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[r][e] = __fdiv_rn(x[e], sqrt_d);
    lim[r] = blk.row_lim(r);
  }
  __syncthreads();  // the page rows
  const StagedPool<TKV, 0> pool{
      reinterpret_cast<const unsigned char*>(k_pool),
      reinterpret_cast<const unsigned char*>(v_pool), nullptr, nullptr, Hkv,
      blk.h, D};
  staged_attend<NR>(
      qr, blk.nr, pool, s_pages, page_size, D, blk.n_mine,
      mq_smem + pages_bytes(pps),
      [&](int r, int d, float m, float l, float a) {
        blk.emit(r, d, m, l, a);
      },
      [&](int r, int key) { return key < lim[r]; });
  blk.finish();
}

}  // namespace aigw

using namespace aigw;

extern "C" {

// The largest dynamic shared memory allowed so far, per kernel: one
// runtime call per new size, none on the launch path (and none inside a
// CUDA graph capture).
#define SET_SMEM(KERN, SMEM)                                                \
  {                                                                         \
    static int smem_set = 0;                                                \
    if ((SMEM) > smem_set) {                                                \
      const cudaError_t e = cudaFuncSetAttribute(                           \
          KERN, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);         \
      if (e != cudaSuccess) return (int)e;                                  \
      smem_set = (SMEM);                                                    \
    }                                                                       \
  }

// K1: q [T, H, D] packed; rows [cu[b], cu[b + 1]) of sequence b attend
// keys [0, start_pos[b] + row + 1). bf16 q over a bf16 pool with D a
// multiple of 16 runs on the tensor cores and writes every row of out
// (rows outside [cu[0], cu[B]) zero); otherwise the CUDA-core kernel
// writes the sequences' rows only, over an out the caller zero-filled.
// Returns cudaGetLastError() after the launch (0 = launched).
int aigw_ragged_prefill(const void* q, const void* k_pool,
                        const void* v_pool, const int* page_table,
                        const int* cu, const int* start_pos, void* out,
                        int T, int B, int P, int H, int Hkv, int D,
                        int page_size, int q_dtype, int kv_dtype,
                        void* stream) {
  const int grp = H / Hkv;
  if (!AIGW_SHAPES_OK(D, grp) || T < 1 || B < 1 || P < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == AIGW_BF16 && kv_dtype == AIGW_BF16 && D % 16 == 0) {
    // tiles of qt whole queries; at most (T + B (qt - 1)) / qt of them
    const int qt = PF_ROWS / grp;
    const int64_t blocks = ((int64_t)T + (int64_t)B * (qt - 1)) / qt * Hkv;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
#define LAUNCH_TC(DD)                                                       \
  {                                                                         \
    const int smem = PF_ROWS * DD * 2 + RING * 2 * PF_CK * DD * 2;          \
    auto kern = ragged_prefill_tc_kernel<DD>;                               \
    SET_SMEM(kern, smem);                                                   \
    kern<<<(unsigned)blocks, PF_WARPS * WARP, smem, st>>>(                  \
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool,              \
        (const __nv_bfloat16*)v_pool, page_table, cu, start_pos,            \
        (__nv_bfloat16*)out, T, B, P, H, Hkv, page_size, qt,                \
        1.4426950408889634f / sqrtf((float)DD));                            \
  }
    switch (D) {
      case 16: LAUNCH_TC(16); break;
      case 32: LAUNCH_TC(32); break;
      case 64: LAUNCH_TC(64); break;
      case 128: LAUNCH_TC(128); break;
      case 256: LAUNCH_TC(256); break;
      default: return (int)cudaErrorInvalidValue;
    }
#undef LAUNCH_TC
    return (int)cudaGetLastError();
  }
  const dim3 grid((T + PREFILL_WARPS - 1) / PREFILL_WARPS, B, Hkv);
  const float sqrt_d = sqrtf((float)D);
#define LAUNCH(G, TQ, TKV)                                                  \
  ragged_prefill_kernel<G, TQ, TKV>                                         \
      <<<grid, PREFILL_WARPS * WARP, 0, st>>>(                              \
          (const TQ*)q, (const TKV*)k_pool, (const TKV*)v_pool, page_table, \
          cu, start_pos, (TQ*)out, P, H, Hkv, D, page_size, sqrt_d)
  AIGW_DISPATCH(grp, q_dtype, kv_dtype, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}

// Group rows of the K3/K5 body for S * grp rows (the Python plan's
// group_rows): the tensor-core body takes 16 or 32 (two m16 tiles,
// D <= 128), the CUDA-core body 4 or 8.
static int mq_rows(bool tc, int R, int D) {
  if (tc) return R > 16 && D <= 128 ? 32 : 16;
  return R <= 4 ? 4 : 8;
}

// The K3/K5 launch: grid (B * n_rg, Hkv, n_split) over q [B, S, H, D];
// row r of a (b, h) attends keys [0, clamp(xs[b] + r / grp + off, 0, P *
// page_size)). With n_split > 1, part is float32 scratch of n_split * B
// * S * H * (D + 2) elements and counters B * Hkv * n_rg zeroed uint32,
// which the kernel leaves zero.
static int paged_mq(const void* q, const void* k_pool, const void* v_pool,
                    const int* page_table, const int* xs, void* out,
                    void* part, void* counters, int B, int S, int P, int H,
                    int Hkv, int D, int page_size, int pps, int n_split,
                    int rows, int off, int q_dtype, int kv_dtype,
                    void* stream) {
  const int grp = H / Hkv;
  if (!AIGW_SHAPES_OK(D, grp) || B < 1 || S < 1 || S > 65535 || P < 1 ||
      pps < 1 || n_split < 1 || n_split > 65535 || Hkv > 65535 ||
      (int64_t)(n_split - 1) * pps >= P || (int64_t)n_split * pps < P ||
      (n_split > 1 && (part == nullptr || counters == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const bool tc = q_dtype == AIGW_BF16 && kv_dtype == AIGW_BF16 &&
                  D % 16 == 0;
  const int R = S * grp;
  if (rows != mq_rows(tc, R, D)) return (int)cudaErrorInvalidValue;
  const int n_rg = (R + rows - 1) / rows;
  if ((int64_t)B * n_rg > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * n_rg, Hkv, n_split);
  const cudaStream_t st = (cudaStream_t)stream;
  if (tc) {
#define LAUNCH_TC(MT, DD)                                                   \
  {                                                                         \
    const int ring = RING * 2 * MQ_TC_CK * DD * 2;                          \
    const int merge = MQ_TC_WARPS * 16 * MT * (DD + 2) * (int)sizeof(float);\
    const int smem = pages_bytes(pps) + 16 * MT * DD * 2 +                  \
                     (ring > merge ? ring : merge);                         \
    auto kern = mq_tc_kernel<MT, DD>;                                       \
    SET_SMEM(kern, smem);                                                   \
    kern<<<grid, MQ_TC_WARPS * WARP, smem, st>>>(                           \
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool,              \
        (const __nv_bfloat16*)v_pool, page_table, xs, (__nv_bfloat16*)out,  \
        (float*)part, (unsigned*)counters, S, P, H, Hkv, page_size, pps,    \
        n_rg, off, 1.f / sqrtf((float)DD));                                 \
  }
#define LAUNCH_TC_D(MT)                                                     \
  switch (D) {                                                              \
    case 16: LAUNCH_TC(MT, 16); break;                                      \
    case 32: LAUNCH_TC(MT, 32); break;                                      \
    case 64: LAUNCH_TC(MT, 64); break;                                      \
    case 128: LAUNCH_TC(MT, 128); break;                                    \
    default: return (int)cudaErrorInvalidValue;                             \
  }
    if (rows == 32) {
      LAUNCH_TC_D(2);
    } else if (D == 256) {
      LAUNCH_TC(1, 256);
    } else {
      LAUNCH_TC_D(1);
    }
#undef LAUNCH_TC_D
#undef LAUNCH_TC
  } else {
    const float sqrt_d = sqrtf((float)D);
#define LAUNCH(NR, TQ, TKV)                                                 \
  {                                                                         \
    const int ring = RING * stage_bytes<TKV, 0>(D);                         \
    const int merge = FUSED_WARPS * NR * (D + 2) * (int)sizeof(float);      \
    const int smem = pages_bytes(pps) + (ring > merge ? ring : merge);      \
    auto kern = mq_staged_kernel<NR, TQ, TKV>;                              \
    SET_SMEM(kern, smem);                                                   \
    kern<<<grid, FUSED_WARPS * WARP, smem, st>>>(                           \
        (const TQ*)q, (const TKV*)k_pool, (const TKV*)v_pool, page_table,   \
        xs, (TQ*)out, (float*)part, (unsigned*)counters, S, P, H, Hkv, D,   \
        page_size, pps, n_rg, off, sqrt_d);                                 \
  }
    if (rows == 4) {
      AIGW_DISPATCH_DT(4, q_dtype, kv_dtype, LAUNCH);
    } else {
      AIGW_DISPATCH_DT(8, q_dtype, kv_dtype, LAUNCH);
    }
#undef LAUNCH
  }
  return (int)cudaGetLastError();
}

// K3 and K4: q [B, H, D], row b attends its first lengths[b] keys
// (capped at the table).
int aigw_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                      const int* page_table, const int* lengths, void* out,
                      void* part, void* counters, int B, int P, int H,
                      int Hkv, int D, int page_size, int pps, int n_split,
                      int rows, int q_dtype, int kv_dtype, void* stream) {
  return paged_mq(q, k_pool, v_pool, page_table, lengths, out, part,
                  counters, B, 1, P, H, Hkv, D, page_size, pps, n_split,
                  rows, 0, q_dtype, kv_dtype, stream);
}

// K5: q [B, S, H, D], query s of sequence b attends keys <= positions[b]
// + s (capped at the table; none for a slot at positions[b] <= -S).
int aigw_paged_verify(const void* q, const void* k_pool, const void* v_pool,
                      const int* page_table, const int* positions, void* out,
                      void* part, void* counters, int B, int S, int P, int H,
                      int Hkv, int D, int page_size, int pps, int n_split,
                      int rows, int q_dtype, int kv_dtype, void* stream) {
  return paged_mq(q, k_pool, v_pool, page_table, positions, out, part,
                  counters, B, S, P, H, Hkv, D, page_size, pps, n_split,
                  rows, 1, q_dtype, kv_dtype, stream);
}

}  // extern "C"
