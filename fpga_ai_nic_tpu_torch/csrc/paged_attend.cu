// Paged gather-attend for Hopper: decode and chunked-prefill attention that
// walks an int32 page table over a shared K/V page pool.
//
// Replaces the Pallas TPU kernel of the JAX package, ops/paged_attend_pallas.py
// _paged_kernel (wrapper paged_gather_attend).  Contract, the same as there:
// the cell for slot r and KV head kh attends the query group
// q.reshape(R, n_kv, G*T, hd) (G = H / n_kv, so row g*T + t is head
// kh*G + g at token t); row g*T + t sees key j iff j <= pos[r] + t; scores
// are scaled by sm_scale and go through an exact masked softmax in f32; the
// output is the PV contraction in f32.  Only the pages
// i < n_live = min((pos + T - 1) / page_size + 1, P) are live, and a dead
// page's bytes are never read.  A table entry outside the pool is clamped,
// as XLA's gather clamps it.
//
// The TPU kernel has one contract and two regimes; the card wants two
// designs behind the one C entry, picked by the wrapper:
//
// Prefill (T > 1): operations bound (G*T rows share each key).  The flash
// forward's mainloop (attn_fwd.cuh: two consumer warpgroups of 64 rows,
// a producer warp, a 4-stage cp.async ring under mbarriers, wgmma products,
// turn-taking on the tensor cores) with a paged loader: a block takes 128
// consecutive rows of one (slot, KV head)'s G*T, in the JAX row order, so
// a 64-row tile is one head and 64 consecutive tokens where T is a
// multiple of 64.  The producer fills each 64-key tile row by row through
// the page table (a pool row [page, kh, off] is 256 contiguous bytes: 16
// cp.async copies of 16 bytes) into the same swizzled layout as the flash
// tiles; keys past the block's last visible key are zero-filled without a
// read, so dead pages and causally hidden keys move no bytes.  q is f32 in
// the contract: each warpgroup converts its rows to bf16 terms in shared
// memory, hi = bf16(q) and lo = bf16(q - hi) (the wrapper passes one term
// where q came in as bf16: lo is then exactly zero), and p enters p . v as
// hi + lo as in the flash forward.  The output stays f32.
//
// Decode (T = 1): bytes bound (each live K/V byte serves only G query
// rows).  The live keys of each (slot, KV head) are cut into chunks of
// whole pages (chunk_pages of them, 256 keys), one block each, so a
// 16-slot batch at 8 KV heads runs up to 1024 blocks.  A
// block of four warps streams its chunk through a 4-stage cp.async ring
// of 32-key tiles, eight keys a warp; the math stays f32 on the CUDA cores
// (four rows cannot fill a wgmma), with few instructions a key, since the
// CUDA cores must keep up with the bytes: eight lanes share a key (16 dims
// each, three xor-shuffles finish a dot), each lane owns 4 dims of the
// output, multiply-adds are fused, and each warp keeps an online softmax
// per row in log2 units (ex2, as the flash kernels).  The warps merge in a fixed order into the block's
// partial (m, l, o), written to scratch; the last block of the (slot, head)
// to arrive (a counter per (slot, head), which that block resets to 0)
// combines the partials in chunk order.  No sum depends on arrival order,
// so two launches give the same bits.
#include "attn_fwd.cuh"

namespace {

// -- prefill: the flash mainloop over pages ------------------------------------

using PagedSmem = FwdSmem<2>;

// The pool row ([page, kh, off] as one index of 256-byte rows) of key j of
// slot table row trow, or -1 for a key at or past key_end.  An entry outside
// the pool is clamped.
__device__ __forceinline__ int pool_row(const int* trow, int j, int key_end,
                                        int ps, int n_kv, int kh,
                                        int n_pages) {
  if (j >= key_end) return -1;
  const int page = min(max(trow[j / ps], 0), n_pages - 1);
  return (page * n_kv + kh) * ps + j % ps;
}

__global__ void __launch_bounds__(FWD_THREADS, 1)
paged_prefill_kernel(const float* __restrict__ q, const bf16* __restrict__ pk,
                     const bf16* __restrict__ pv,
                     const int* __restrict__ table,
                     const int* __restrict__ pos, float* __restrict__ out,
                     int H, int n_kv, int n_t, int n_tab, int ps, int n_pages,
                     int nq, float sm_scale) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t ring = base + PagedSmem::RING;
  const uint32_t bars = base + PagedSmem::BARS;
  const int tid = threadIdx.x;
  const int kh = blockIdx.y, r = blockIdx.z, G = H / n_kv, gt = G * n_t;
  const int pos_r = max(pos[r], 0);
  const int n_live = min((pos_r + n_t - 1) / ps + 1, n_tab);
  const int live_end = n_live * ps;
  int nkw[2], nv[2], key_end = 0;
#pragma unroll
  for (int w = 0; w < 2; ++w) {  // rows rw0 .. rw0 + nv - 1 of the cell
    const int rw0 = 128 * blockIdx.x + 64 * w;
    nv[w] = min(max(gt - rw0, 0), T);
    int end = 0;
    if (nv[w] > 0) {
      const int t0 = rw0 % n_t;
      const int t_max = t0 + nv[w] - 1 >= n_t ? n_t - 1 : t0 + nv[w] - 1;
      end = min(pos_r + t_max + 1, live_end);
    }
    nkw[w] = (end + T - 1) / T;
    key_end = max(key_end, end);
  }
  const int nk = max(nkw[0], nkw[1]);
  if (tid == 0) fwd_init_barriers(bars);
  __syncthreads();

  if (tid >= 2 * NT) {  // the producer warp: K/V tiles through the table
    const int* trow = table + (size_t)r * n_tab;
    fwd_producer(ring, bars, nk, tid - 2 * NT,
                 [&](uint32_t dk, uint32_t dv, int it, int lane) {
                   // pool rows of keys it*64 + lane and + 32, looked up
                   // before any copy is issued; -1: past the last key
                   const int r0 = pool_row(trow, it * T + lane, key_end, ps,
                                           n_kv, kh, n_pages);
                   const int r1 = pool_row(trow, it * T + 32 + lane, key_end,
                                           ps, n_kv, kh, n_pages);
#pragma unroll
                   for (int i = 0; i < T * HD / 8 / 32; ++i) {
                     const int row = (lane >> 4) + 2 * i, cc = lane & 15;
                     const int pr =
                         __shfl_sync(0xffffffffu, i < 16 ? r0 : r1, row & 31);
                     const size_t src = (size_t)max(pr, 0) * HD + cc * 8;
                     cp16_or_zero(dk + swz(row, cc), pk + src, pr >= 0);
                     cp16_or_zero(dv + swz(row, cc), pv + src, pr >= 0);
                   }
                 });
    return;
  }

  const int w = tid >> 7, t = tid & (NT - 1);
  const int rw0 = 128 * blockIdx.x + 64 * w;
  const int nv_w = w ? nv[1] : nv[0], nk_w = w ? nkw[1] : nkw[0];
  const size_t row0 = ((size_t)r * H + (size_t)kh * G) * n_t + rw0;
  const uint32_t sQ = base + w * 2 * TILE;
  // this warpgroup's f32 q rows as bf16 terms: hi at sQ, lo at sQ + TILE
#pragma unroll
  for (int i = 0; i < T * HD / 8 / NT; ++i) {
    const int c = t + NT * i, row = c >> 4, cc = c & 15;
    uint32_t hi[4] = {0, 0, 0, 0}, lo[4] = {0, 0, 0, 0};
    if (row < nv_w) {
      const float4* src =
          reinterpret_cast<const float4*>(q + (row0 + row) * HD + cc * 8);
      const float4 a = src[0], b = src[1];
      const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 h2 =
            __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
        const float2 hf = __bfloat1622float2(h2);
        hi[e] = bits(h2);
        lo[e] = bits(__floats2bfloat162_rn(x[2 * e] - hf.x,
                                           x[2 * e + 1] - hf.y));
      }
    }
    st_shared16(sQ + swz(row, cc), hi[0], hi[1], hi[2], hi[3]);
    if (nq > 1)
      st_shared16(sQ + TILE + swz(row, cc), lo[0], lo[1], lo[2], lo[3]);
  }
  proxy_fence();
  bar_sync(3 + w, NT);  // this warpgroup's q terms are in place

  const int r0 = 16 * (t >> 5) + ((t & 31) >> 2), c0 = 2 * (t & 3);
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    lim[h] =
        row < nv_w ? min(pos_r + (rw0 + row) % n_t, live_end - 1) : -1;
  }
  float o[64], m[2], l[2], ls[2];
  fwd_consumer(ring, bars, sQ, nq, w, nk, nk_w, lim, sm_scale * LOG2E,
               o, m, l);
  if (nv_w == 0) return;
  fwd_finish(o, m, l, ls);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row < nv_w)
        *reinterpret_cast<float2*>(out + (row0 + row) * HD + 8 * j + c0) =
            make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
    }
}

// -- decode: the live keys split over blocks -----------------------------------

constexpr int DEC_WARPS = 4;
constexpr int DEC_THREADS = DEC_WARPS * 32;
constexpr int DEC_KEYS = 32;                       // keys a stage holds
constexpr int DEC_KW = DEC_KEYS / DEC_WARPS;       // keys a warp scores
constexpr int DEC_STAGES = 4;
constexpr int DEC_STAGE_BYTES = 2 * DEC_KEYS * HD * 2;   // K then V, bf16
constexpr int DEC_SMEM = DEC_STAGES * DEC_STAGE_BYTES;   // 64 KB
constexpr int DPL = HD / 32;                       // dims per lane

__device__ __forceinline__ void load_dims(const bf16* p, float (&out)[DPL]) {
#pragma unroll
  for (int d = 0; d < DPL; d += 2) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + d));
    out[d] = f.x;
    out[d + 1] = f.y;
  }
}

// Grid (chunks, n_kv, R); the block's G rows (G <= RB) are one (slot, KV
// head)'s query heads.  part_o [R, n_kv, chunks, G, hd] and part_ml
// [R, n_kv, chunks, G, 2] hold the blocks' partials; counters [R * n_kv]
// start at 0 and are left at 0.
template <int RB>
__global__ void __launch_bounds__(DEC_THREADS)
paged_decode_kernel(const float* __restrict__ q, const bf16* __restrict__ pk,
                    const bf16* __restrict__ pv,
                    const int* __restrict__ table,
                    const int* __restrict__ pos, float* __restrict__ out,
                    float* __restrict__ part_o, float* __restrict__ part_ml,
                    int* __restrict__ counters, int n_kv, int G, int n_tab,
                    int ps, int n_pages, int chunk_pages, float sm_scale) {
  extern __shared__ __align__(16) uint8_t dsmem[];
  __shared__ float m_s[DEC_WARPS][RB], l_s[DEC_WARPS][RB];
  __shared__ int is_last;
  const int c = blockIdx.x, kh = blockIdx.y, r = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pos_r = max(pos[r], 0);
  const int n_live = min(pos_r / ps + 1, n_tab);
  const int key_end = min(pos_r + 1, n_live * ps);
  const int n_ch = (n_live + chunk_pages - 1) / chunk_pages;
  if (c >= n_ch) return;               // past the live pages: no work
  const int kb0 = c * chunk_pages * ps;
  const int kb1 = min(kb0 + chunk_pages * ps, key_end);
  const int n_tiles = (kb1 - kb0 + DEC_KEYS - 1) / DEC_KEYS;
  const size_t cell = (size_t)r * n_kv + kh;
  const float scale2 = sm_scale * LOG2E;  // scores in log2 units

  // scores: lane (kq, pp) = (lane / 8, lane % 8) takes key kq of a group of
  // four against dims 16 pp .. 16 pp + 15 of every row; PV: lane owns dims
  // 4 lane .. 4 lane + 3
  const int kq = lane >> 3, pp = lane & 7;
  float qv[RB][16], acc[RB][DPL], m[RB], l[RB];
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[i][d] = 0.f;
#pragma unroll
    for (int d = 0; d < 16; d += 4) {
      const float4 x =
          i < G ? *reinterpret_cast<const float4*>(q + (cell * G + i) * HD +
                                                   16 * pp + d)
                : make_float4(0.f, 0.f, 0.f, 0.f);
      qv[i][d] = x.x;
      qv[i][d + 1] = x.y;
      qv[i][d + 2] = x.z;
      qv[i][d + 3] = x.w;
    }
  }

  const uint32_t sbase = smem_u32(dsmem);
  const int* trow = table + (size_t)r * n_tab;
  auto load = [&](int tile, int st) {
    // the pool row of key (tile, lane), looked up once by each warp before
    // any copy is issued, then dealt by shuffle
    const int pr = pool_row(trow, kb0 + tile * DEC_KEYS + lane, kb1, ps,
                            n_kv, kh, n_pages);
    const uint32_t dst = sbase + st * DEC_STAGE_BYTES;
#pragma unroll
    for (int u = 0; u < DEC_STAGE_BYTES / 16 / DEC_THREADS; ++u) {
      const int x = threadIdx.x + u * DEC_THREADS;
      const int kv = x / (DEC_KEYS * 16), row = (x / 16) % DEC_KEYS,
                cc = x % 16;
      const int rr = __shfl_sync(0xffffffffu, pr, row);
      const size_t src = (size_t)max(rr, 0) * HD + cc * 8;
      cp16_or_zero(dst + kv * (DEC_KEYS * HD * 2) + row * (HD * 2) + cc * 16,
                   (kv ? pv : pk) + src, rr >= 0);
    }
  };
#pragma unroll
  for (int s = 0; s < DEC_STAGES - 1; ++s) {
    if (s < n_tiles) load(s, s);
    cp_commit();
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_wait<DEC_STAGES - 2>();
    __syncthreads();  // tile landed; every warp is done with tile - 1
    if (tile + DEC_STAGES - 1 < n_tiles)
      load(tile + DEC_STAGES - 1, (tile + DEC_STAGES - 1) % DEC_STAGES);
    cp_commit();
    const int j0 = kb0 + tile * DEC_KEYS + warp * DEC_KW;
    const int kt = min(DEC_KW, kb1 - j0);
    if (kt <= 0) continue;
    const bf16* ks = reinterpret_cast<const bf16*>(
                         dsmem + (tile % DEC_STAGES) * DEC_STAGE_BYTES) +
                     warp * DEC_KW * HD;
    const bf16* vs = ks + DEC_KEYS * HD;

    // scores of keys kq and kq + 4 (of the warp's eight): 16 fused
    // multiply-adds a row, then three xor-shuffles over the key's 8 lanes
    float s[2][RB];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = 4 * h + kq;
      // the two 16-byte chunks, read in an order rotated by pp / 4 (so the
      // eight lanes of an access hit eight banks), then put back in place
      const uint4* kr = reinterpret_cast<const uint4*>(ks + kk * HD + 16 * pp);
      const bool swap = (pp >> 2) & 1;
      const uint4 first = kr[swap ? 1 : 0], second = kr[swap ? 0 : 1];
      const uint4 lo = swap ? second : first, hi = swap ? first : second;
      float kf[16];
      const __nv_bfloat162* bl = reinterpret_cast<const __nv_bfloat162*>(&lo);
      const __nv_bfloat162* bh = reinterpret_cast<const __nv_bfloat162*>(&hi);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(bl[e]);
        const float2 b = __bfloat1622float2(bh[e]);
        kf[2 * e] = a.x;
        kf[2 * e + 1] = a.y;
        kf[8 + 2 * e] = b.x;
        kf[8 + 2 * e + 1] = b.y;
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        float part = 0.f;
#pragma unroll
        for (int d = 0; d < 16; ++d) part = __fmaf_rn(qv[i][d], kf[d], part);
#pragma unroll
        for (int o = 1; o < 8; o <<= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        s[h][i] = kk < kt ? part * scale2 : -INFINITY;
      }
    }
    // online softmax over the warp's eight keys, per row
    float p[2][RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      float mx = fmaxf(s[0][i], s[1][i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float mn = fmaxf(m[i], mx);
      const float cf = ex2(m[i] - mn);                // 0 while m is -inf
      m[i] = mn;
      p[0][i] = ex2(s[0][i] - mn);                    // 0 past the keys
      p[1][i] = ex2(s[1][i] - mn);
      float ps = p[0][i] + p[1][i];
      ps += __shfl_xor_sync(0xffffffffu, ps, 8);
      ps += __shfl_xor_sync(0xffffffffu, ps, 16);
      l[i] = l[i] * cf + ps;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[i][d] *= cf;
    }
    // PV: each key's weights from its lanes, fused multiply-adds
#pragma unroll
    for (int kk = 0; kk < DEC_KW; ++kk) {
      if (kk < kt) {
        float vf[DPL];
        load_dims(vs + kk * HD + lane * DPL, vf);
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const float w =
              __shfl_sync(0xffffffffu, p[kk >> 2][i], 8 * (kk & 3));
#pragma unroll
          for (int d = 0; d < DPL; ++d)
            acc[i][d] = __fmaf_rn(w, vf[d], acc[i][d]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring becomes the merge area

  // the block's partial: the warps rescaled to their common max, summed in
  // warp order
  float* acc_s = reinterpret_cast<float*>(dsmem);   // [W][RB][HD]
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      m_s[warp][i] = m[i];
      l_s[warp][i] = l[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    float mx = -INFINITY;
    for (int w = 0; w < DEC_WARPS; ++w) mx = fmaxf(mx, m_s[w][i]);
    const float cf = m[i] == -INFINITY ? 0.f : ex2(m[i] - mx);
#pragma unroll
    for (int d = 0; d < DPL; ++d)
      acc_s[(warp * RB + i) * HD + lane * DPL + d] = acc[i][d] * cf;
  }
  __syncthreads();
  const size_t slot0 = (cell * n_chunks + c) * G;   // this block's rows
  for (int x = threadIdx.x; x < G * HD; x += DEC_THREADS) {
    const int i = x / HD, d = x - i * HD;
    float mx = -INFINITY;
    for (int w = 0; w < DEC_WARPS; ++w) mx = fmaxf(mx, m_s[w][i]);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < DEC_WARPS; ++w) {
      num += acc_s[(w * RB + i) * HD + d];
      if (m_s[w][i] != -INFINITY) den += l_s[w][i] * ex2(m_s[w][i] - mx);
    }
    part_o[(slot0 + i) * HD + d] = num;
    if (d == 0) {
      part_ml[2 * (slot0 + i)] = mx;
      part_ml[2 * (slot0 + i) + 1] = den;
    }
  }
  __threadfence();  // the partial is visible before the count says so
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(&counters[cell], 1) == n_ch - 1;
  __syncthreads();
  if (!is_last) return;

  // the last block combines the chunks' partials in chunk order
  __threadfence();
  for (int x = threadIdx.x; x < G * HD; x += DEC_THREADS) {
    const int i = x / HD, d = x - i * HD;
    float mx = -INFINITY;
    for (int cc = 0; cc < n_ch; ++cc)
      mx = fmaxf(mx, __ldcg(part_ml + 2 * ((cell * n_chunks + cc) * G + i)));
    float num = 0.f, den = 0.f;
    for (int cc = 0; cc < n_ch; ++cc) {
      const size_t row = (cell * n_chunks + cc) * G + i;
      const float f = ex2(__ldcg(part_ml + 2 * row) - mx);
      num += __ldcg(part_o + row * HD + d) * f;
      den += __ldcg(part_ml + 2 * row + 1) * f;
    }
    // every chunk sees a key, so den >= 1
    out[(cell * G + i) * HD + d] = num / den;
  }
  if (threadIdx.x == 0) counters[cell] = 0;
}

template <int RB>
int launch_decode(const float* q, const bf16* k, const bf16* v,
                  const int* table, const int* pos, float* out, float* part,
                  int* counters, int R, int n_kv, int G, int n_tab, int ps,
                  int n_pages, int chunk_pages, float sm_scale,
                  cudaStream_t stream) {
  int err = launch_prep(paged_decode_kernel<RB>, DEC_SMEM);
  if (err) return err;
  const int n_chunks = (n_tab + chunk_pages - 1) / chunk_pages;
  float* part_ml = part + (size_t)R * n_kv * n_chunks * G * HD;
  paged_decode_kernel<RB><<<dim3(n_chunks, n_kv, R), DEC_THREADS, DEC_SMEM,
                            stream>>>(q, k, v, table, pos, out, part, part_ml,
                                      counters, n_kv, G, n_tab, ps, n_pages,
                                      chunk_pages, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q f32 [R, H, T, hd]; pools [n_pages, n_kv, page_size, hd] bf16; table
// int32 [R, n_tab]; pos int32 [R]; out f32 [R, H, T, hd].  All contiguous,
// 16-byte aligned, hd = 128.  chunk_pages > 0 takes the decode kernel
// (T = 1, G <= 8): part is f32 scratch of R * n_kv * ceil(n_tab /
// chunk_pages) * G * (hd + 2) elements and counters R * n_kv int32 zeros
// (left zero).  chunk_pages == 0 takes the prefill kernel, with q_terms
// (1 or 2) bf16 terms of q.  Returns cudaGetLastError() after the launch.
extern "C" int paged_attend_launch(const float* q, const void* pool_k,
                                   const void* pool_v, const int* table,
                                   const int* pos, float* out, float* part,
                                   int* counters, int R, int H, int n_kv,
                                   int n_t, int hd, int n_tab, int page_size,
                                   int n_pages, int q_terms, int chunk_pages,
                                   float sm_scale, cudaStream_t stream) {
  if (hd != HD || q_terms < 1 || q_terms > 2)
    return (int)cudaErrorInvalidValue;
  const int G = H / n_kv;
  const bf16* k = static_cast<const bf16*>(pool_k);
  const bf16* v = static_cast<const bf16*>(pool_v);
  if (chunk_pages > 0) {
    if (n_t != 1 || G > 8) return (int)cudaErrorInvalidValue;
    auto f = G == 1   ? &launch_decode<1>
             : G <= 2 ? &launch_decode<2>
             : G <= 4 ? &launch_decode<4>
                      : &launch_decode<8>;
    return f(q, k, v, table, pos, out, part, counters, R, n_kv, G, n_tab,
             page_size, n_pages, chunk_pages, sm_scale, stream);
  }
  int err = launch_prep(paged_prefill_kernel, PagedSmem::BYTES);
  if (err) return err;
  const int blocks = (G * n_t + 2 * T - 1) / (2 * T);
  paged_prefill_kernel<<<dim3(blocks, n_kv, R), FWD_THREADS,
                         PagedSmem::BYTES, stream>>>(
      q, k, v, table, pos, out, H, n_kv, n_t, n_tab, page_size, n_pages,
      q_terms, sm_scale);
  return (int)cudaGetLastError();
}
