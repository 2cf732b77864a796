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
// page's bytes are never read.
//
// What bounds it on the card: bytes at decode (each live K/V byte is read
// once per (slot, KV head) and serves only G query rows), operations at
// prefill (G*T rows share each key, so the f32 score and PV work grows with
// the rows while the bytes do not).  The design does not copy the TPU's:
// there one cell held the whole [G*T, P*page_size] score row in VMEM, 8 MB
// at a 256-token prefill chunk, far beyond a block's 227 KB of shared
// memory.  Here one block of eight warps takes one (slot, KV head, group of
// up to 8 query rows).  It reads pos and the page table row itself and
// stops at the last key its rows can see, so dead pages, and at prefill the
// causally hidden keys, move no bytes.  The live keys are cut into tiles of
// 2 KB of K (8 bf16 positions of hd=128, never across a page), dealt round
// robin to the warps: at decode one (slot, head) then has eight independent
// streams of loads in flight instead of one.  A warp copies its tile's K
// and V to its own shared memory in 16-byte loads (whole lines per warp),
// then scores it against every row of the block: a lane holds hd/32
// neighbouring dims of q and five xor-shuffles finish each dot; lane j
// keeps key j's score and takes its one expf, and the PV pass broadcasts
// the weights back with one shuffle per key.  Each warp keeps an online
// softmax per row (running max and sum, one rescale per tile) in f32 with
// accurate expf; at the end the warps' partial results are rescaled to the
// common max and summed in a fixed order.  Masked keys get weight 0, as the
// reference's exact -1e30 scores do after its softmax.  A warp issues its
// next tile's loads into registers before it scores the current one, so
// the loads overlap the math.  Not done yet: deeper pipelining (cp.async or
// TMA into a ring of shared-memory stages) and tensor-core tiles, which
// the prefill shapes need to come near their bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

using KV = __nv_bfloat16;               // the serving pool's dtype
constexpr int HD = 128;                // Llama-3's head_dim
constexpr int DPL = HD / 32;           // dims per lane
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILE_BYTES = 2048;       // K bytes per warp tile (V the same)

__device__ __forceinline__ void load_row(const float* p, float (&out)[DPL]) {
#pragma unroll
  for (int d = 0; d < DPL; ++d) out[d] = p[d];
}

__device__ __forceinline__ void load_row(const KV* p, float (&out)[DPL]) {
#pragma unroll
  for (int d = 0; d < DPL; d += 2) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + d));
    out[d] = f.x;
    out[d + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Grid (row groups, n_kv, R); RB query rows per block, every warp takes all
// of them for its own key tiles.
template <int RB>
__global__ void __launch_bounds__(THREADS)
paged_attend_kernel(const float* __restrict__ q, const KV* __restrict__ pool_k,
                    const KV* __restrict__ pool_v,
                    const int* __restrict__ table, const int* __restrict__ pos,
                    float* __restrict__ out, int n_kv, int gt, int n_t,
                    int n_tab, int page_size, int n_pages, float sm_scale) {
  constexpr int KT = TILE_BYTES / (HD * (int)sizeof(KV));   // keys per tile
  constexpr int NL = TILE_BYTES / 16 / 32;                   // loads per lane
  static_assert(KT >= 1 && KT <= 32, "tile must hold 1..32 keys");
  static_assert(WARPS * RB * HD * 4 <= WARPS * 2 * TILE_BYTES,
                "the merge area must fit in the tile buffers");
  __shared__ __align__(16) unsigned char smem[WARPS][2][TILE_BYTES];
  __shared__ float m_s[WARPS][RB], l_s[WARPS][RB];

  const int rg = blockIdx.x, kh = blockIdx.y, r = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pos_r = max(pos[r], 0);
  const int n_live = min((pos_r + n_t - 1) / page_size + 1, n_tab);
  const long long head_row0 = ((long long)r * n_kv + kh) * gt;
  const int row0 = rg * RB;
  const int n_rows = min(RB, gt - row0);

  // the last key any row of this block sees bounds the walk
  int t_max = 0;
  for (int i = 0; i < n_rows; ++i) t_max = max(t_max, (row0 + i) % n_t);
  const int key_end = min(pos_r + t_max + 1, n_live * page_size);

  float qv[RB][DPL], acc[RB][DPL], m[RB], l[RB];
  int lim[RB];                         // last visible key; -1: no such row
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    lim[i] = i < n_rows ? pos_r + (row0 + i) % n_t : -1;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) {
      acc[i][d] = 0.f;
      qv[i][d] = 0.f;
    }
    if (i < n_rows)
      load_row(q + (head_row0 + row0 + i) * HD + lane * DPL, qv[i]);
  }

  KV* ks = reinterpret_cast<KV*>(smem[warp][0]);
  KV* vs = reinterpret_cast<KV*>(smem[warp][1]);
  const int* trow = table + (long long)r * n_tab;
  const int tiles_per_page = (page_size + KT - 1) / KT;
  const int n_tiles = (key_end / page_size) * tiles_per_page +
                      (key_end % page_size + KT - 1) / KT;
  // tile -> (first key, page offset, keys); a tile never crosses a page
  auto geom = [&](int tile, int& j0, int& off, int& kt) {
    const int page_i = tile / tiles_per_page;
    off = (tile - page_i * tiles_per_page) * KT;
    j0 = page_i * page_size + off;
    kt = min(KT, min(page_size - off, key_end - j0));
  };
  // the next tile's K/V wait in registers while this tile is scored
  uint4 rk[NL], rv[NL];
  auto fetch = [&](int tile) {
    int j0, off, kt;
    geom(tile, j0, off, kt);
    // a table entry outside the pool is clamped, as XLA's gather clamps
    const int page = min(max(trow[j0 / page_size], 0), n_pages - 1);
    const long long src =
        (((long long)page * n_kv + kh) * page_size + off) * HD;
    const uint4* gk = reinterpret_cast<const uint4*>(pool_k + src);
    const uint4* gv = reinterpret_cast<const uint4*>(pool_v + src);
    const int n16 = kt * HD * (int)sizeof(KV) / 16;
#pragma unroll
    for (int u = 0; u < NL; ++u) {
      if (lane + 32 * u < n16) {
        rk[u] = gk[lane + 32 * u];
        rv[u] = gv[lane + 32 * u];
      }
    }
  };
  if (warp < n_tiles) fetch(warp);
  for (int tile = warp; tile < n_tiles; tile += WARPS) {
    int j0, off, kt;
    geom(tile, j0, off, kt);
    const int n16 = kt * HD * (int)sizeof(KV) / 16;
    __syncwarp();                      // the previous tile is consumed
#pragma unroll
    for (int u = 0; u < NL; ++u) {
      if (lane + 32 * u < n16) {
        reinterpret_cast<uint4*>(ks)[lane + 32 * u] = rk[u];
        reinterpret_cast<uint4*>(vs)[lane + 32 * u] = rv[u];
      }
    }
    __syncwarp();
    if (tile + WARPS < n_tiles) fetch(tile + WARPS);

    // scores: every lane gets each key's dot; lane jj keeps key jj's.
    // No per-row branch, so the rows' shuffle chains interleave.
    float mt[RB], s_own[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      mt[i] = -INFINITY;
      s_own[i] = -INFINITY;
    }
#pragma unroll
    for (int jj = 0; jj < KT; ++jj) {
      if (jj < kt) {
        float kf[DPL];
        load_row(ks + jj * HD + lane * DPL, kf);
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          float part = 0.f;
#pragma unroll
          for (int d = 0; d < DPL; ++d) part += qv[i][d] * kf[d];
          const float dot = warp_sum(part) * sm_scale;
          const float s = j0 + jj <= lim[i] ? dot : -INFINITY;
          mt[i] = fmaxf(mt[i], s);
          if (lane == jj) s_own[i] = s;
        }
      }
    }
    // online softmax: one expf per (row, key), on the key's own lane
    float p_own[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const float mn = fmaxf(m[i], mt[i]);
      const float base = mn == -INFINITY ? 0.f : mn;   // no key seen yet
      const float c = expf(m[i] - base);               // 0 while m is -inf
      m[i] = mn;
      p_own[i] = expf(s_own[i] - base);                // 0 for masked keys
      l[i] = l[i] * c + warp_sum(p_own[i]);
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[i][d] *= c;
    }
#pragma unroll
    for (int jj = 0; jj < KT; ++jj) {
      if (jj < kt) {
        float vf[DPL];
        load_row(vs + jj * HD + lane * DPL, vf);
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const float p = __shfl_sync(0xffffffffu, p_own[i], jj);
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[i][d] += p * vf[d];
        }
      }
    }
  }

  // merge the warps: rescale each to the common max, sum in warp order
  __syncthreads();                     // tile buffers become the merge area
  float* acc_s = reinterpret_cast<float*>(&smem[0][0][0]);   // [W][RB][HD]
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
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_s[w][i]);
    const float c = m[i] == -INFINITY ? 0.f : expf(m[i] - mx);
#pragma unroll
    for (int d = 0; d < DPL; ++d)
      acc_s[(warp * RB + i) * HD + lane * DPL + d] = acc[i][d] * c;
  }
  __syncthreads();
  for (int x = threadIdx.x; x < n_rows * HD; x += THREADS) {
    const int i = x / HD, d = x - i * HD;
    float mx = -INFINITY;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_s[w][i]);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      num += acc_s[(w * RB + i) * HD + d];
      if (m_s[w][i] != -INFINITY) den += l_s[w][i] * expf(m_s[w][i] - mx);
    }
    // every row sees key 0, so den >= 1
    out[(head_row0 + row0 + i) * HD + d] = num / den;
  }
}

}  // namespace

// q f32 [R, H, T, hd]; pools [n_pages, n_kv, page_size, hd] bf16; table
// int32 [R, n_tab]; pos int32 [R]; out f32 [R, H, T, hd].  All contiguous,
// pools 16-byte aligned, hd = 128.  Returns cudaGetLastError() after the
// launch.
extern "C" int paged_attend_launch(const float* q, const void* pool_k,
                                   const void* pool_v, const int* table,
                                   const int* pos, float* out, int R, int H,
                                   int n_kv, int T, int hd, int n_tab,
                                   int page_size, int n_pages, float sm_scale,
                                   cudaStream_t stream) {
  if (hd != HD) return (int)cudaErrorInvalidValue;
  const int gt = (H / n_kv) * T;
  const KV* k = static_cast<const KV*>(pool_k);
  const KV* v = static_cast<const KV*>(pool_v);
  if (gt == 1) {                       // MHA decode: one row
    paged_attend_kernel<1><<<dim3(1, n_kv, R), THREADS, 0, stream>>>(
        q, k, v, table, pos, out, n_kv, gt, T, n_tab, page_size, n_pages,
        sm_scale);
  } else if (gt <= 4) {                // GQA decode: one row group
    paged_attend_kernel<4><<<dim3(1, n_kv, R), THREADS, 0, stream>>>(
        q, k, v, table, pos, out, n_kv, gt, T, n_tab, page_size, n_pages,
        sm_scale);
  } else {
    paged_attend_kernel<8><<<dim3((gt + 7) / 8, n_kv, R), THREADS, 0,
                             stream>>>(q, k, v, table, pos, out, n_kv, gt, T,
                                       n_tab, page_size, n_pages, sm_scale);
  }
  return (int)cudaGetLastError();
}
