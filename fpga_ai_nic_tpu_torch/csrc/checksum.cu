// One-pass row checksums: out[r] = sum_j mult_j * sum_i (2i+1) * word_i(r, j)
// (mod 2^32), where word_i(r, j) is the i-th element of row r of array j,
// zero-extended to 32 bits (1-, 2- and 4-byte elements).
//
// The exact checksum of the JAX package's ops/integrity.py (word_checksum,
// gathered_page_checksums, page_checksums), which XLA fuses into one read
// of its operands on the TPU; there it has no Pallas kernel.  The port
// needs it on three paths: the serving engine's per-page ledger (every KV
// page of every layer, twice a tick), the per-rank payload checksums of
// the unfused rings, and the replica agreement after the fused all-gather.
//
// What bounds it on the card: bytes.  Each byte is read once and nothing
// is written but one word a row (the ledger pass over Llama-3-8B's 2049-
// page pool, 64 arrays of [2049, 16384] bf16, is 4.30 GB: 1.28 ms at
// 3.35 TB/s), against a few integer operations a byte.  The design:
//   - one launch covers up to MAX_ARRAYS arrays; their table (pointer, row
//     stride, words a row, element size, multiplier) rides in the kernel's
//     parameters, so no table is copied to the card;
//   - a block takes one 16 KiB segment of one row of one array
//     (blockIdx.x: segment, blockIdx.y: row, in steps of gridDim.y,
//     blockIdx.z: array); each thread issues its four 16-byte loads before
//     it uses any, so 64 bytes a thread are in flight;
//   - a 16-byte load at word index i0 holds words i0 .. i0+k-1, and
//     sum_t (2(i0+t)+1) w_t = (2 i0 + 1) * sum_t w_t + 2 * sum_t t w_t: two
//     byte dot products (dp4a) a word of u8 data, two sums for bf16 or f32;
//   - warp shuffles and one shared-memory pass reduce the block, and one
//     atomicAdd (uint32, wrapping: the sum does not depend on its order, so
//     the result is the same on every run) a block and row adds it to out.
// A row whose start or length is not a multiple of 16 bytes is read word by
// word (odd shapes; never the pool or the replicas).
#include <cstdint>
#include <cuda_runtime.h>

constexpr int MAX_ARRAYS = 96;   // keep in step with ops/integrity.py

// One array of a launch (ops/integrity.py _Entry).
struct Entry {
  const void* ptr;
  long long row_stride;   // bytes between rows
  long long words;        // elements a row
  int esize;              // bytes an element: 1, 2 or 4
  unsigned mult;          // odd per-array multiplier
};

struct Table {
  Entry e[MAX_ARRAYS];
};

namespace {

constexpr int THREADS = 256;
constexpr int ITERS = 4;                                   // loads a thread
constexpr long long SEG_BYTES = (long long)THREADS * 16 * ITERS;

__device__ __forceinline__ unsigned weighted16(uint4 v, int esize,
                                               unsigned long long i0) {
  unsigned s, t;
  if (esize == 1) {
    s = __dp4a(v.x, 0x01010101u, 0u);
    s = __dp4a(v.y, 0x01010101u, s);
    s = __dp4a(v.z, 0x01010101u, s);
    s = __dp4a(v.w, 0x01010101u, s);
    t = __dp4a(v.x, 0x03020100u, 0u);
    t = __dp4a(v.y, 0x07060504u, t);
    t = __dp4a(v.z, 0x0B0A0908u, t);
    t = __dp4a(v.w, 0x0F0E0D0Cu, t);
  } else if (esize == 2) {
    const unsigned h[8] = {v.x & 0xFFFFu, v.x >> 16, v.y & 0xFFFFu,
                           v.y >> 16,     v.z & 0xFFFFu, v.z >> 16,
                           v.w & 0xFFFFu, v.w >> 16};
    s = 0u;
    t = 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      s += h[k];
      t += (unsigned)k * h[k];
    }
  } else {
    s = v.x + v.y + v.z + v.w;
    t = v.y + 2u * v.z + 3u * v.w;
  }
  return (2u * (unsigned)i0 + 1u) * s + 2u * t;
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
    row_checksums_kernel(const __grid_constant__ Table tab, long long rows,
                         unsigned* out) {
  const Entry& e = tab.e[blockIdx.z];
  const long long row_bytes = e.words * e.esize;
  const long long seg0 = (long long)blockIdx.x * SEG_BYTES;
  if (seg0 >= row_bytes) return;                    // the whole block
  const int shift = e.esize >> 1;                   // log2 of 1, 2, 4
  const bool vec = ((reinterpret_cast<uintptr_t>(e.ptr) |
                     (unsigned long long)e.row_stride |
                     (unsigned long long)row_bytes) & 15u) == 0;
  __shared__ unsigned part[THREADS / 32];
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const unsigned char* base =
        static_cast<const unsigned char*>(e.ptr) + row * e.row_stride;
    unsigned acc = 0u;
    if (vec) {
      uint4 v[ITERS];
      long long b[ITERS];
#pragma unroll
      for (int it = 0; it < ITERS; ++it) {
        b[it] = seg0 + (long long)(it * THREADS + threadIdx.x) * 16;
        v[it] = b[it] < row_bytes
                    ? __ldg(reinterpret_cast<const uint4*>(base + b[it]))
                    : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int it = 0; it < ITERS; ++it)
        acc += weighted16(v[it], e.esize,
                          (unsigned long long)(b[it] >> shift));
    } else {
      const long long w1 = min(seg0 + SEG_BYTES, row_bytes) >> shift;
      for (long long i = (seg0 >> shift) + threadIdx.x; i < w1; i += THREADS) {
        unsigned w;
        if (e.esize == 1) {
          w = base[i];
        } else if (e.esize == 2) {
          w = reinterpret_cast<const unsigned short*>(base)[i];
        } else {
          w = reinterpret_cast<const unsigned*>(base)[i];
        }
        acc += (2u * (unsigned)i + 1u) * w;
      }
    }
    acc = warp_sum(acc);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned s = 0u;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) s += part[w];
      atomicAdd(out + row, e.mult * s);
    }
    __syncthreads();
  }
}

}  // namespace

// out [rows] must be zeroed by the caller; the launch adds every array's
// rows into it.  max_row_bytes: the longest row of the table, in bytes.
extern "C" int row_checksums_launch(const Entry* table, int n_arrays,
                                    long long rows, long long max_row_bytes,
                                    unsigned* out, cudaStream_t stream) {
  if (n_arrays < 1 || n_arrays > MAX_ARRAYS || rows < 1)
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < n_arrays; ++j) {
    const int s = table[j].esize;
    if (s != 1 && s != 2 && s != 4) return (int)cudaErrorInvalidValue;
  }
  Table tab;
  for (int j = 0; j < n_arrays; ++j) tab.e[j] = table[j];
  const long long segs = (max_row_bytes + SEG_BYTES - 1) / SEG_BYTES;
  if (segs > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)segs, (unsigned)(rows < 65535 ? rows : 65535),
                  (unsigned)n_arrays);
  row_checksums_kernel<<<grid, THREADS, 0, stream>>>(tab, rows, out);
  return (int)cudaGetLastError();
}
