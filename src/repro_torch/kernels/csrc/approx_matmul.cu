// LUT matmul at W4A4 and W8A8 for Hopper (sm_90a):
//     out[m, n] = sum_k LUT[a[m, k], b[k, n]]            (int32, exact)
//
// Replaces the Pallas kernels of repro/kernels/approx_matmul.py:
//   * _kernel (W4A4, through _lut16_contract), reached from
//     approx_matmul_pallas with a (16, 16) table;
//   * _kernel8 with _extract_tile_jnp (W8A8), reached with a composed
//     (256, 256) table.  The 8-bit product factors into four nibble-plane
//     lookups in the table's (16, 16) generator tile T:
//       LUT8[a, b] = T[al, bl] + 16 (T[al, bh] + T[ah, bl]) + 256 T[ah, bh]
//     The wrapper recovers T from the table on the device; the full table
//     (256 KB of int32) would not fit in the 227 KB of shared memory.
//
// Design.  The TPU kernel turns the lookup into two one-hot matmuls on the
// MXU, because gathers are slow there.  Here the table sits in shared
// memory and every thread gathers from it: one lookup per (m, k, n) at W4,
// four at W8, summed in int32 with wraparound (exact while K <= max_k, which
// the wrapper checks).  A block stages a k-tile of A and B codes into
// shared memory narrowed to u8; each thread owns one column and kTM = 8 rows.
// Rows are tiled by RG row groups, chosen from M, so a 4-row decode call
// runs 8-row blocks with the idle rows skipped (warp-uniform), not 128-row
// blocks.  The ragged M, N and K edges are masked here: nothing is padded,
// so no LUT[0, 0] correction is needed.  When the M x N tiles cannot fill
// the card (decode), K is split across blocks that add into a zeroed
// output with integer atomics, which are exact in any order.
//
// Bound on the H100: at decode (M = 4) the int32 B codes dominate the bytes
// (about 100 MB per qwen3-4b MLP matrix), so the kernel is bound by memory;
// at prefill (M = 1024) it is bound by shared-memory lookups, one 32-bit
// load per product, far below the int8 tensor-core rate that a one-hot
// tensor-core form could reach.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 8;   // rows per thread
constexpr int kBK = 32;  // k-depth of one staged tile

template <int RG, bool kW8>
__global__ void __launch_bounds__(kThreads)
lut_matmul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                  const int32_t* __restrict__ table, int32_t* __restrict__ out,
                  int M, int K, int N, int k_chunk) {
  constexpr int BM = RG * kTM;
  constexpr int BN = kThreads / RG;  // >= 32: a warp never spans two row groups
  __shared__ uint32_t s_lut[256];
  __shared__ __align__(8) uint8_t s_a[kBK][BM];
  __shared__ uint8_t s_b[kBK][BN];

  const int tid = threadIdx.x;
  const int g = tid / BN;  // row group
  const int c = tid % BN;  // column within the block
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_chunk;
  const int ke = min(K, kb + k_chunk);
  const bool live = m0 + g * kTM < M;

  s_lut[tid] = static_cast<uint32_t>(table[tid]);
  uint32_t acc[kTM];
#pragma unroll
  for (int r = 0; r < kTM; ++r) acc[r] = 0u;

  for (int k0 = kb; k0 < ke; k0 += kBK) {
    const int kn = min(kBK, ke - k0);
    __syncthreads();  // the previous tile is consumed (and s_lut is written)
    for (int i = tid; i < BM * kBK; i += kThreads) {
      const int m = i / kBK, kk = i % kBK;
      int v = 0;
      if (m0 + m < M && kk < kn) v = a[static_cast<size_t>(m0 + m) * K + k0 + kk];
      s_a[kk][m] = static_cast<uint8_t>(v);
    }
    for (int i = tid; i < kBK * BN; i += kThreads) {
      const int kk = i / BN, nn = i % BN;
      int v = 0;
      if (kk < kn && n0 + nn < N) v = b[static_cast<size_t>(k0 + kk) * N + n0 + nn];
      s_b[kk][nn] = static_cast<uint8_t>(v);
    }
    __syncthreads();
    if (!live) continue;
    for (int kk = 0; kk < kn; ++kk) {
      // the thread's 8 row codes at this k are 8 consecutive bytes
      const uint2 av = *reinterpret_cast<const uint2*>(&s_a[kk][g * kTM]);
      const uint32_t bc = s_b[kk][c];
#pragma unroll
      for (int r = 0; r < kTM; ++r) {
        const uint32_t ar = ((r < 4 ? av.x : av.y) >> (8 * (r & 3))) & 0xffu;
        if (kW8) {
          const uint32_t al = ar & 15u, ah = ar >> 4, bl = bc & 15u, bh = bc >> 4;
          acc[r] += s_lut[al * 16 + bl]
                  + 16u * (s_lut[al * 16 + bh] + s_lut[ah * 16 + bl])
                  + 256u * s_lut[ah * 16 + bh];
        } else {
          acc[r] += s_lut[ar * 16 + bc];
        }
      }
    }
  }

  const int n = n0 + c;
  if (!live || n >= N) return;
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    const int m = m0 + g * kTM + r;
    if (m >= M) break;
    uint32_t* dst = reinterpret_cast<uint32_t*>(out) + static_cast<size_t>(m) * N + n;
    if (gridDim.z == 1) {
      *dst = acc[r];
    } else {
      atomicAdd(dst, acc[r]);
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <bool kW8>
int launch(const int32_t* a, const int32_t* b, const int32_t* table,
           int32_t* out, int M, int K, int N, cudaStream_t stream) {
  if (M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  if (K == 0) {
    cudaMemsetAsync(out, 0, static_cast<size_t>(M) * N * sizeof(int32_t), stream);
    return static_cast<int>(cudaGetLastError());
  }
  int rg = 1;
  while (rg < 8 && rg * kTM < M) rg *= 2;
  const int bm = rg * kTM, bn = kThreads / rg;
  const int gm = (M + bm - 1) / bm, gn = (N + bn - 1) / bn;
  // split K until the grid covers the card about twice over, keeping each
  // split at least 8 staged tiles deep
  int splits = (2 * sm_count() + gm * gn - 1) / (gm * gn);
  splits = std::max(1, std::min(splits, K / (8 * kBK)));
  const int k_chunk = ((K + splits - 1) / splits + kBK - 1) / kBK * kBK;
  splits = (K + k_chunk - 1) / k_chunk;
  if (splits > 1) {
    cudaMemsetAsync(out, 0, static_cast<size_t>(M) * N * sizeof(int32_t), stream);
  }
  const dim3 grid(gn, gm, splits);
  switch (rg) {
    case 1: lut_matmul_kernel<1, kW8><<<grid, kThreads, 0, stream>>>(a, b, table, out, M, K, N, k_chunk); break;
    case 2: lut_matmul_kernel<2, kW8><<<grid, kThreads, 0, stream>>>(a, b, table, out, M, K, N, k_chunk); break;
    case 4: lut_matmul_kernel<4, kW8><<<grid, kThreads, 0, stream>>>(a, b, table, out, M, K, N, k_chunk); break;
    default: lut_matmul_kernel<8, kW8><<<grid, kThreads, 0, stream>>>(a, b, table, out, M, K, N, k_chunk); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a (M, K), b (K, N) int32 codes in [0, 16); lut (16, 16) int32; out (M, N).
int approx_matmul_w4(const void* a, const void* b, const void* lut, void* out,
                     int M, int K, int N, void* stream) {
  return launch<false>(static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
                       static_cast<const int32_t*>(lut), static_cast<int32_t*>(out),
                       M, K, N, static_cast<cudaStream_t>(stream));
}

// a (M, K), b (K, N) int32 codes in [0, 256); tile (16, 16) int32, the
// generator of the composed (256, 256) table; out (M, N).
int approx_matmul_w8(const void* a, const void* b, const void* tile, void* out,
                     int M, int K, int N, void* stream) {
  return launch<true>(static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
                      static_cast<const int32_t*>(tile), static_cast<int32_t*>(out),
                      M, K, N, static_cast<cudaStream_t>(stream));
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
