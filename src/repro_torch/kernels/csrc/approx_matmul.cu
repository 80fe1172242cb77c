// LUT matmul at W4A4 and W8A8 for Hopper (sm_90a), on the u8 tensor cores:
//     out[m, n] = sum_k LUT[a[m, k], b[k, n]]            (int32, exact)
//
// Replaces the Pallas kernels of repro/kernels/approx_matmul.py:
//   * _kernel (W4A4, through _lut16_contract), reached from
//     approx_matmul_pallas with a (16, 16) table;
//   * _kernel8 with _extract_tile_jnp (W8A8), reached with a composed
//     (256, 256) table, whose 8-bit product factors through the table's
//     (16, 16) generator tile T:
//       LUT8[a, b] = T[al, bl] + 16 (T[al, bh] + T[ah, bl]) + 256 T[ah, bh]
//
// The algebra.  The lookup is a product of contraction depth 16 K between
// two u8 operands.  A table (or tile) entry in [0, 255] is one byte; a
// wider one is split into byte planes, T = sum_p 256^p T_p, and each
// plane is a pass over K that the accumulators take by Horner's rule
// (acc = 256 acc + pass, highest plane first), so any int32 table is
// exact modulo 2^32, as the int32 sum it reproduces.  Every block reads
// the table as it starts and runs as many passes as its widest entry
// needs: one for the byte tables of the searched 4-bit multipliers,
// two for entries up to 65,535 (composed 2-bit blocks reach 375).
// With the contraction index (k, i), i < 16:
//   W4A4:  out[m, n] = sum_(k,i) LUT[a[m,k], i] * [b[k,n] = i]
//   W8A8:  one-hot side  W[(k,i), n] = [bl = i] + 16 [bh = i]  (0, 1, 16, 17)
//          expanded side P_l[m, (k,i)] = T[al, i],  P_h[m, (k,i)] = T[ah, i]
//          out = P_l W + 16 (P_h W)
//   Check: P_l W = T[al,bl] + 16 T[al,bh] and P_h W = T[ah,bl] + 16 T[ah,bh],
//   so P_l W + 16 P_h W = LUT8[a, b].
// Both products accumulate u8 x u8 -> s32 without .satfinite.  Neither
// can pass 2^31 in one pass: a plane's sum is at most 17 * 255 * K, below
// 2^31 while K <= 29,140, the W8A8 max_k the wrapper enforces
// (255 * 289 * K < 2^31); the W4A4 sum is at most 255 K.  The shift-adds
// of the planes and passes wrap modulo 2^32 like the int32 sum they
// reproduce.
//
// The form.  The output is computed transposed: wgmma's 64-row operand
// is the weight side (64 output columns n per warpgroup), built in
// registers as the one-hot of the int32 B codes (two ALU operations a
// register, no table read), so the weights are never expanded in memory
// and the table is read once per activation code, not per weight.  The
// activation rows are wgmma's N dimension (8 at decode, 64 or 128
// otherwise); their expanded rows T[a, :] (16 bytes a code, contiguous
// along the contraction: K-major, the only 8-bit layout) are built in
// shared memory from a copy of the table.  A block of two or three
// warpgroups covers 64 columns n each and BM rows m.  The int32 codes of
// both sides stream through a ring of cp.async stages, 16 codes deep (16
// bytes a copy where the row is aligned, 4 otherwise); the expanded
// activation tile is double-buffered, so it is built for stage s + 1
// while the tensor cores run stage s.  Ragged M, N and K are masked, not
// padded: codes past an edge are zero-filled, activation rows past the
// block's own k range are zero, and only the output's live entries are
// stored.  When the tiles cannot fill the card (decode, or few column
// blocks), K is split across blocks that add into a zeroed output with
// integer atomics, exact in any order.  The W8A8 launch takes the
// composed (256, 256) table and every block recovers T from it (floor
// division) as it starts.  A further byte plane repeats the pipeline
// over the block's K range with the table's next byte.
//
// Bounds on the H100 (3.35 TB/s, 1,979 TOP/s int8).  The function's bound
// counts the int32 codes and output once and 2 M K N operations.  This
// form's own floor is its tensor work, 16 * 2 M K N u8 operations at W4A4
// and twice that at W8A8 (two planes): 0.41 and 0.82 ms at (1024, 2560,
// 9728), where the card is bound by operations; at decode (M = 4) both
// widths are bound by the 100 MB of int32 B codes, 0.0298 ms.  Measured on
// an H100 SXM at 700 W, the kernel reaches 36-39% of the form's floor at
// that shape and 2.0-2.9x the byte bound at decode: what binds it is the
// work around the products (the tile's build, 16 bytes a code read and
// written, and the one-hot registers) and two barriers a stage, not the
// tensor cores.  A table past a byte takes 1.83-1.95x a byte table's
// time there, a pass a byte.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kBK = 16;  // codes k of a staged tile

// wgmma.mma_async m64nBMk32, s32 += u8 (registers, the weight side) x u8
// (shared memory, the activation side), no .satfinite.
template <int BM>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(uint32_t (&d)[4], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.u8.u8 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(uint32_t (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(uint32_t (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

// A block: BM activation rows (wgmma's N: 8 at decode, else 64 or 128)
// by 64 output columns per warpgroup.  W4A4 at 128 rows takes three
// warpgroups, which share the expanded activation tile (its build is the
// largest cost besides the tensor work); W8A8, with two accumulators,
// has registers for two.  Decode runs three blocks an SM.
template <int BM, bool kW8>
struct Cfg {
  static constexpr int kWarpgroups = BM == 128 && !kW8 ? 3 : 2;
  static constexpr int kThreads = 128 * kWarpgroups;
  static constexpr int kBN = 64 * kWarpgroups;        // output columns n of a block
  static constexpr int kMinBlocks = BM == 8 ? 3 : 1;  // blocks an SM
  static constexpr int kStages = BM == 8 ? 6 : 3;     // decode streams B: deeper ring
  static constexpr int kPlanes = kW8 ? 2 : 1;
  static constexpr int kAStride = kBK + 4;            // words a staged A row: no bank conflicts
  static constexpr int kStageWords = BM * kAStride + kBK * kBN;
  static constexpr int kPlaneBytes = BM * kBK * 16;   // [BM/8][kBK][8 rows][16 bytes]
  static constexpr int kActBytes = 2 * kPlanes * kPlaneBytes;
  // the table's 16 rows of 16 bytes, eight times: copy q of row r at
  // (8 r + q) * 16 lies in bank group q, so the eight lanes of a quarter
  // warp (lanes 8 apart read copies 0-7) never conflict
  static constexpr int kTabBytes = 16 * 8 * 16;
  static constexpr int kSmem = kActBytes + kStages * kStageWords * 4 + kTabBytes;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; a dead copy reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(live ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(live ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// make this thread's shared-memory writes visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keep the compiler from moving accumulator accesses across the
// asynchronous region
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// x << s with PTX's clamp: a shift of 32 or more gives 0
__device__ __forceinline__ uint32_t shl(uint32_t x, uint32_t s) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(s));
  return r;
}

// Byte j of the result is the one-hot weight of slot i = i0 + j of the
// code's 16: [code = i] at W4A4, [bl = i] + 16 [bh = i] at W8A8.  An
// index below i0 wraps to a shift past 31, which clamps to 0.
template <bool kW8>
__device__ __forceinline__ uint32_t onehot(uint32_t code, uint32_t i0) {
  if (kW8) return shl(1u, ((code & 15u) - i0) * 8u) + shl(16u, ((code >> 4) - i0) * 8u);
  return shl(1u, (code - i0) * 8u);
}

// wgmma shared-memory descriptor, no swizzle, K-major: 8-row x 16-byte
// core matrices, `lbo` bytes apart along K and `sbo` bytes apart along N
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ int floordiv(int x, int d) {  // d > 0
  const int q = x / d;
  return (x % d != 0 && x < 0) ? q - 1 : q;
}

template <int BM, bool kW8>
__global__ void __launch_bounds__(Cfg<BM, kW8>::kThreads, Cfg<BM, kW8>::kMinBlocks)
lut_mma_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
               const int32_t* __restrict__ table, int32_t* __restrict__ out,
               int M, int K, int N, int k_chunk, int vec_a, int vec_b) {
  using C = Cfg<BM, kW8>;
  constexpr int kThreads = C::kThreads, kBN = C::kBN;
  constexpr int kAcc = BM / 2;  // accumulator registers a thread, a plane
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* s_act = smem;  // [2 buffers][planes][kPlaneBytes]
  int32_t* s_codes = reinterpret_cast<int32_t*>(smem + C::kActBytes);  // [stages][kStageWords]
  uint8_t* s_tab = smem + C::kActBytes + C::kStages * C::kStageWords * 4;  // [16 rows][8][16]

  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  // the thread's two output columns: wgmma rows g and g + 8 of its warp
  const int nloc = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + 2 * g;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * k_chunk;
  const int ke = min(K, kb + k_chunk);
  const int n_stages = (ke - kb + kBK - 1) / kBK;

  // thread e < 256 holds entry e of the table: W4A4 the table, W8A8 the
  // tile recovered from it; the widest entry sets the number of byte
  // planes, one pass each (n_bytes)
  static_assert(kThreads >= 256, "a thread an entry");
  const int tx = tid >> 4, ty = tid & 15;
  uint32_t entry = 0u;
  if (tid < 256) {
    if (kW8) {
      const int t00 = floordiv(table[0], 289);
      const int tx0 = floordiv(table[tx * 256] - 272 * t00, 17);
      const int t0y = floordiv(table[ty] - 272 * t00, 17);
      entry = static_cast<uint32_t>(table[tx * 256 + ty]) -
              16u * static_cast<uint32_t>(tx0 + t0y) - 256u * static_cast<uint32_t>(t00);
    } else {
      entry = static_cast<uint32_t>(table[tid]);
    }
  }
  const int n_bytes = 1 + (__syncthreads_or(entry > 0xFFu) != 0) +
                      (__syncthreads_or(entry > 0xFFFFu) != 0) +
                      (__syncthreads_or(entry > 0xFFFFFFu) != 0);

  auto load_stage = [&](int s) {  // start the copies of stage s's codes
    const int k0 = kb + s * kBK;
    const int32_t* st = s_codes + (s % C::kStages) * C::kStageWords;
    const uint32_t sa = smem_addr(st), sb = smem_addr(st + BM * C::kAStride);
    for (int c = tid; c < BM * (kBK / 4); c += kThreads) {
      const int r = c / (kBK / 4), q = (c % (kBK / 4)) * 4;
      const int m = m0 + r, k = k0 + q;
      const uint32_t dst = sa + (r * C::kAStride + q) * 4;
      if (vec_a) {
        const bool live = m < M && k < K;
        cp_async16(dst, live ? a + static_cast<size_t>(m) * K + k : a, live);
      } else {
        for (int e = 0; e < 4; ++e) {
          const bool live = m < M && k + e < K;
          cp_async4(dst + 4 * e, live ? a + static_cast<size_t>(m) * K + k + e : a, live);
        }
      }
    }
    for (int c = tid; c < kBK * (kBN / 4); c += kThreads) {
      const int r = c / (kBN / 4), q = (c % (kBN / 4)) * 4;
      const int k = k0 + r, n = n0 + q;
      const uint32_t dst = sb + (r * kBN + q) * 4;
      if (vec_b) {
        const bool live = k < K && n < N;
        cp_async16(dst, live ? b + static_cast<size_t>(k) * N + n : b, live);
      } else {
        for (int e = 0; e < 4; ++e) {
          const bool live = k < K && n + e < N;
          cp_async4(dst + 4 * e, live ? b + static_cast<size_t>(k) * N + n + e : b, live);
        }
      }
    }
  };

  // the expanded activation rows of stage s, into buffer `buf`: the 16
  // table bytes T[a, :] of each code, zero past the block's k range; a
  // thread takes four codes of one row, lanes 8 apart the same k
  auto build_act = [&](int s, int buf) {
    const int k0 = kb + s * kBK;
    const int32_t* sa = s_codes + (s % C::kStages) * C::kStageWords;
    uint8_t* dst = s_act + buf * C::kPlanes * C::kPlaneBytes;
    for (int c = tid; c < BM * (kBK / 4); c += kThreads) {
      const int mr = c & 7, kq = (c >> 3) % (kBK / 4), mg = (c >> 3) / (kBK / 4);
      const uint4 cw = *reinterpret_cast<const uint4*>(sa + (mg * 8 + mr) * C::kAStride + 4 * kq);
      const uint32_t codes[4] = {cw.x, cw.y, cw.z, cw.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * kq + j;
        const int off = (mg * kBK + k) * 128 + mr * 16;
        uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
        if (k0 + k < ke) {
          lo = *reinterpret_cast<const uint4*>(s_tab + ((codes[j] & 15u) * 8 + mr) * 16);
          if (kW8) {
            hi = *reinterpret_cast<const uint4*>(s_tab + (((codes[j] >> 4) & 15u) * 8 + mr) * 16);
          }
        }
        *reinterpret_cast<uint4*>(dst + off) = lo;
        if (kW8) *reinterpret_cast<uint4*>(dst + C::kPlaneBytes + off) = hi;
      }
    }
  };

  uint32_t acc[C::kPlanes][kAcc];
#pragma unroll
  for (int p = 0; p < C::kPlanes; ++p)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[p][i] = 0u;

  const uint32_t i0 = 4u * t;
  for (int byte = n_bytes - 1; byte >= 0; --byte) {
    // the table's byte `byte`, eight copies a row; every thread is past
    // the last pass's tile builds (the loop ends on a barrier)
    if (tid < 256) {
      const uint8_t v = static_cast<uint8_t>(entry >> (8 * byte));
#pragma unroll
      for (int q = 0; q < 8; ++q) s_tab[(tx * 8 + q) * 16 + ty] = v;
    }
    if (byte + 1 < n_bytes) {  // Horner: the passes so far weigh 256 more
#pragma unroll
      for (int p = 0; p < C::kPlanes; ++p)
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[p][i] <<= 8;
    }

#pragma unroll
    for (int s = 0; s < C::kStages - 1; ++s) {
      if (s < n_stages) load_stage(s);
      cp_async_commit();
    }
    cp_async_wait<C::kStages - 2>();
    __syncthreads();  // stage 0 and the table are in
    build_act(0, 0);
    fence_proxy_async();
    __syncthreads();

    for (int s = 0; s < n_stages; ++s) {
      if (s + C::kStages - 1 < n_stages) load_stage(s + C::kStages - 1);
      cp_async_commit();

      // the weight side of the stage's kBK / 2 k32 steps, in registers:
      // regs[j][0], [1] one-hot the thread's two columns at k = 2j, [2], [3]
      // at k = 2j + 1
      const int32_t* sb = s_codes + (s % C::kStages) * C::kStageWords + BM * C::kAStride;
      uint32_t regs[kBK / 2][4];
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j) {
        const uint2 c0 = *reinterpret_cast<const uint2*>(sb + (2 * j) * kBN + nloc);
        const uint2 c1 = *reinterpret_cast<const uint2*>(sb + (2 * j + 1) * kBN + nloc);
        regs[j][0] = onehot<kW8>(c0.x, i0);
        regs[j][1] = onehot<kW8>(c0.y, i0);
        regs[j][2] = onehot<kW8>(c1.x, i0);
        regs[j][3] = onehot<kW8>(c1.y, i0);
      }
      const uint32_t act = smem_addr(s_act + (s & 1) * C::kPlanes * C::kPlaneBytes);
#pragma unroll
      for (int p = 0; p < C::kPlanes; ++p) fence_regs(acc[p]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j)
#pragma unroll
        for (int p = 0; p < C::kPlanes; ++p)
          Wgmma<BM>::mma(acc[p], regs[j],
                         smem_desc(act + p * C::kPlaneBytes + j * 256, 128, kBK * 128));
      wgmma_commit();

      if (s + 1 < n_stages) {  // build stage s + 1 while the tensor cores run
        cp_async_wait<C::kStages - 2>();
        __syncthreads();
        build_act(s + 1, (s + 1) & 1);
        fence_proxy_async();
      }
      wgmma_wait_all();
#pragma unroll
      for (int p = 0; p < C::kPlanes; ++p) fence_regs(acc[p]);
      __syncthreads();  // buffer s & 1 and code slot s are free again
    }
    cp_async_wait<0>();  // the ring is empty for the next pass
  }

  // accumulator i holds wgmma row g + 8 ((i >> 1) & 1), that is column
  // n0 + nloc + ((i >> 1) & 1), and row m0 + 8 (i >> 2) + 2 t + (i & 1)
  const int n = n0 + nloc;
  const bool split = gridDim.z > 1, pair = n + 1 < N && (N & 1) == 0;
#pragma unroll
  for (int c = 0; c < BM / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * c + 2 * t + e;
      if (m >= M) continue;
      uint32_t v0 = acc[0][4 * c + e], v1 = acc[0][4 * c + 2 + e];
      if (kW8) {
        v0 += 16u * acc[C::kPlanes - 1][4 * c + e];
        v1 += 16u * acc[C::kPlanes - 1][4 * c + 2 + e];
      }
      uint32_t* row = reinterpret_cast<uint32_t*>(out) + static_cast<size_t>(m) * N;
      if (split) {
        if (n < N) atomicAdd(row + n, v0);
        if (n + 1 < N) atomicAdd(row + n + 1, v1);
      } else if (pair) {
        *reinterpret_cast<uint2*>(row + n) = make_uint2(v0, v1);
      } else {
        if (n < N) row[n] = v0;
        if (n + 1 < N) row[n + 1] = v1;
      }
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

// The split of K that fills the card's block slots best in whole waves,
// each further split costing a little (atomics, zeroing).  Returns the
// depth of a split, a multiple of kBK.
int split_depth(long tiles, long slots, int K) {
  int best_chunk = (K + kBK - 1) / kBK * kBK;
  double best = -1.0;
  const int max_splits = std::min(64, std::max(1, K / (4 * kBK)));
  for (int s = 1; s <= max_splits; ++s) {
    const int chunk = ((K + s - 1) / s + kBK - 1) / kBK * kBK;
    const int splits = (K + chunk - 1) / chunk;
    if (splits != s) continue;  // the same split as a smaller s
    const long blocks = tiles * splits;
    const long waves = (blocks + slots - 1) / slots;
    const double score = double(blocks) / double(waves * slots) - 0.01 * (splits - 1);
    if (score > best + 1e-9) {
      best = score;
      best_chunk = chunk;
    }
  }
  return best_chunk;
}

template <int BM, bool kW8>
int run(const int32_t* a, const int32_t* b, const int32_t* table, int32_t* out,
        int M, int K, int N, cudaStream_t stream) {
  using C = Cfg<BM, kW8>;
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(lut_mma_kernel<BM, kW8>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lut_mma_kernel<BM, kW8>,
                                                        C::kThreads, C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    per_sm = std::max(per_sm, 1);
  }
  const long tiles = static_cast<long>((M + BM - 1) / BM) * ((N + C::kBN - 1) / C::kBN);
  const int chunk = split_depth(tiles, static_cast<long>(per_sm) * sm_count(), K);
  const int splits = (K + chunk - 1) / chunk;
  if (splits > 1) {
    cudaMemsetAsync(out, 0, static_cast<size_t>(M) * N * sizeof(int32_t), stream);
  }
  const int vec_a = K % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const int vec_b = N % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const dim3 grid((N + C::kBN - 1) / C::kBN, (M + BM - 1) / BM, splits);
  lut_mma_kernel<BM, kW8><<<grid, C::kThreads, C::kSmem, stream>>>(
      a, b, table, out, M, K, N, chunk, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

template <bool kW8>
int launch(const int32_t* a, const int32_t* b, const int32_t* table,
           int32_t* out, int M, int K, int N, cudaStream_t stream) {
  if (M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  if (K == 0) {
    cudaMemsetAsync(out, 0, static_cast<size_t>(M) * N * sizeof(int32_t), stream);
    return static_cast<int>(cudaGetLastError());
  }
  if (M <= 8) return run<8, kW8>(a, b, table, out, M, K, N, stream);
  if (M <= 64) return run<64, kW8>(a, b, table, out, M, K, N, stream);
  return run<128, kW8>(a, b, table, out, M, K, N, stream);
}

}  // namespace

extern "C" {

// a (M, K), b (K, N) int32 codes in [0, 16); lut (16, 16) int32, one pass
// a byte of its widest entry; out (M, N).
int approx_matmul_w4(const void* a, const void* b, const void* lut, void* out,
                     int M, int K, int N, void* stream) {
  return launch<false>(static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
                       static_cast<const int32_t*>(lut), static_cast<int32_t*>(out),
                       M, K, N, static_cast<cudaStream_t>(stream));
}

// a (M, K), b (K, N) int32 codes in [0, 256); lut (256, 256) int32, composed
// from a (16, 16) tile, one pass a byte of the tile's widest entry;
// out (M, N).
int approx_matmul_w8(const void* a, const void* b, const void* lut, void* out,
                     int M, int K, int N, void* stream) {
  return launch<true>(static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
                      static_cast<const int32_t*>(lut), static_cast<int32_t*>(out),
                      M, K, N, static_cast<cudaStream_t>(stream));
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
