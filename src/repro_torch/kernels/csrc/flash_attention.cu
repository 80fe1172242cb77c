// Streaming-softmax (flash) attention for Hopper (sm_90a), head dims 64,
// 128 and 256.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::_kernel,
// reached from flash_attention_pallas.  Same semantics: causal, sliding
// window or non-causal; GQA by mapping query head h to kv head
// h / (H / Hkv) without repeating K and V; queries aligned to the end of
// the kv sequence (offs = Lk - Lq); running max, denominator and
// accumulator in f32; kv tiles that no row of a tile sees are skipped; a
// zero denominator gives 0 (a row that sees no key); output in q's dtype.
// Any Lq and Lk is taken: the ragged edges are masked, where Pallas
// asserted block multiples.
//
// bf16: the tensor cores.  On the TPU the grid walks k blocks in order
// and carries the softmax state in VMEM scratch.  Here one block owns one
// (batch * head, 128-query tile) and walks the 64-key tiles its rows can
// see, the tiles that see the most keys launched first.  Three
// warpgroups: one copies, two compute 64 query rows each (wgmma's M).
// One thread of the first copies with TMA: the Q tile once, then K and V
// tiles into a ring of stages, each stage's arrival counted on an
// mbarrier, and a stage is reused once both computing warpgroups have
// released it on a second mbarrier; the copying warpgroup hands most of
// its registers to the other two (setmaxnreg).  TMA writes every tile in
// wgmma's 128-byte swizzled layout, so K serves as B K-major for
// S = Q K^T and V as B MN-major (the descriptor's transpose bit) for
// O += P V: V is never transposed.  A computing warpgroup's step j issues
// S of tile j and P V of tile j - 1 (wgmma m64n64k16, f32 += bf16 x bf16)
// and runs tile j's online softmax while they multiply; the two
// warpgroups take turns at issuing (named barriers), so that one's
// softmax overlaps the other's products.  The softmax works on S's
// accumulator fragments (a thread holds two rows, and a row's max and sum
// reduce over the four lanes that share it, the sum only once at the
// end), in base 2 with scale * log2(e) folded in, and masks only tiles
// that cut the causal diagonal, a window's edge or the end of the keys.
// P is rounded to bf16 in registers, where S's accumulator layout is
// already the A-operand layout of the next product.  Rounding P departs
// from Pallas, which keeps P in f32; the result stays within the 2e-2
// bf16 tolerance.  A row that sees a single key gets p = 2^0 = 1, l = 1
// and O = v exactly: no rescale touches it by a factor other than 2^0.
// At the end a warpgroup writes its O rows, in bf16, into its rows of the
// Q tile and TMA stores them: coalesced, where stores from the
// accumulator fragments would write 16 bytes a row at a time.
//
// f32: the CUDA cores.  TF32 wgmma keeps about three decimal digits and
// would miss the 2e-5 f32 tolerance, so f32 runs the FMA kernel: one
// block owns one (batch * head, 64-query tile) and loops over 32-key
// tiles staged as f32 in shared memory; each of the 8 warps owns 8 query
// rows, lane j scores key j against them, and for P V each lane
// accumulates D / 32 of the output dims, taking p_j by shuffle.
//
// Bounds on the H100 (3.35 TB/s; 989 TFLOP/s bf16 tensor, 67 TFLOP/s f32
// CUDA cores): 4 D flops per (query, key) pair the mask leaves, against
// q, k, v read once and o written once.  At the qwen3-4b prefill shape
// (B 2, H 32, Hkv 8, L 512, D 128, causal) that is 4.3 GFLOP against
// 21 MB: bound by bytes in bf16 (0.0063 ms), by operations in f32
// (0.064 ms).  Measured there on an H100 SXM at 700 W, the bf16 kernel
// takes 0.018 ms alone (0.26 for the CUDA-core kernel it replaces) and
// the f32 one 0.275 ms: a block re-reads K and V from L2 for every 128
// query rows, the blocks run in two waves with their first loads
// exposed, and the softmax and bookkeeping around 64-key tiles, not the
// products, set the bf16 kernel's time.
#include <cuda.h>  // CUtensorMap; the encoder is found at run time, no driver library is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // a running max below every logit

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace bf16_tc {

constexpr int kBQ = 128;                  // query rows a block: two warpgroups of 64
constexpr int kBK = 64;                   // keys a kv tile
constexpr int kConsumers = 256;           // two warpgroups compute
constexpr int kThreads = kConsumers + 128;  // and one copies

template <int D>
struct Cfg {
  static constexpr int kStages = D == 256 ? 2 : 3;  // K, V tiles in flight or in use
  static constexpr int kTile = kBK * D * 2;         // bytes of one K or V tile
  static constexpr int kQ = kBQ * D * 2;
  // Q, the stages of K and V, their barriers (Q's, then full and empty
  // per stage), and room to align to 1024
  static constexpr int kSmem = kQ + kStages * 2 * kTile + 8 * (2 * kStages + 1) + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// named barrier `id` over `count` threads: wait for it, or only arrive
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// the one arrival of a phase, which then waits for `bytes` of copies
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; -inf gives 0, 0 gives 1
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// TMA: the box at (c0, c1, c2) of a 3-D tensor map into shared memory,
// counted on `bar`; rows past the tensor's edge arrive as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(bar)
      : "memory");
}

// TMA: shared memory to the box at (c0, c1, c2); rows past the tensor's
// edge are not written
__device__ __forceinline__ void tma_store(const CUtensorMap& map, int c0, int c1, int c2,
                                          uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n"
      :: "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(c2), "r"(src)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {  // shared-memory writes to TMA
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving register accesses across the
// asynchronous region
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: 8-row x 128-byte
// atoms; `sbo` bytes from one 8-row group to the next along the rows'
// other dimension, `lbo` from one atom to the next along the rows
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// d (64 x 64 f32) = (acc ? d : 0) + A B, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(acc));
}

// d (64 x 64 f32) += A B, A (64 x 16 bf16) from registers, B MN-major in
// shared memory (transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S (64 x 64 f32) = Q K^T of a warpgroup's rows, both K-major: a 16-deep
// step is 32 bytes on inside an atom, four of them the next atom; SBO
// 1024 (the next 8 rows).  Issued, not waited for.
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[32], uint32_t s_qw, uint32_t s_k) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss(s, smem_desc(s_qw + (kk / 4) * kBQ * 128 + (kk % 4) * 32, 16, 1024),
             smem_desc(s_k + (kk / 4) * kBK * 128 + (kk % 4) * 32, 16, 1024), kk);
  }
  wgmma_commit();
}

// O += P V, P (bf16) from registers, V MN-major: one atom of 64 head dims
// a product, SBO 1024 (the next 8 keys), 16 keys 2048 bytes on, the next
// atom 64 * 128.  Issued, not waited for.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 64][32], uint32_t (&pa)[4][4],
                                         uint32_t s_v) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
#pragma unroll
  for (int n = 0; n < D / 64; ++n) fence_regs(acc[n]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int n = 0; n < D / 64; ++n)
      wgmma_rs(acc[n], pa[kk], smem_desc(s_v + n * kBK * 128 + kk * 2048, kBK * 128, 1024));
  wgmma_commit();
}

// The thread's two rows of the online softmax state: running max m (base
// 2, scaled), and l, the sum over this thread's columns only
struct RowState {
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
};

// Softmax of one tile on S's fragments, in place: s[4 i + e] is row g
// (+8 for e >= 2) of the warp's 16, key k0 + 8 i + 2 t + (e & 1).  kMask
// (a tile on the causal diagonal, a window's edge or the end of the keys)
// sets the keys a row does not see to -inf.  A row's max reduces over the
// four lanes that share it.  Leaves p in s and returns the rows' rescale
// factors, exactly 1 where the max holds.
template <bool kMask>
__device__ __forceinline__ void softmax(float (&s)[32], RowState& st, float& c0, float& c1,
                                        float scale_log2, int k0, int t, int qpos0, int Lk,
                                        int causal, int window) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = s[i] * scale_log2;
    if (kMask) {
      const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      const int qpos = qpos0 + ((i & 2) ? 8 : 0);
      const bool ok = key < Lk && (!causal || key <= qpos) &&
                      (window <= 0 || key > qpos - window);
      x = ok ? x : __int_as_float(0xff800000);  // -inf: p = 0
    }
    s[i] = x;
  }
  // a row's maximum and sum over the thread's 16 keys of it, as four
  // interleaved partials: element i is row (i / 2) % 2, partial i % 2 +
  // 2 ((i / 4) % 2)
  float mx[2][4], sum[2][4] = {};
#pragma unroll
  for (int i = 0; i < 8; ++i) mx[(i / 2) % 2][i % 2 + 2 * (i / 4)] = s[i];
#pragma unroll
  for (int i = 8; i < 32; ++i) {
    float& m = mx[(i / 2) % 2][i % 2 + 2 * ((i / 4) % 2)];
    m = fmaxf(m, s[i]);
  }
  float mx0 = fmaxf(fmaxf(fmaxf(mx[0][0], mx[0][1]), fmaxf(mx[0][2], mx[0][3])), st.m0);
  float mx1 = fmaxf(fmaxf(fmaxf(mx[1][0], mx[1][1]), fmaxf(mx[1][2], mx[1][3])), st.m1);
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  c0 = ex2(st.m0 - mx0);
  c1 = ex2(st.m1 - mx1);
  st.m0 = mx0;
  st.m1 = mx1;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p = ex2(s[i] - ((i & 2) ? mx1 : mx0));
    s[i] = p;
    sum[(i / 2) % 2][i % 2 + 2 * ((i / 4) % 2)] += p;
  }
  st.l0 = st.l0 * c0 + ((sum[0][0] + sum[0][1]) + (sum[0][2] + sum[0][3]));
  st.l1 = st.l1 * c1 + ((sum[1][0] + sum[1][1]) + (sum[1][2] + sum[1][3]));
}

// P in bf16: the fragments of keys 16 kk ... 16 kk + 15 are s[8 kk ...
// 8 kk + 7], already in the A-operand order of m64nNk16
__device__ __forceinline__ void pack_p(const float (&s)[32], uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 64][32], float c0, float c1) {
#pragma unroll
  for (int n = 0; n < D / 64; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] *= (i & 2) ? c1 : c0;
}

__device__ __forceinline__ int floordiv(int x, int d) {  // d > 0
  return x >= 0 ? x / d : -((-x + d - 1) / d);
}

// The key tiles [lo, hi) that query rows q_lo ... q_hi (aligned to the
// end of the keys) can see, within [j_beg, j_end)
__device__ __forceinline__ void seen_tiles(int q_lo, int q_hi, int causal, int window,
                                           int j_beg, int j_end, int& lo, int& hi) {
  hi = causal ? min(j_end, q_hi < 0 ? 0 : q_hi / kBK + 1) : j_end;
  lo = window > 0 ? max(j_beg, floordiv(q_lo - window + 1, kBK)) : j_beg;
  if (q_hi < q_lo || hi < lo) hi = lo;
}

// The two warpgroups take turns at issuing their products (named
// barriers 1 and 2), so that one's softmax runs while the other's
// products run.  Each takes `turns` turns, one a kv tile of the block and
// one more, whether it has products to issue in it or not; warpgroup 0
// starts without waiting and warpgroup 1 does not hand over after its last.
struct Turns {
  int wg, turns, i = 0;
  __device__ __forceinline__ void begin() const {
    if (wg == 1 || i > 0) bar_sync(1 + wg, kConsumers);
  }
  __device__ __forceinline__ void end() {
    if (wg == 0 || i < turns - 1) bar_arrive(2 - wg, kConsumers);
    ++i;
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                  int H, int Hkv, int Lq, int Lk, float scale_log2, int causal, int window) {
  using C = Cfg<D>;
  constexpr int kN = D / 64;  // 64-wide column blocks of O
  constexpr int S = C::kStages;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s_q = (smem_addr(smem) + 1023) & ~1023u;  // swizzle atoms need 1024
  const uint32_t s_kv = s_q + C::kQ;  // stage s: K at s_kv + 2 s kTile, V after it
  const uint32_t bar_q = s_kv + S * 2 * C::kTile;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * S;  // + 8 s for stage s

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // the last, longest tiles first
  const int offs = Lk - Lq;
  const int rows = min(kBQ, Lq - q0);
  const int tid = threadIdx.x;

  // the key tiles any row of the block can see
  const int q_lo = q0 + offs, q_hi = q0 + rows - 1 + offs;
  const int k_end = causal ? min(Lk, q_hi + 1) : Lk;
  const int k_beg = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int j_beg = k_beg / kBK;
  const int j_end = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The producer warpgroup gives up registers to the two that compute;
  // one thread copies with TMA: Q once, then tile j into stage
  // (j - j_beg) % S once both warpgroups have released the tile that
  // stage held, its arrival counted on the stage's full barrier.  A box
  // is the 64 head dims of one swizzle atom, which TMA writes in wgmma's
  // 128-byte swizzled layout.
  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers && j_beg < j_end) {
      mbar_expect(bar_q, C::kQ);
#pragma unroll
      for (int a = 0; a < D / 64; ++a)
        tma_load(s_q + a * kBQ * 128, tm_q, a * 64, q0, bh, bar_q);
      for (int j = j_beg; j < j_end; ++j) {
        const int st = (j - j_beg) % S, use = (j - j_beg) / S;
        if (use > 0) mbar_wait(bar_empty + 8 * st, (use - 1) & 1);
        const uint32_t full = bar_full + 8 * st, dst = s_kv + st * 2 * C::kTile;
        mbar_expect(full, 2 * C::kTile);
#pragma unroll
        for (int a = 0; a < D / 64; ++a) {
          tma_load(dst + a * kBK * 128, tm_k, a * 64, j * kBK, b * Hkv + hk, full);
          tma_load(dst + C::kTile + a * kBK * 128, tm_v, a * 64, j * kBK, b * Hkv + hk, full);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // this warpgroup's rows, the thread's first (the second is 8 on), and
  // the tiles [lo, hi) they see
  const int w_rows = min(64, rows - wg * 64);
  const int wq_lo = q_lo + wg * 64, wq_hi = wq_lo + w_rows - 1;
  const int qpos0 = wq_lo + warp * 16 + g;
  const uint32_t s_qw = s_q + wg * 64 * 128;  // this warpgroup's rows of each atom
  int lo, hi;
  seen_tiles(wq_lo, wq_hi, causal, window, j_beg, j_end, lo, hi);
  Turns turn{wg, j_end - j_beg + 1};

  auto full = [&](int j) {
    mbar_wait(bar_full + 8 * ((j - j_beg) % S), ((j - j_beg) / S) & 1);
  };
  auto release = [&](int j) { mbar_arrive(bar_empty + 8 * ((j - j_beg) % S)); };
  auto k_at = [&](int j) { return s_kv + ((j - j_beg) % S) * 2 * C::kTile; };
  auto edge = [&](int j) {
    const int k0 = j * kBK;
    return k0 + kBK > Lk || (causal && k0 + kBK - 1 > wq_lo) ||
           (window > 0 && k0 <= wq_hi - window);
  };
  auto soft = [&](float (&s)[32], RowState& st, float& c0, float& c1, int j) {
    if (edge(j))
      softmax<true>(s, st, c0, c1, scale_log2, j * kBK, t, qpos0, Lk, causal, window);
    else
      softmax<false>(s, st, c0, c1, scale_log2, j * kBK, t, qpos0, Lk, causal, window);
  };

  float acc[kN][32];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
  RowState st;

  auto pass = [&](int j) {  // a tile this warpgroup does not see
    full(j);
    turn.begin();
    turn.end();
    release(j);
  };

  // the turns: S of tile lo; S of tile j with P V of tile j - 1; P V of
  // tile hi - 1; and an empty turn for every tile not seen
  for (int j = j_beg; j < lo; ++j) pass(j);
  if (lo < hi) {
    mbar_wait(bar_q, 0);
    float s[32], c0, c1;
    uint32_t pa[4][4];
    full(lo);
    turn.begin();
    issue_s<D>(s, s_qw, k_at(lo));
    turn.end();
    wgmma_wait<0>();
    fence_regs(s);
    soft(s, st, c0, c1, lo);
    pack_p(s, pa);
    // step j: S of tile j and P V of tile j - 1 multiply while tile j's
    // softmax runs; then tile j - 1 is released and O rescaled
    for (int j = lo + 1; j < hi; ++j) {
      full(j);
      turn.begin();
      issue_s<D>(s, s_qw, k_at(j));
      issue_pv<D>(acc, pa, k_at(j - 1) + C::kTile);
      turn.end();
      wgmma_wait<1>();
      fence_regs(s);
      soft(s, st, c0, c1, j);
      wgmma_wait<0>();
#pragma unroll
      for (int n = 0; n < kN; ++n) fence_regs(acc[n]);
      release(j - 1);
      rescale<D>(acc, c0, c1);
      pack_p(s, pa);
    }
    turn.begin();
    issue_pv<D>(acc, pa, k_at(hi - 1) + C::kTile);
    turn.end();
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < kN; ++n) fence_regs(acc[n]);
    release(hi - 1);
  } else {
    turn.begin();
    turn.end();
  }
  for (int j = hi; j < j_end; ++j) pass(j);

  // the row sums over the four lanes of a row; a zero sum (no key) gives 0
  float l0 = st.l0, l1 = st.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / (l0 > 0.f ? l0 : 1.f), inv1 = 1.f / (l1 > 0.f ? l1 : 1.f);
  if (w_rows <= 0) return;
  // O goes out through this warpgroup's rows of the Q tile, in the same
  // swizzled layout (its products are done with them), and TMA stores
  // them: row r's columns 8 i + 2 t, + 1 of atom n at chunk i ^ (r % 8)
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const uint32_t atom = s_qw + n * kBQ * 128;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t a0 = atom + r0 * 128 + ((i ^ (r0 % 8)) << 4) + 4 * t;
      asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(a0),
                   "r"(pack_bf16(acc[n][4 * i] * inv0, acc[n][4 * i + 1] * inv0)) : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(a0 + 8 * 128),
                   "r"(pack_bf16(acc[n][4 * i + 2] * inv1, acc[n][4 * i + 3] * inv1)) : "memory");
    }
  }
  fence_proxy_async();
  bar_sync(3 + wg, 128);  // the warpgroup's rows are all written
  if (tid % 128 == 0) {
#pragma unroll
    for (int n = 0; n < kN; ++n) tma_store(tm_o, n * 64, q0 + wg * 64, bh, s_qw + n * kBQ * 128);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // before the block ends
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's tensor-map encoder, from the runtime (no link to libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (slices, rows, D) bf16 as a 3-D tensor map of (64 head dims, box_rows, 1)
// boxes, 128-byte swizzled; rows past `rows` read as zeros
template <int D>
bool tensor_map(CUtensorMap* map, EncodeTiled encode, const void* base, int rows, int slices,
                int box_rows) {
  const cuuint64_t dims[3] = {D, static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(slices)};
  const cuuint64_t strides[2] = {D * 2, static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
           int Lq, int Lk, float scale, int causal, int window, cudaStream_t stream) {
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const EncodeTiled encode = encoder();
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (encode == nullptr || !tensor_map<D>(&tm_q, encode, q, Lq, B * H, kBQ) ||
      !tensor_map<D>(&tm_k, encode, k, Lk, B * Hkv, kBK) ||
      !tensor_map<D>(&tm_v, encode, v, Lk, B * Hkv, kBK) ||
      !tensor_map<D>(&tm_o, encode, o, Lq, B * H, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * H, (Lq + kBQ - 1) / kBQ);
  flash_bf16_kernel<D><<<grid, kThreads, Cfg<D>::kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_o, H, Hkv, Lq, Lk,
      scale * 1.4426950408889634f, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bf16_tc

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------
namespace f32_fma {

constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 32;             // keys per staged tile (one per lane)
constexpr int kWarps = 8;
constexpr int kRPW = kBQ / kWarps;  // query rows per warp
constexpr int kThreads = kWarps * 32;

template <int D>
struct Cfg {
  static constexpr int kKPad = D + 4;  // K rows padded: lane-strided float4 reads hit distinct banks
  static constexpr int kC = D / 32;    // output dims a lane, contiguous
  static constexpr int kSmem = (kBQ * D + kBK * kKPad + kBK * D) * sizeof(float);
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H, int Hkv,
                 int Lq, int Lk, float scale, int causal, int window) {
  using C = Cfg<D>;
  constexpr int kC = C::kC;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                  // (kBQ, D)
  float* sk = sq + kBQ * D;          // (kBK, kKPad)
  float* sv = sk + kBK * C::kKPad;   // (kBK, D)

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * kBQ;
  const int offs = Lk - Lq;
  const float* qp = q + (static_cast<size_t>(bh) * Lq + q0) * D;
  const float* kp = k + static_cast<size_t>(b * Hkv + hk) * Lk * D;
  const float* vp = v + static_cast<size_t>(b * Hkv + hk) * Lk * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = min(kBQ, Lq - q0);

  for (int i = tid; i < kBQ * D; i += kThreads) sq[i] = i / D < rows ? qp[i] : 0.f;

  // the key range any row of this tile can see
  const int q_lo = q0 + offs, q_hi = q0 + rows - 1 + offs;
  const int k_end = causal ? min(Lk, q_hi + 1) : Lk;
  int k_beg = window > 0 ? max(0, q_lo - window + 1) : 0;
  k_beg -= k_beg % kBK;

  float m[kRPW], l[kRPW], acc[kRPW][kC];
#pragma unroll
  for (int i = 0; i < kRPW; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_beg; k0 < k_end; k0 += kBK) {
    __syncthreads();  // previous tile consumed (first pass: q staged)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const bool in = k0 + j < Lk;
      const size_t gi = static_cast<size_t>(k0 + j) * D + d;
      sk[j * C::kKPad + d] = in ? kp[gi] : 0.f;
      sv[i] = in ? vp[gi] : 0.f;
    }
    __syncthreads();

    float s[kRPW];
#pragma unroll
    for (int i = 0; i < kRPW; ++i) s[i] = 0.f;
    const float* kr = sk + lane * C::kKPad;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int i = 0; i < kRPW; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(sq + (warp * kRPW + i) * D + d);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }

    const int kpos = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRPW; ++i) {
      const int qpos = q0 + warp * kRPW + i + offs;
      const bool ok = kpos < Lk && (!causal || kpos <= qpos) &&
                      (window <= 0 || kpos > qpos - window);
      const float x = ok ? s[i] * scale : kNeg;
      const float m_new = fmaxf(m[i], warp_max(x));
      const float p = ok ? expf(x - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[i][c] *= corr;
      s[i] = p;
    }

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[kC];
      const float* vr = sv + j * D + lane * kC;
      if constexpr (kC == 2) {
        const float2 x = *reinterpret_cast<const float2*>(vr);
        vv[0] = x.x;
        vv[1] = x.y;
      } else {
#pragma unroll
        for (int c = 0; c < kC; c += 4) {
          const float4 x = *reinterpret_cast<const float4*>(vr + c);
          vv[c] = x.x;
          vv[c + 1] = x.y;
          vv[c + 2] = x.z;
          vv[c + 3] = x.w;
        }
      }
#pragma unroll
      for (int i = 0; i < kRPW; ++i) {
        const float p = __shfl_sync(0xffffffffu, s[i], j);
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRPW; ++i) {
    const int r = warp * kRPW + i;
    if (r >= rows) break;
    const float denom = l[i] > 0.f ? l[i] : 1.f;
    float* op = o + (static_cast<size_t>(bh) * Lq + q0 + r) * D + lane * kC;
#pragma unroll
    for (int c = 0; c < kC; ++c) op[c] = acc[i][c] / denom;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
           int Lq, int Lk, float scale, int causal, int window, cudaStream_t stream) {
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid(B * H, (Lq + kBQ - 1) / kBQ);
  flash_f32_kernel<D><<<grid, kThreads, Cfg<D>::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, Hkv, Lq, Lk, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32_fma

constexpr int kHeadDims[] = {64, 128, 256};

// the launch of namespace NS for head dim D; an untaken D is refused
#define FLASH_DISPATCH(NS)                                                            \
  if (B * H == 0 || Lq == 0) return static_cast<int>(cudaGetLastError());           \
  cudaStream_t st = static_cast<cudaStream_t>(stream);                                \
  switch (D) {                                                                        \
    case 64: return NS::launch<64>(q, k, v, o, B, H, Hkv, Lq, Lk, scale, causal, window, st);   \
    case 128: return NS::launch<128>(q, k, v, o, B, H, Hkv, Lq, Lk, scale, causal, window, st); \
    case 256: return NS::launch<256>(q, k, v, o, B, H, Hkv, Lq, Lk, scale, causal, window, st); \
    default: return static_cast<int>(cudaErrorInvalidValue);                          \
  }

}  // namespace

extern "C" {

// q (B, H, Lq, D), k/v (B, Hkv, Lk, D), o like q; D one of
// flash_attention_head_dims; window <= 0 = none.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int Hkv, int Lq, int Lk, int D, float scale, int causal, int window,
                        void* stream) {
  FLASH_DISPATCH(f32_fma)
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B, int H,
                         int Hkv, int Lq, int Lk, int D, float scale, int causal, int window,
                         void* stream) {
  FLASH_DISPATCH(bf16_tc)
}

// the head dims the kernels take: writes up to n of them, returns how many
int flash_attention_head_dims(int* dims, int n) {
  const int count = sizeof(kHeadDims) / sizeof(kHeadDims[0]);
  for (int i = 0; i < count && i < n; ++i) dims[i] = kHeadDims[i];
  return count;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
