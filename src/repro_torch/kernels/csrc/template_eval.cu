// Population scoring of SHARED-template candidates for Hopper (sm_90a).
//
// Replaces the Pallas _kernel of repro/kernels/template_eval.py:30
// (reached from template_eval_pallas).  For each candidate p:
//   prod[t] = AND_j lit(p, t, j)   with lit = tt[j] (USE, 0), ~tt[j] (NEG, 1)
//                                   or all-ones (any other value: IGNORE)
//   out[o]  = OR_t prod[t] where sel[p, o, t] != 0
//   val(s)  = sum_o bit_s(out[o]) << o,   err(s) = |val(s) - exact[s]|
//   wce[p]  = max_s err(s),   esum[p] = sum_s err(s)   (int32, s < S)
// Input assignments are bit-packed, 32 per uint32 word, W = ceil(S / 32)
// words per truth table.  ref.template_eval_bitsliced is this kernel's
// arithmetic in plain PyTorch, step for step.
//
// Bound on the H100.  The bytes are the parameter rows, T*n + m*T int32 a
// candidate (1 KB at mul_i8, T = 16), read once, and two int32 results.
// The operations, per (candidate, word): one AND per literal of a product
// some output selects, one OR per selected (output, product), and about
// 10*(m + 1) word ops for the error of 32 lanes at once in bit-sliced
// form.  At the search's populations (512 to 65,536 candidates) the bytes
// bound it (chip_smoke.template_eval_bound), with the int32 rate close
// behind at large P.
//
// Design, part by part:
// - Parameters staged once.  A block walks slabs of C candidates (a
//   persistent grid of two blocks an SM; at small P one slab a block,
//   C = P / blocks); each slab's lits and sel rows are contiguous and
//   arrive in shared memory by 16-byte cp.async copies into a ring of two
//   slabs, so the copy of the next slab overlaps the work on this one.
//   Each slab is compressed there once per candidate, not once per word:
//   a product becomes a key, one base-3 code byte per group of four
//   inputs (USE 0, NEG 1, other 2; four literals a 16-byte read when
//   n % 4 = 0), one key word per 16 inputs, and the mask of the outputs
//   that select it; a product no output selects is dropped, the others
//   are listed per candidate, one shared atomic per candidate a warp.
// - Truth tables and exact values staged once per block.  Their loads go
//   out before the first slab's copies; the tables are built after the
//   first slab is compressed, while the latency is already paid.  A table
//   per (word, group of four inputs) holds the AND of the literals of
//   each of the 81 codes, so a product costs one table read and one AND a
//   group, not one literal decode per input (groups past n hold all-ones
//   at the key's IGNORE code).  The exact values become 32 bit planes a
//   word (__ballot_sync of bit b over the word's 32 lanes).
// - Three kernels by the number of inputs: n <= 8 reads two groups of
//   one key word, n <= 16 four, both with a compile-time list layout
//   (one 8-byte entry a product); n > 16 loops over its key words, four
//   groups each.  A runtime key loop everywhere, or four groups where two
//   do, measured slower on the H100 (tools/time_kernel.py ablations;
//   PERF.md section 6).
// - Bit-sliced error.  The m output words, built by predicated ORs (R2P),
//   are the value's bit planes; the exact planes are subtracted by a
//   borrow ripple, the result negated where the sign plane is set (XOR,
//   ripple +1), lanes at or past S cleared, the max taken by a scan from
//   the top plane and the sum as popcounts weighted by plane.  A word
//   whose exact values all lie in [0, 2^kMaxM) takes kMaxM + 1 planes,
//   any other 32 planes: int32 wraparound as in the reference, where
//   |INT_MIN| stays INT_MIN and loses every max (32 planes everywhere
//   measured slower on the H100: the same ablations).
// - G neighbouring lanes share a candidate, one word each, and finish its
//   max and sum with shuffles; the tables and planes are staged a chunk
//   of words at a time, 32 words over the key words (a power of two), and
//   G = min(chunk, pow2 >= W); so n runs to 16 * 32 = 512 inputs.
// What is left, on the H100 (PERF.md section 6): at large P the integer
// work of compress and compute runs beside the copies but not under them;
// at the search's own P a block takes one slab, so the first copy's
// latency, compress and compute follow one another.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 2;
constexpr int kStages = 2;           // slabs in flight in the ring
constexpr int kChunk = 32;           // words staged at once, times key words
constexpr int kCodes = 81;           // 3^4 codes of a group of four inputs
constexpr int kPlaneStride = 33;     // words a word's planes take, bank skew
constexpr int kSmemBudget = 110 * 1024;  // per block, two blocks an SM
constexpr int kMaxDevices = 64;
// a key byte of 80 = 2 + 2*3 + 2*9 + 2*27: four IGNOREs
constexpr uint32_t kIgnoreKey = 0x50505050u;
// byte q of this word is 3^q
constexpr uint32_t kPow3 = 0x1B090301u;

struct Shape {
  int P, T, n, m, W, S;
  int kw;         // key words a product: one per 16 inputs
  int groups;     // tables a word: 2 (n <= 8), else four per key word
  int G;          // lanes a candidate, one word each
  int chunk;      // words staged at once
  int C;          // candidates a slab
  int nslabs;
  int lits_cap;   // words of a slab's lits region, a multiple of four
  int sel_cap;
  int mask_stride;  // entries (kw key words, then the output mask) a
                    // candidate's product list takes
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const int32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying count words from src to dst (16-byte aligned): 16-byte
// copies where src is 16-byte aligned too (then a 4-byte tail), else
// 4-byte copies, so that the data always starts at dst.
__device__ void copy_async(uint32_t* dst, const int32_t* src, int count) {
  const int body = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? count >> 2 : 0;
  for (int i = threadIdx.x; i < body; i += kThreads) cp_async16(dst + 4 * i, src + 4 * i);
  for (int i = 4 * body + threadIdx.x; i < count; i += kThreads) cp_async4(dst + i, src + i);
}

__device__ __forceinline__ void start_copy(const Shape& s, const int32_t* lits,
                                           const int32_t* sel, uint32_t* raw, int slab) {
  const int c0 = slab * s.C;
  const int cs = min(s.C, s.P - c0);
  copy_async(raw, lits + static_cast<size_t>(c0) * s.T * s.n, cs * s.T * s.n);
  copy_async(raw + s.lits_cap, sel + static_cast<size_t>(c0) * s.m * s.T, cs * s.m * s.T);
}

// A chunk's truth-table words and exact values, loaded into registers
// first, so that the loads go out ahead of a slab's copies.
constexpr int kTTLoads = 16 * kChunk / kThreads;  // n * chunk <= 16 * kw * chunk
constexpr int kEvLoads = 32 * kChunk / kThreads;
static_assert(kTTLoads * kThreads == 16 * kChunk && kEvLoads * kThreads == 32 * kChunk,
              "a chunk's words spread evenly over the threads");

struct Staged {
  uint32_t tt[kTTLoads];
  uint32_t ev[kEvLoads];
};

__device__ __forceinline__ Staged load_words(const Shape& s, const uint32_t* __restrict__ tt,
                                             const int32_t* __restrict__ ev, int w0) {
  const int words = min(s.chunk, s.W - w0);
  Staged st;
#pragma unroll
  for (int k = 0; k < kTTLoads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int j = i / words;
    st.tt[k] = i < s.n * words ? tt[static_cast<size_t>(j) * s.W + w0 + (i - j * words)] : 0u;
  }
#pragma unroll
  for (int k = 0; k < kEvLoads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const long long idx = 32LL * w0 + i;
    st.ev[k] = i < 32 * words && idx < s.S ? static_cast<uint32_t>(ev[idx]) : 0u;
  }
  return st;
}

// The loaded words into shared memory: the chunk's truth-table words
// (n, words) and exact values (words, 32).
__device__ __forceinline__ void store_words(const Shape& s, const Staged& st, int w0,
                                            uint32_t* scratch) {
  const int words = min(s.chunk, s.W - w0);
#pragma unroll
  for (int k = 0; k < kTTLoads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < s.n * words) scratch[i] = st.tt[k];
  }
#pragma unroll
  for (int k = 0; k < kEvLoads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < 32 * words) scratch[s.n * s.chunk + i] = st.ev[k];
  }
}

// A literal's term of word x for digit d: USE x, NEG ~x, IGNORE all-ones.
__device__ __forceinline__ uint32_t term(uint32_t x, int d) {
  return d == 0 ? x : (d == 1 ? ~x : 0xffffffffu);
}

// Tables and exact planes of the chunk of words from w0 (those below W),
// from the stored words.  A group's 81 codes are a + 9b, a and b the codes
// of its two pairs of inputs; a thread takes one b and writes its nine
// entries.  Plane 32 of a word is nonzero where some exact value of it
// has a bit at or past kMaxM, so that the word needs all 32 planes.
template <int kMaxM, int kGroups>
__device__ void build_words(const Shape& s, int w0, const uint32_t* scratch,
                            uint32_t* tables, uint32_t* planes) {
  const int words = min(s.chunk, s.W - w0);
  const int groups = kGroups != 0 ? kGroups : s.groups;
  const uint32_t* ttw = scratch;                  // (n, words)
  const uint32_t* evw = scratch + s.n * s.chunk;  // (words, 32)
  for (int e = threadIdx.x; e < words * groups * 9; e += kThreads) {
    const int wl = e / (groups * 9);
    const int r = e - wl * (groups * 9);
    const int grp = r / 9;
    const int b = r - grp * 9;
    uint32_t x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // an input past n only meets codes that ignore it
      const int j = 4 * grp + q;
      const uint32_t v = ttw[min(j, s.n - 1) * words + wl];
      x[q] = j < s.n ? v : 0u;
    }
    const uint32_t hi = term(x[2], b % 3) & term(x[3], b / 3);
    uint32_t* out = tables + (wl * groups + grp) * kCodes + 9 * b;
#pragma unroll
    for (int a = 0; a < 9; ++a) out[a] = term(x[0], a % 3) & term(x[1], a / 3) & hi;
  }
  const int lane = threadIdx.x & 31;
  for (int wl = threadIdx.x >> 5; wl < words; wl += kThreads / 32) {
    const uint32_t e = evw[32 * wl + lane];
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const uint32_t plane = __ballot_sync(0xffffffffu, (e >> b) & 1u);
      if (lane == b) planes[wl * kPlaneStride + b] = plane;
    }
    const uint32_t wide = __ballot_sync(0xffffffffu, kMaxM < 32 && (e >> (kMaxM & 31)) != 0u);
    if (lane == 0) planes[wl * kPlaneStride + 32] = kMaxM < 32 ? wide : 1u;
  }
}

// A literal's base-3 digit: USE (0) 0, NEG (1) 1, anything else 2.
__device__ __forceinline__ uint32_t digit(int32_t lit) {
  return min(static_cast<uint32_t>(lit), 2u);
}

// Key word i of a product: the codes of inputs 16 i to 16 i + 15 of its
// row of n literals (item is the product's index in the slab).
__device__ __forceinline__ uint32_t key_word(const int32_t* row, int n, int i, int item) {
  const int cnt = min(16, n - 16 * i);
  row += 16 * i;
  uint32_t key = kIgnoreKey;
  if ((n & 3) == 0) {
    // the row is 16-byte aligned: a group's four literals in one load
    const int4* row4 = reinterpret_cast<const int4*>(row);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 v = row4[min(q, (cnt >> 2) - 1)];  // loads not behind a branch
      const uint32_t code = digit(v.x) + 3u * digit(v.y) + 9u * digit(v.z) + 27u * digit(v.w);
      if (4 * q < cnt) key = (key & ~(0xffu << (8 * q))) | (code << (8 * q));
    }
  } else {
    // rows n words apart: each lane starts at its own column, so that a
    // warp's reads fall in distinct banks; a key byte counts down from
    // four IGNOREs
    const int j0 = ((item & 31) * cnt) >> 5;
    for (int k = 0; k < cnt; ++k) {
      const int j = k + j0 < cnt ? k + j0 : k + j0 - cnt;
      key -= (2u - digit(row[j])) * (((kPow3 >> (8 * (j & 3))) & 0xffu) << (8 * (j >> 2)));
    }
  }
  return key;
}

// One slab's rows to per-candidate lists of (key words, output mask) of
// the products some output selects, in no particular order (OR commutes).
// kGroups 2 or 4: one key word, an 8-byte entry; 0: kw + 1 words.
template <int kMaxM, int kGroups>
__device__ void compress(const Shape& s, const uint32_t* raw, int slab, uint32_t* list,
                         int* count) {
  const int cs = min(s.C, s.P - slab * s.C);
  const int32_t* L = reinterpret_cast<const int32_t*>(raw);
  const int32_t* Sl = L + s.lits_cap;
  const int T = s.T, m = s.m;
  const int lane = threadIdx.x & 31;
  // every lane of a warp takes part in every round, for the warp's votes
  for (int first = 0; first < cs * T; first += kThreads) {
    const int item = first + threadIdx.x;
    const bool live = item < cs * T;
    const int c = live ? item / T : -1;
    const int t = item - c * T;
    const int32_t* row = L + (live ? item : 0) * s.n;
    // the first key word's loads go out beside the selections'
    const uint32_t key0 = live ? key_word(row, s.n, 0, item) : 0u;
    uint32_t feeds = 0u;
    const int32_t* column = Sl + (live ? c * m * T + t : 0);
#pragma unroll
    for (int k = 0; k < kMaxM; ++k) {
      const int o = (k + c) & (kMaxM - 1);  // rotated by candidate: other banks
      const int32_t v = column[(o < m ? o : 0) * T];  // loads not behind a branch
      if (live && o < m && v != 0) feeds |= 1u << o;
    }
    // one shared atomic per candidate a warp: the first lane of each
    // candidate's run reserves room for the run's selected products
    const uint32_t kept = __ballot_sync(0xffffffffu, feeds != 0u);
    const uint32_t run = __match_any_sync(0xffffffffu, c);
    const int leader = __ffs(run) - 1;
    int at = 0;
    if (lane == leader && (run & kept) != 0u) at = atomicAdd(&count[c], __popc(run & kept));
    at = __shfl_sync(0xffffffffu, at, leader);
    if (feeds != 0u) {
      const int pos = at + __popc(run & kept & ((1u << lane) - 1u));
      if constexpr (kGroups != 0) {
        reinterpret_cast<uint2*>(list)[c * s.mask_stride + pos] = make_uint2(key0, feeds);
      } else {
        uint32_t* entry = list + (c * s.mask_stride + pos) * (s.kw + 1);
        entry[0] = key0;
        for (int i = 1; i < s.kw; ++i) entry[i] = key_word(row, s.n, i, item);
        entry[s.kw] = feeds;
      }
    }
  }
}

// out |= prod where bit is set in mask, as a predicated OR.
__device__ __forceinline__ void or_where(uint32_t& out, uint32_t mask, uint32_t bit,
                                         uint32_t prod) {
  asm("{\n\t.reg .pred p;\n\t.reg .b32 t;\n\tand.b32 t, %1, %2;\n\t"
      "setp.ne.b32 p, t, 0;\n\t@p or.b32 %0, %0, %3;\n\t}\n"
      : "+r"(out)
      : "r"(mask), "r"(bit), "r"(prod));
}

// Max and sum of |val - exact| over one word's 32 lanes, bit-sliced over
// kP planes.  The max is INT_MIN where no lane is valid or every valid
// lane's |err| is INT_MIN (it loses to every other err, as in the
// reference's signed max); the sum is mod 2^32.
template <int kP, int kMaxM>
__device__ __forceinline__ void word_error(const uint32_t (&outs)[kMaxM],
                                           const uint32_t* planes, uint32_t valid,
                                           int32_t& wmax, uint32_t& wsum) {
  uint32_t d[kP];
  uint32_t borrow = 0u;
#pragma unroll
  for (int b = 0; b < kP; ++b) {
    const uint32_t v = b < kMaxM ? outs[b] : 0u;
    const uint32_t e = planes[b];
    d[b] = v ^ e ^ borrow;
    borrow = (~v & (e | borrow)) | (e & borrow);
  }
  const uint32_t neg = d[kP - 1];
  uint32_t carry = neg;
  uint32_t sum = 0u;
#pragma unroll
  for (int b = 0; b < kP; ++b) {
    const uint32_t x = d[b] ^ neg;
    d[b] = (x ^ carry) & valid;
    carry &= x;
    sum += static_cast<uint32_t>(__popc(d[b])) << b;
  }
  const uint32_t lanes = valid & ~d[kP - 1];
  uint32_t cand = lanes;
  uint32_t r = 0u;
#pragma unroll
  for (int b = kP - 2; b >= 0; --b) {
    const uint32_t hit = cand & d[b];
    r |= hit != 0u ? 1u << b : 0u;
    cand = hit != 0u ? hit : cand;
  }
  wmax = lanes != 0u ? static_cast<int32_t>(r) : INT_MIN;
  wsum = sum;
}

template <int kMaxM, int kGroups>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
template_eval_kernel(const int32_t* __restrict__ lits,  // (P, T, n)
                     const int32_t* __restrict__ sel,   // (P, m, T)
                     const uint32_t* __restrict__ tt,   // (n, W)
                     const int32_t* __restrict__ ev,    // (S,)
                     int32_t* __restrict__ wce_out,     // (P,)
                     int32_t* __restrict__ esum_out,    // (P,)
                     const Shape s) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int raw_words = s.lits_cap + s.sel_cap;
  // two list and count buffers, a slab's and the next one's (one list
  // buffer would be safe behind the barrier after a copy lands, but
  // measured slower on the H100 at large P: the same ablations)
  uint32_t* raw = smem;                                    // kStages slabs
  uint32_t* lists = raw + kStages * raw_words;
  int* counts = reinterpret_cast<int*>(lists + 2 * s.C * s.mask_stride * (s.kw + 1));
  uint32_t* tables = reinterpret_cast<uint32_t*>(counts + 2 * s.C);
  uint32_t* planes = tables + s.chunk * s.groups * kCodes;
  uint32_t* scratch = planes + s.chunk * kPlaneStride;

  const int tid = threadIdx.x;
  const int stride = gridDim.x;
  const int nchunks = (s.W + s.chunk - 1) / s.chunk;

  // prologue: the words' loads, then the first slabs' copies, in flight
  // while the block stages the words
  Staged st;
  if (nchunks == 1) st = load_words(s, tt, ev, 0);
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    const int slab = blockIdx.x + k * stride;
    if (slab < s.nslabs) start_copy(s, lits, sel, raw + k * raw_words, slab);
    cp_async_commit();
  }
  for (int c = tid; c < s.C; c += kThreads) counts[c] = 0;
  if (nchunks == 1) store_words(s, st, 0, scratch);  // built after the first compress

  const int G = s.G;
  const int c = tid / G;   // this thread's candidate slot and word
  const int g = tid - c * G;
  for (int it = 0;; ++it) {
    const int slab = blockIdx.x + it * stride;
    if (slab >= s.nslabs) break;
    {
      const int next = blockIdx.x + (it + kStages - 1) * stride;
      if (next < s.nslabs) {
        start_copy(s, lits, sel, raw + ((it + kStages - 1) % kStages) * raw_words, next);
      }
      cp_async_commit();
    }
    cp_async_wait<kStages - 1>();
    __syncthreads();
    int* count = counts + (it & 1) * s.C;
    uint32_t* list = lists + (it & 1) * s.C * s.mask_stride * (s.kw + 1);
    compress<kMaxM, kGroups>(s, raw + (it % kStages) * raw_words, slab, list, count);
    if (it == 0 && nchunks == 1) build_words<kMaxM, kGroups>(s, 0, scratch, tables, planes);
    int* next_count = counts + ((it + 1) & 1) * s.C;
    for (int k = tid; k < s.C; k += kThreads) next_count[k] = 0;
    __syncthreads();

    const int cs = min(s.C, s.P - slab * s.C);
    int32_t wmax = INT_MIN;
    uint32_t wsum = 0u;
    for (int chunk = 0; chunk < nchunks; ++chunk) {
      const int w0 = chunk * s.chunk;
      if (nchunks > 1) {
        st = load_words(s, tt, ev, w0);
        store_words(s, st, w0, scratch);
        __syncthreads();
        build_words<kMaxM, kGroups>(s, w0, scratch, tables, planes);
        __syncthreads();
      }
      const int w = w0 + g;
      if (c < cs && g < s.chunk && w < s.W) {
        uint32_t outs[kMaxM];
#pragma unroll
        for (int o = 0; o < kMaxM; ++o) outs[o] = 0u;
        const int kw = kGroups != 0 ? 1 : s.kw;
        const uint32_t* mine = list + c * s.mask_stride * (kw + 1);
        const uint32_t* tab = tables + g * ((kGroups != 0 ? kGroups : s.groups) * kCodes);
        const int used = count[c];
        for (int k = 0; k < used; ++k) {
          uint32_t prod, feeds;
          if constexpr (kGroups != 0) {
            const uint2 pk = reinterpret_cast<const uint2*>(mine)[k];
            prod = tab[pk.x & 0xffu];
#pragma unroll
            for (int q = 1; q < kGroups; ++q) {
              prod &= tab[q * kCodes + ((pk.x >> (8 * q)) & 0xffu)];
            }
            feeds = pk.y;
          } else {
            const uint32_t* entry = mine + k * (kw + 1);
            prod = 0xffffffffu;
            for (int i = 0; i < kw; ++i) {
              const uint32_t key = entry[i];
              const uint32_t* tk = tab + 4 * i * kCodes;
              prod &= tk[key & 0xffu] & tk[kCodes + ((key >> 8) & 0xffu)] &
                      tk[2 * kCodes + ((key >> 16) & 0xffu)] & tk[3 * kCodes + (key >> 24)];
            }
            feeds = entry[kw];
          }
#pragma unroll
          for (int o = 0; o < kMaxM; ++o) or_where(outs[o], feeds, 1u << o, prod);
        }
        const uint32_t* wplanes = planes + g * kPlaneStride;
        const int left = s.S - 32 * w;
        const uint32_t valid = left >= 32 ? 0xffffffffu : (left <= 0 ? 0u : (1u << left) - 1u);
        int32_t m1;
        uint32_t s1;
        if (wplanes[32] == 0u) {  // every exact value of the word below 2^kMaxM
          word_error<(kMaxM < 32 ? kMaxM + 1 : 32), kMaxM>(outs, wplanes, valid, m1, s1);
        } else {
          word_error<32, kMaxM>(outs, wplanes, valid, m1, s1);
        }
        wmax = max(wmax, m1);
        wsum += s1;
      }
    }
    // every lane of the warp joins; groups are aligned runs of G lanes
    for (int off = G / 2; off > 0; off /= 2) {
      wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, off));
      wsum += __shfl_xor_sync(0xffffffffu, wsum, off);
    }
    if (c < cs && g == 0) {
      wce_out[slab * s.C + c] = wmax;
      esum_out[slab * s.C + c] = static_cast<int32_t>(wsum);
    }
  }
  cp_async_wait<0>();
}

template <int kMaxM, int kGroups>
cudaError_t launch(const int32_t* l, const int32_t* se, const uint32_t* t, const int32_t* e,
                   int32_t* wo, int32_t* so, const Shape& s, int grid, size_t smem,
                   int dev, cudaStream_t stream) {
  auto kernel = template_eval_kernel<kMaxM, kGroups>;
  static bool granted[kMaxDevices] = {};  // the budget granted on each device
  if (!granted[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
    if (err != cudaSuccess) return err;
    granted[dev] = true;
  }
  kernel<<<grid, kThreads, smem, stream>>>(l, se, t, e, wo, so, s);
  return cudaGetLastError();
}

size_t smem_bytes(const Shape& s) {
  return 4 * (static_cast<size_t>(kStages) * (s.lits_cap + s.sel_cap) +
              2 * static_cast<size_t>(s.C) * s.mask_stride * (s.kw + 1) + 2 * s.C +
              s.chunk * (s.groups * kCodes + kPlaneStride + s.n + 32));
}

int round4(int x) { return (x + 3) & ~3; }

struct Plan {
  Shape s;
  int grid;
  size_t smem;
};

// Slab size, grid and shared memory for a launch on a card of sms SMs.
cudaError_t make_plan(int P, int T, int n, int m, int W, int S, int sms, Plan& plan) {
  if (P <= 0 || T <= 0 || n <= 0 || n > 16 * kChunk || m <= 0 || m > 31 || S <= 0 ||
      S > 32LL * W || sms <= 0) {
    return cudaErrorInvalidValue;
  }
  Shape& s = plan.s;
  s = Shape{};
  s.P = P; s.T = T; s.n = n; s.m = m; s.W = W; s.S = S;
  s.kw = (n + 15) / 16;
  s.groups = n <= 8 ? 2 : 4 * s.kw;
  int cap = kChunk;  // a power of two with cap * kw <= kChunk
  while (cap * s.kw > kChunk) cap /= 2;
  s.G = 1;
  while (s.G < W && s.G < cap) s.G *= 2;
  s.chunk = std::min(W, cap);
  s.mask_stride = T + 1;  // odd: neighbouring candidates' lists on other banks
  // one candidate a G-lane group; as many slabs as blocks where the
  // population is small, full slabs where it is large; shared memory caps C
  const int slots = kThreads / s.G;
  const long long blocks = static_cast<long long>(sms) * kBlocksPerSM;
  int C = static_cast<int>(std::min<long long>(slots, (P + blocks - 1) / blocks));
  for (;; --C) {
    if (C < 1) return cudaErrorInvalidValue;
    s.C = C;
    s.lits_cap = round4(C * T * n);
    s.sel_cap = round4(C * m * T);
    if (smem_bytes(s) <= static_cast<size_t>(kSmemBudget)) break;
  }
  s.nslabs = (P + C - 1) / C;
  plan.grid = static_cast<int>(std::min<long long>(s.nslabs, blocks));
  plan.smem = smem_bytes(s);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// lits (P, T, n) and sel (P, m, T) int32; tt (n, W) packed words; ev (S,)
// int32; wce and esum (P,) int32.  Needs 1 <= m <= 31, 1 <= n <= 512 and
// 0 < S <= 32 * W.
int template_eval(const void* lits, const void* sel, const void* tt,
                  const void* ev, void* wce, void* esum, int P, int T, int n,
                  int m, int W, int S, void* stream) {
  static int sms_of[kMaxDevices] = {};  // each device's SM count, asked once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= kMaxDevices) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && sms_of[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  const int sms = err == cudaSuccess ? sms_of[dev] : 0;
  Plan plan;
  if (err == cudaSuccess) err = make_plan(P, T, n, m, W, S, sms, plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const int32_t*>(lits);
  const auto* se = static_cast<const int32_t*>(sel);
  const auto* t = static_cast<const uint32_t*>(tt);
  const auto* e = static_cast<const int32_t*>(ev);
  auto* wo = static_cast<int32_t*>(wce);
  auto* so = static_cast<int32_t*>(esum);
  const Shape& s = plan.s;
  const int grid = plan.grid;
  const size_t smem = plan.smem;
  if (m <= 8) {
    err = s.kw > 1     ? launch<8, 0>(l, se, t, e, wo, so, s, grid, smem, dev, st)
          : n <= 8     ? launch<8, 2>(l, se, t, e, wo, so, s, grid, smem, dev, st)
                       : launch<8, 4>(l, se, t, e, wo, so, s, grid, smem, dev, st);
  } else {
    err = s.kw > 1     ? launch<32, 0>(l, se, t, e, wo, so, s, grid, smem, dev, st)
          : n <= 8     ? launch<32, 2>(l, se, t, e, wo, so, s, grid, smem, dev, st)
                       : launch<32, 4>(l, se, t, e, wo, so, s, grid, smem, dev, st);
  }
  return static_cast<int>(err);
}

// The launch template_eval makes for this shape on a card of sms SMs:
// out = {candidates a slab, slabs, blocks, dynamic shared memory bytes,
// lanes a candidate}.  Returns a cudaError_t.
int template_eval_plan(int P, int T, int n, int m, int W, int S, int sms, int* out) {
  Plan plan;
  const cudaError_t err = make_plan(P, T, n, m, W, S, sms, plan);
  if (err == cudaSuccess) {
    out[0] = plan.s.C;
    out[1] = plan.s.nslabs;
    out[2] = plan.grid;
    out[3] = static_cast<int>(plan.smem);
    out[4] = plan.s.G;
  }
  return static_cast<int>(err);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
