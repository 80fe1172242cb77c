// Population scoring of SHARED-template candidates for Hopper (sm_90a).
//
// Replaces the Pallas _kernel of repro/kernels/template_eval.py (reached
// from template_eval_pallas).  For each candidate p of a population:
//   prod[t] = AND_j lit(p, t, j)   with lit = tt[j] (USE), ~tt[j] (NEG) or
//                                   all-ones (IGNORE), over packed words
//   out[o]  = OR_t prod[t] where sel[p, o, t] != 0
//   val(s)  = sum_o bit_s(out[o]) << o,   err(s) = |val(s) - exact[s]|
//   wce[p]  = max_s err(s),   esum[p] = sum_s err(s)   (int32, s < S)
// Input assignments are bit-packed, 32 per uint32 word, W = ceil(S / 32)
// words per truth table.
//
// Bound on the H100: integer work on the CUDA cores, no tensor-core form.
// What the function needs per (candidate, word): one AND per literal that
// is not IGNORE in a used product, one OR per selected (output, product),
// and about 10*(m + 1) word ops for the error of all 32 lanes at once in
// bit-sliced form (the outputs are already the value's bit planes, so the
// subtraction of the exact planes, the conditional negate, the max and
// the popcount-weighted sum each cost 2-3 ops per plane).  The bytes are
// the parameter rows (T*n + m*T int32 per candidate) and two int32
// results.  For mul_i8 (n = m = 8, T = 16, W = 8) on a random population
// that is about 225 * 8 ops against 1 KB per candidate, under the card's
// ratio of about 5 int32 ops per byte, so the bound is the bytes
// (chip_smoke.template_eval_bound).  This kernel does more than that: it
// forms every literal, and unpacks and reduces its 32 lanes one at a
// time, 32*(2m + 3) ops per word.  At the search's populations (a few
// thousand candidates) its time is set by latency, not by either count.
//
// Design.  The TPU kernel pads the population to blocks of 256 and
// evaluates one block with (Pb, T, n, W) vector ops.  Here one thread owns
// one (candidate, word) pair: G = min(32, pow2 >= W) neighbouring lanes of
// one warp share a candidate, so a 4096-candidate mul_i8 population runs
// 32,768 threads (one thread per candidate would fill 32 blocks of 128 on
// 132 SMs).  A thread keeps its m output words in registers, forms each
// product over the n literals and ORs it into the outputs it feeds,
// without storing products; then it unpacks its 32 lanes, masks lanes at
// or past S (adder_i4 and mul_i4 have S = 16 < 32, where ~tt sets the
// high lanes) and reduces max and sum, and the G lanes of a candidate
// finish the reduction with warp shuffles.  When W > 32 (n > 10) each
// thread loops over words W / 32 apart.  The parameter rows are read
// straight from global memory: the G threads of a candidate read the same
// addresses, which the hardware broadcasts.  The ragged population edge
// is masked, nothing is padded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <int kMaxM>
__global__ void __launch_bounds__(kThreads)
template_eval_kernel(const int32_t* __restrict__ lits,  // (P, T, n)
                     const int32_t* __restrict__ sel,   // (P, m, T)
                     const uint32_t* __restrict__ tt,   // (n, W)
                     const int32_t* __restrict__ ev,    // (S,)
                     int32_t* __restrict__ wce_out,     // (P,)
                     int32_t* __restrict__ esum_out,    // (P,)
                     int P, int T, int n, int m, int W, int S, int G) {
  const int gtid = blockIdx.x * kThreads + threadIdx.x;
  const int p = gtid / G;  // candidate
  const int g = gtid % G;  // lane within the candidate's group
  const bool live = p < P;
  const int32_t* lit_p = lits + static_cast<size_t>(live ? p : 0) * T * n;
  const int32_t* sel_p = sel + static_cast<size_t>(live ? p : 0) * m * T;

  int32_t wce = 0, esum = 0;
  for (int w = g; live && w < W; w += G) {
    uint32_t outs[kMaxM];
#pragma unroll
    for (int o = 0; o < kMaxM; ++o) outs[o] = 0u;
    for (int t = 0; t < T; ++t) {
      uint32_t prod = 0xffffffffu;
      for (int j = 0; j < n; ++j) {
        const int l = lit_p[t * n + j];
        const uint32_t x = tt[j * W + w];
        prod &= (l == 0) ? x : ((l == 1) ? ~x : 0xffffffffu);
      }
#pragma unroll
      for (int o = 0; o < kMaxM; ++o) {
        if (o < m && sel_p[o * T + t] != 0) outs[o] |= prod;
      }
    }
    const int lanes = min(32, S - 32 * w);
    for (int k = 0; k < lanes; ++k) {
      int32_t val = 0;
#pragma unroll
      for (int o = 0; o < kMaxM; ++o) {
        if (o < m) val |= static_cast<int32_t>((outs[o] >> k) & 1u) << o;
      }
      const int32_t d = val - ev[32 * w + k];
      const int32_t err = d < 0 ? -d : d;
      wce = max(wce, err);
      esum += err;
    }
  }
  // every lane of the warp joins the shuffles, live or not; groups are
  // aligned runs of G lanes, so xor offsets below G stay in the group
  for (int off = G / 2; off > 0; off /= 2) {
    wce = max(wce, __shfl_xor_sync(0xffffffffu, wce, off));
    esum += __shfl_xor_sync(0xffffffffu, esum, off);
  }
  if (live && g == 0) {
    wce_out[p] = wce;
    esum_out[p] = esum;
  }
}

}  // namespace

extern "C" {

// lits (P, T, n) and sel (P, m, T) int32; tt (n, W) packed words; ev (S,)
// int32; wce and esum (P,) int32.  Needs 1 <= m <= 31 and S <= 32 * W.
int template_eval(const void* lits, const void* sel, const void* tt,
                  const void* ev, void* wce, void* esum, int P, int T, int n,
                  int m, int W, int S, void* stream) {
  if (P == 0) return static_cast<int>(cudaGetLastError());
  int G = 1;
  while (G < W && G < 32) G *= 2;
  const long long threads = static_cast<long long>(P) * G;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const int32_t*>(lits);
  const auto* se = static_cast<const int32_t*>(sel);
  const auto* t = static_cast<const uint32_t*>(tt);
  const auto* e = static_cast<const int32_t*>(ev);
  auto* wo = static_cast<int32_t*>(wce);
  auto* so = static_cast<int32_t*>(esum);
  if (m <= 8) {
    template_eval_kernel<8><<<blocks, kThreads, 0, s>>>(l, se, t, e, wo, so, P, T, n, m, W, S, G);
  } else {
    template_eval_kernel<32><<<blocks, kThreads, 0, s>>>(l, se, t, e, wo, so, P, T, n, m, W, S, G);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
