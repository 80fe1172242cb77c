// Streaming-softmax (flash) attention for Hopper (sm_90a), head_dim 128.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::_kernel,
// reached from flash_attention_pallas.  Same semantics: causal, sliding
// window or non-causal; GQA by mapping query head h to kv head
// h / (H / Hkv) without repeating K and V; queries aligned to the end of
// the kv sequence (offs = Lk - Lq); running max, denominator and
// accumulator in f32; a zero denominator guarded; output in q's dtype.
//
// Design.  On the TPU the grid walks k blocks in order and carries the
// softmax state in VMEM scratch.  Here one block owns one (batch * head,
// 64-query tile) and loops over 32-key tiles itself, staging K and V (as
// f32) in shared memory; the state lives in registers.  Each of the 8
// warps owns 8 query rows: lane j scores key j against the warp's rows,
// the tile's max and sum are warp reductions, and for the P.V product each
// lane accumulates 4 of the 128 output dims, taking p_j by shuffle.  Tiles
// wholly outside the causal or window mask are never visited.  Any Lq and
// Lk is taken: the ragged edges are masked, where Pallas asserted block
// multiples.  Shared memory is 66 KB, so the kernel asks for dynamic
// shared memory above the 48 KB default.
//
// Bound on the H100: at the qwen3-4b prefill shape (B 2, H 32, L 512) the
// work is about 4.3 GFLOP of QK^T and PV against a few MB of inputs, so it
// is bound by arithmetic; this kernel does it in f32 on the CUDA cores, not
// on the bf16 tensor cores (wgmma comes in a later version).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 128;             // head dim
constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 32;             // keys per staged tile (one per lane)
constexpr int kWarps = 8;
constexpr int kRPW = kBQ / kWarps;  // query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kKPad = kD + 4;       // K rows padded: lane-strided float4 reads hit distinct banks
constexpr float kNeg = -1e30f;
constexpr int kSmem = (kBQ * kD + kBK * kKPad + kBK * kD) * sizeof(float);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
             int Lq, int Lk, float scale, int causal, int window) {
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;              // (kBQ, kD)
  float* sk = sq + kBQ * kD;     // (kBK, kKPad)
  float* sv = sk + kBK * kKPad;  // (kBK, kD)

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * kBQ;
  const int offs = Lk - Lq;
  const T* qp = q + (static_cast<size_t>(bh) * Lq + q0) * kD;
  const T* kp = k + static_cast<size_t>(b * Hkv + hk) * Lk * kD;
  const T* vp = v + static_cast<size_t>(b * Hkv + hk) * Lk * kD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = min(kBQ, Lq - q0);

  for (int i = tid; i < kBQ * kD; i += kThreads) {
    sq[i] = i / kD < rows ? to_f32(qp[i]) : 0.f;
  }

  // the key range any row of this tile can see
  const int q_lo = q0 + offs, q_hi = q0 + rows - 1 + offs;
  const int k_end = causal ? min(Lk, q_hi + 1) : Lk;
  int k_beg = window > 0 ? max(0, q_lo - window + 1) : 0;
  k_beg -= k_beg % kBK;

  float m[kRPW], l[kRPW], acc[kRPW][4];
#pragma unroll
  for (int i = 0; i < kRPW; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }

  for (int k0 = k_beg; k0 < k_end; k0 += kBK) {
    __syncthreads();  // previous tile consumed (first pass: q staged)
    for (int i = tid; i < kBK * kD; i += kThreads) {
      const int j = i / kD, d = i % kD;
      const bool in = k0 + j < Lk;
      const size_t g = static_cast<size_t>(k0 + j) * kD + d;
      sk[j * kKPad + d] = in ? to_f32(kp[g]) : 0.f;
      sv[i] = in ? to_f32(vp[g]) : 0.f;
    }
    __syncthreads();

    float s[kRPW];
#pragma unroll
    for (int i = 0; i < kRPW; ++i) s[i] = 0.f;
    const float* kr = sk + lane * kKPad;
#pragma unroll 4
    for (int d = 0; d < kD; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int i = 0; i < kRPW; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(sq + (warp * kRPW + i) * kD + d);
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
      acc[i][0] *= corr;
      acc[i][1] *= corr;
      acc[i][2] *= corr;
      acc[i][3] *= corr;
      s[i] = p;
    }

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 vv = *reinterpret_cast<const float4*>(sv + j * kD + lane * 4);
#pragma unroll
      for (int i = 0; i < kRPW; ++i) {
        const float p = __shfl_sync(0xffffffffu, s[i], j);
        acc[i][0] = fmaf(p, vv.x, acc[i][0]);
        acc[i][1] = fmaf(p, vv.y, acc[i][1]);
        acc[i][2] = fmaf(p, vv.z, acc[i][2]);
        acc[i][3] = fmaf(p, vv.w, acc[i][3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRPW; ++i) {
    const int r = warp * kRPW + i;
    if (r >= rows) break;
    const float denom = l[i] > 0.f ? l[i] : 1.f;
    T* op = o + (static_cast<size_t>(bh) * Lq + q0 + r) * kD + lane * 4;
#pragma unroll
    for (int c = 0; c < 4; ++c) store(op + c, acc[i][c] / denom);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int Lq, int Lk, float scale, int causal, int window,
           cudaStream_t stream) {
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  if (B * H == 0 || Lq == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(B * H, (Lq + kBQ - 1) / kBQ);
  flash_kernel<T><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hkv, Lq, Lk, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (B, H, Lq, 128), k/v (B, Hkv, Lk, 128), o like q; window <= 0 = none.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int Hkv, int Lq, int Lk, float scale,
                        int causal, int window, void* stream) {
  return launch<float>(q, k, v, o, B, H, Hkv, Lq, Lk, scale, causal, window,
                       static_cast<cudaStream_t>(stream));
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int Hkv, int Lq, int Lk, float scale,
                         int causal, int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Lq, Lk, scale, causal,
                               window, static_cast<cudaStream_t>(stream));
}

int flash_attention_head_dim() { return kD; }

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
