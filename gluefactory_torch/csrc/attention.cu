// Masked multi-head attention for the LightGlue transformer, with an
// optional rotary embedding of q fused in (kernels K1 and K2).
//
// Replaces two Pallas TPU kernels of gluefactory_tpu/ops/attention.py:
//   K1  _attn_rotary_kernel (line 166), launched by attention_pallas_rotary:
//       q is rotated in-kernel by cos/sin (pairs convention
//       x*cos + interleave(-x2, x1)*sin); k arrives pre-rotated.
//   K2  _attn_kernel (line 89), launched by attention_pallas: the same
//       masked softmax attention without rotary; Nq may differ from Nk.
// Both compute softmax(q k^T * D^-1/2) v in f32 with the TPU kernels' mask
// rules: masked keys take no part in the max or the sum, the denominator is
// clamped at 1e-30, so a fully-masked row gives 0. Output is in q's dtype.
//
// What bounds it on an H100: at the LightGlue shapes (B=1, H=4, N=512, D=64)
// one call moves ~2 MB and does 4*B*H*Nq*Nk*D = 268 MFLOP, i.e. 128 FLOP
// per byte in f32 -- above the f32 ridge of the CUDA cores (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte), so it is bound by operations (4.0 us). There
// are only B*H = 4 heads of 512 rows: too little parallel work to fill 132
// SMs unless the key range is split too.
//
// What the design does about it: the TPU kernel kept a whole (block_q, Nk)
// score row in VMEM; here an online softmax walks K/V in tiles held in
// shared memory, so Nk is unbounded and nothing but the output goes back to
// device memory. Each query row is owned by D/16 neighbouring threads, each
// holding 16 of its dims in registers; partial dot products are summed with
// warp shuffles. A block of 512 threads covers 16 query rows and splits the
// keys 8 ways: each group of 64 threads runs its own online softmax over
// every 8th key tile, and the groups' (max, sum, accumulator) states are
// merged through shared memory at the end. So N=512 runs as 128 blocks of 16
// warps each, enough warps per SM to hide the latency of the shared-memory
// reads and the FMA chains. Tile rows are padded (20 floats per 16-float
// chunk) so the D/16 chunks of one key sit in distinct shared-memory banks.
// Arithmetic is f32 FMA on the CUDA cores; a tensor-core (wgmma) version is
// later work.
//
// Built with plain nvcc into a shared library with a C interface; no
// PyTorch headers (see gluefactory_torch/ops/kernels.py).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;  // threads per block
constexpr int kRows = 16;      // query rows per block
constexpr int kChunk = 16;     // dims of one query row held by one thread
constexpr int kChunkPad = 20;  // padded shared-memory stride of one chunk
constexpr int kTile = 8;       // keys per tile of one key group
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// q, out: (B, H, Nq, D); k, v: (B, H, Nk, D); cos, sin: (B, Nq, D) (ROTARY
// only); mask: (B, Nk) bytes, nonzero = keep, or null for all keys. All
// contiguous. Grid: (ceil(Nq / kRows), B*H).
template <typename T, int D, bool ROTARY>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ cos_,
                 const T* __restrict__ sin_, const uint8_t* __restrict__ mask,
                 T* __restrict__ out, int H, int Nq, int Nk, float scale) {
  constexpr int TPR = D / kChunk;           // threads per query row
  constexpr int GT = kRows * TPR;           // threads per key group
  constexpr int KS = kThreads / GT;         // key groups (splits of the keys)
  constexpr int ROW = TPR * kChunkPad;      // padded floats per key row
  constexpr int TILE = kTile * ROW;         // floats per group tile
  static_assert(D % kChunk == 0 && 32 % TPR == 0 && kThreads % GT == 0,
                "unsupported head dim");
  static_assert(2 * KS * TILE >= KS * kRows * D, "merge buffer does not fit");

  // K and V tiles of every group; reused for the merge at the end
  __shared__ float smem[2 * KS * TILE];
  __shared__ bool keep[KS * kTile];
  __shared__ float red_m[KS * kRows];
  __shared__ float red_l[KS * kRows];

  const int tid = threadIdx.x;
  const int group = tid / GT;
  const int lt = tid % GT;
  const int row = lt / TPR;
  const int part = lt % TPR;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * kRows;
  const int qi = q0 + row;
  const bool row_ok = qi < Nq;
  float* ks = smem + group * TILE;
  float* vs = smem + (KS + group) * TILE;
  bool* gkeep = keep + group * kTile;

  // this thread's 16 dims of its query row, rotated and pre-scaled so that
  // the scores come out in log2 units
  float qr[kChunk];
  {
    const size_t off = ((size_t)bh * Nq + (row_ok ? qi : 0)) * D + part * kChunk;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) qr[i] = row_ok ? to_f32(q[off + i]) : 0.f;
    if (ROTARY) {
      const size_t coff = ((size_t)b * Nq + (row_ok ? qi : 0)) * D + part * kChunk;
#pragma unroll
      for (int i = 0; i < kChunk; i += 2) {
        const float x1 = qr[i], x2 = qr[i + 1];
        const float c0 = row_ok ? to_f32(cos_[coff + i]) : 0.f;
        const float c1 = row_ok ? to_f32(cos_[coff + i + 1]) : 0.f;
        const float s0 = row_ok ? to_f32(sin_[coff + i]) : 0.f;
        const float s1 = row_ok ? to_f32(sin_[coff + i + 1]) : 0.f;
        qr[i] = x1 * c0 - x2 * s0;
        qr[i + 1] = x2 * c1 + x1 * s1;
      }
    }
    const float qs = scale * kLog2e;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) qr[i] *= qs;
  }

  float m = -INFINITY;  // running max of this group's keys (log2 units)
  float l = 0.f;        // running sum of exps
  float acc[kChunk];
#pragma unroll
  for (int i = 0; i < kChunk; ++i) acc[i] = 0.f;

  const size_t kv_base = (size_t)bh * Nk * D;
  for (int t0 = 0; t0 < Nk; t0 += KS * kTile) {
    const int k0 = t0 + group * kTile;  // this group's tile
    __syncthreads();  // the previous tiles are no longer read
    for (int idx = lt; idx < kTile * D; idx += GT) {
      const int j = idx / D;
      const int d = idx % D;
      const int s = j * ROW + (d / kChunk) * kChunkPad + d % kChunk;
      const bool in = k0 + j < Nk;
      ks[s] = in ? to_f32(k[kv_base + (size_t)(k0 + j) * D + d]) : 0.f;
      vs[s] = in ? to_f32(v[kv_base + (size_t)(k0 + j) * D + d]) : 0.f;
    }
    for (int j = lt; j < kTile; j += GT) {
      const int key = k0 + j;
      gkeep[j] = key < Nk && (mask == nullptr || mask[(size_t)b * Nk + key] != 0);
    }
    __syncthreads();

    float s[kTile];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float* kr = ks + j * ROW + part * kChunkPad;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) dot = fmaf(qr[i], kr[i], dot);
#pragma unroll
      for (int o = TPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      s[j] = gkeep[j] ? dot : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    if (m_new == -INFINITY) continue;  // no kept key yet: nothing to add
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float p = exp2f(s[j] - m_new);  // 0 for a masked key
      l += p;
      const float* vr = vs + j * ROW + part * kChunkPad;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) acc[i] = fmaf(p, vr[i], acc[i]);
    }
    m = m_new;
  }

  // merge the KS groups' softmax states of each row
  __syncthreads();  // the tiles are no longer read: reuse them
  float* red_acc = smem;  // [KS][kRows][D]
#pragma unroll
  for (int i = 0; i < kChunk; ++i)
    red_acc[(group * kRows + row) * D + part * kChunk + i] = acc[i];
  if (part == 0) {
    red_m[group * kRows + row] = m;
    red_l[group * kRows + row] = l;
  }
  __syncthreads();
  for (int e = tid; e < kRows * D; e += kThreads) {
    const int r = e / D;
    const int d = e % D;
    if (q0 + r >= Nq) continue;
    float mx = -INFINITY;
#pragma unroll
    for (int g = 0; g < KS; ++g) mx = fmaxf(mx, red_m[g * kRows + r]);
    float num = 0.f, den = 0.f;
    if (mx != -INFINITY) {  // else every key is masked: the row is 0
#pragma unroll
      for (int g = 0; g < KS; ++g) {
        const float w = exp2f(red_m[g * kRows + r] - mx);
        den += w * red_l[g * kRows + r];
        num += w * red_acc[(g * kRows + r) * D + d];
      }
    }
    out[((size_t)bh * Nq + q0 + r) * D + d] = from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D, bool ROTARY>
int launch(const void* q, const void* k, const void* v, const void* cos_,
           const void* sin_, const void* mask, void* out, int B, int H, int Nq,
           int Nk, cudaStream_t stream) {
  const dim3 grid((Nq + kRows - 1) / kRows, B * H);
  attention_kernel<T, D, ROTARY><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(cos_), static_cast<const T*>(sin_),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), H, Nq, Nk,
      1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool ROTARY>
int dispatch_dim(const void* q, const void* k, const void* v, const void* cos_,
                 const void* sin_, const void* mask, void* out, int B, int H,
                 int Nq, int Nk, int D, cudaStream_t stream) {
  // head dim 64 is what every attention of the system uses (LightGlue,
  // SuperGlue and GlueStick at 256/4, DINOv2 at 384/6); each further
  // instantiation adds seconds to every build
  switch (D) {
    case 64: return launch<T, 64, ROTARY>(q, k, v, cos_, sin_, mask, out, B, H, Nq, Nk, stream);
    default: return -1;
  }
}

template <bool ROTARY>
int dispatch(int dtype, const void* q, const void* k, const void* v,
             const void* cos_, const void* sin_, const void* mask, void* out,
             int B, int H, int Nq, int Nk, int D, cudaStream_t stream) {
  switch (dtype) {
    case 0: return dispatch_dim<float, ROTARY>(q, k, v, cos_, sin_, mask, out, B, H, Nq, Nk, D, stream);
    case 1: return dispatch_dim<__half, ROTARY>(q, k, v, cos_, sin_, mask, out, B, H, Nq, Nk, D, stream);
    case 2: return dispatch_dim<__nv_bfloat16, ROTARY>(q, k, v, cos_, sin_, mask, out, B, H, Nq, Nk, D, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. Returns cudaGetLastError()
// after the launch, or -1 for a dtype or head dim that has no kernel.
extern "C" int gf_attention(int dtype, const void* q, const void* k, const void* v,
                            const void* mask, void* out, int B, int H, int Nq,
                            int Nk, int D, void* stream) {
  return dispatch<false>(dtype, q, k, v, nullptr, nullptr, mask, out, B, H, Nq, Nk, D,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int gf_attention_rotary(int dtype, const void* q, const void* k,
                                   const void* v, const void* cos_, const void* sin_,
                                   const void* mask, void* out, int B, int H, int N,
                                   int D, void* stream) {
  return dispatch<true>(dtype, q, k, v, cos_, sin_, mask, out, B, H, N, N, D,
                        static_cast<cudaStream_t>(stream));
}
