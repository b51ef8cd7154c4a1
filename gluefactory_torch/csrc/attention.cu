// Masked multi-head attention for the LightGlue transformer, with an
// optional rotary embedding of q fused in (kernels K1 and K2), on Hopper's
// tensor cores through mma.sync.
//
// Replaces two Pallas TPU kernels of gluefactory_tpu/ops/attention.py:
//   K1  _attn_rotary_kernel (line 166), launched by attention_pallas_rotary:
//       q is rotated in-kernel by cos/sin (pairs convention
//       x*cos + interleave(-x2, x1)*sin); k arrives pre-rotated.
//   K2  _attn_kernel (line 89), launched by attention_pallas: the same
//       masked softmax attention without rotary; Nq may differ from Nk.
// Both compute softmax(q k^T * D^-1/2) v with the TPU kernels' mask rules:
// masked keys take no part in the max or the sum, the denominator is
// clamped at 1e-30, so a fully-masked row gives 0. Output is in q's dtype.
//
// What bounds it on an H100: 4*B*H*Nq*Nk*D FLOP against ~2*B*H*(Nq+Nk)*D
// elements moved -- 128 FLOP per byte in f32 at N = 512, far above the
// memory ridge -- so operations bound it. In f32 the kernel keeps f32
// accuracy with 3xTF32: each operand x is split as big = tf32(x),
// small = tf32(x - big) (round to nearest, ties away, as cvt.rna.tf32.f32),
// and each product is accumulated in f32 as small*big + big*small +
// big*big, three m16n8k8 TF32 mma.sync per fragment product. The bound is
// then 3x the work at 495 TFLOP/s (52 us at 32x4x512x64, 1.6 us at
// 1x4x512x64). f16/bf16 inputs take one m16n8k16 mma.sync with f32
// accumulation; q (K1: rotated in f32) and P are rounded to the input type.
//
// What the design does about it (FlashAttention-2 shaped):
//   - each warp owns 16 query rows. Its q is loaded once, rotated (K1),
//     pre-scaled by D^-1/2*log2(e) (f32; 16-bit scales the scores) and
//     split, and the fragments stay in registers;
//   - K/V tiles of 64 keys stream through shared memory with cp.async,
//     double-buffered: the next tile's copy overlaps this tile's two
//     products. The tile's key-mask bytes come in beside it, as bits;
//   - each warp splits the K and V values of its fragments in registers.
//     The split is integer work of the same order as the mma.sync
//     themselves; splitting each tile once per block into shared memory
//     instead gave the same bits but ran slower (more registers, two more
//     barriers a tile, twice the shared-memory reads);
//   - f32 sums: the tensor cores truncate what they accumulate, so the
//     products chain through at most two k-chunks before an f32 add
//     (kChunksPerAdd); the kernel's max and rms error against float64 are
//     then below the plain version's;
//   - the online softmax runs on the score fragments in registers (exp2f;
//     row max and sum over the 4 threads that share a row). P feeds PV from
//     registers with no shuffle: a score fragment holds keys (2t, 2t+1) of
//     rows (g, g+8), the TF32 A-fragment wants columns (t, t+4), so PV reads
//     V's rows in that permuted order (a sum over keys ignores order);
//   - the host picks the layout by the amount of work (ops/attention.py,
//     plan_attention): rows per block and the split of the key tiles into
//     `splits` ranges. With enough blocks to fill the card one block walks
//     all keys; below that each split writes its unnormalised (acc, m, l)
//     to a scratch buffer that the wrapper allocates, and a second small
//     kernel merges the splits.
// Tile rows in shared memory are padded by 16 bytes, so the fragment reads
// of K (rows g, columns t) and V (rows 2t, columns g) hit 32 distinct banks.
// A wgmma version needs V transposed in shared memory (TF32 wgmma takes
// K-major operands only): later work.
//
// Built with plain nvcc into a shared library with a C interface; no
// PyTorch headers (see gluefactory_torch/ops/kernels.py).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kD = 64;           // head dim
constexpr int kTile = 64;        // keys per K/V tile
constexpr int kMaxWarps = 4;     // warps per block (16 query rows each)
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> struct Tile {
  static constexpr int kPad = 16 / sizeof(T);           // 16 bytes
  static constexpr int kStride = kD + kPad;             // elements per row
  static constexpr int kElems = kTile * kStride;        // one K or V tile
  static constexpr int kChunks = kD * sizeof(T) / 16;   // 16-byte copies per row
  // K and V, two buffers each, then two 64-bit keep masks
  static constexpr int kSmemBytes = 4 * kElems * sizeof(T) + 2 * 8;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// two values as one 32-bit register of two 16-bit elements (low = first)
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack_bits(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest on the low 13
// mantissa bits, ties away from zero), written as integer operations: ptxas
// lowers the cvt to a longer sequence with special-value tests, which slows
// the f32 kernel (PERF.md). Finite inputs only.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small, both TF32: the 3xTF32 split
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a * b, m16n8k8, TF32 inputs, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += a * b over one k-chunk of 8 (3xTF32): small*big + big*small +
// big*big, accumulated on the tensor cores
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma_tf32(acc, as, bb0, bb1);
  mma_tf32(acc, ab, bs0, bs1);
  mma_tf32(acc, ab, bb0, bb1);
}

// The tensor cores truncate each sum they accumulate, so a long chain of
// mma.sync into one fragment piles up a bias toward 0 of a few ulps per
// link. The f32 kernel therefore accumulates two k-chunks (6 mma.sync) into
// a fragment that starts at zero and adds it to its sums in f32 (round to
// nearest): its max and rms error against float64 are then below the plain
// version's (cuBLAS f32). Four chunks an add run ~8% faster, with twice the
// bias and an rms above the plain version's (attention_variants.py,
// PERF.md).
constexpr int kChunksPerAdd = 2;

// d += a * b, m16n8k16, f16 or bf16 inputs, f32 accumulators
template <typename T>
__device__ __forceinline__ void mma_16bit(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma_16bit<__half>(float (&d)[4], const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma_16bit<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global -> shared copy; src_bytes = 0 fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// rows [key0, key0 + kTile) of k and v into shared memory; keys >= Nk as 0
template <typename T>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* k, const T* v, int key0,
                                          int Nk) {
  constexpr int per = 16 / sizeof(T);
  for (int c = threadIdx.x; c < kTile * Tile<T>::kChunks; c += blockDim.x) {
    const int r = c / Tile<T>::kChunks;
    const int col = (c % Tile<T>::kChunks) * per;
    const bool in = key0 + r < Nk;
    const size_t off = in ? static_cast<size_t>(key0 + r) * kD + col : 0;
    cp_async16(ks + r * Tile<T>::kStride + col, k + off, in ? 16 : 0);
    cp_async16(vs + r * Tile<T>::kStride + col, v + off, in ? 16 : 0);
  }
}

// The tile's keep bits, loaded by warp 0 (lane i: keys i and i + 32)
__device__ __forceinline__ void load_keep(const uint8_t* mask, int key0, int Nk, int lane,
                                          bool& lo, bool& hi) {
  const int a = key0 + lane, b = key0 + lane + 32;
  lo = a < Nk && (mask == nullptr || mask[a] != 0);
  hi = b < Nk && (mask == nullptr || mask[b] != 0);
}
__device__ __forceinline__ void store_keep(uint32_t* keep, bool lo, bool hi, int lane) {
  const uint32_t wlo = __ballot_sync(0xffffffffu, lo);
  const uint32_t whi = __ballot_sync(0xffffffffu, hi);
  if (lane == 0) {
    keep[0] = wlo;
    keep[1] = whi;
  }
}

// The warp's q: rows q0 + g and q0 + g + 8 of one head, rotated (ROTARY)
// and scaled; element (row, dim) with rows past Nq as 0
template <typename T, bool ROTARY>
__device__ __forceinline__ float q_elem(const T* q, const T* cos_, const T* sin_, int row,
                                        int Nq, int dim, float qscale) {
  if (row >= Nq) return 0.f;
  const size_t off = static_cast<size_t>(row) * kD;
  float x = to_f32(q[off + dim]);
  if (ROTARY) {
    const float partner = to_f32(q[off + (dim ^ 1)]);
    const float c = to_f32(cos_[off + dim]), s = to_f32(sin_[off + dim]);
    x = (dim & 1) ? x * c + partner * s : x * c - partner * s;
  }
  return x * qscale;
}

// q, out: (B, H, Nq, D); k, v: (B, H, Nk, D); cos, sin: (B, Nq, D) (ROTARY
// only); mask: (B, Nk) bytes, nonzero = keep, or null for all keys. All
// contiguous, 16-byte aligned. Grid (ceil(Nq / rows), B*H, splits): block
// (x, bh, s) takes query rows [x*rows, (x+1)*rows) and key tiles
// [s*tps, (s+1)*tps). With one split it writes out; with more it writes its
// unnormalised acc to part_o (splits, B*H, Nq, D) and (m, l) to part_ml
// (splits, B*H, Nq, 2), f32, for merge_kernel.
//
// __launch_bounds__ with a minimum of 1 block an SM lets ptxas take up to
// 255 registers (2 blocks an SM fit), which ran faster than a cap of 168
// registers that fits 3 blocks but spills (PERF.md).
template <typename T, bool ROTARY>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ cos_, const T* __restrict__ sin_,
                 const uint8_t* __restrict__ mask, T* __restrict__ out,
                 float* __restrict__ part_o, float* __restrict__ part_ml, int H, int Nq,
                 int Nk, int tps, float scale) {
  constexpr bool F32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ktile = reinterpret_cast<T*>(smem_raw);  // [2][kElems]
  T* vtile = ktile + 2 * Tile<T>::kElems;     // [2][kElems]
  uint32_t* keep = reinterpret_cast<uint32_t*>(vtile + 2 * Tile<T>::kElems);  // [2][2]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // row in the fragment
  const int t = lane & 3;   // column pair in the fragment
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int q0 = blockIdx.x * blockDim.x / 2 + warp * 16;  // blockDim.x / 32 * 16 rows
  const int n_tiles = (Nk + kTile - 1) / kTile;
  const int t_begin = split * tps;
  const int t_end = min(n_tiles, t_begin + tps);

  const T* qh = q + static_cast<size_t>(bh) * Nq * kD;
  const T* kh = k + static_cast<size_t>(bh) * Nk * kD;
  const T* vh = v + static_cast<size_t>(bh) * Nk * kD;
  const T* cosb = ROTARY ? cos_ + static_cast<size_t>(b) * Nq * kD : nullptr;
  const T* sinb = ROTARY ? sin_ + static_cast<size_t>(b) * Nq * kD : nullptr;
  const uint8_t* maskb = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * Nk;

  // first tile in flight while q is read
  if (t_begin < t_end) {
    load_tile(ktile, vtile, kh, vh, t_begin * kTile, Nk);
    if (warp == 0) {
      bool lo, hi;
      load_keep(maskb, t_begin * kTile, Nk, lane, lo, hi);
      store_keep(keep, lo, hi, lane);
    }
  }
  cp_async_commit();

  // q fragments: f32 -> big/small TF32 A-fragments of 8 dims each
  // (a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)); 16-bit -> packed
  // A-fragments of 16 dims ((g, 2t..2t+1), (g+8, ..), (g, 2t+8..), (g+8, ..))
  constexpr int QF = F32 ? kD / 8 : kD / 16;
  uint32_t qb[QF][4], qs[F32 ? QF : 1][4];
  const float qscale = F32 ? scale * kLog2e : 1.f;
#pragma unroll
  for (int c = 0; c < QF; ++c) {
    if constexpr (F32) {
      const int rows[4] = {q0 + g, q0 + g + 8, q0 + g, q0 + g + 8};
      const int dims[4] = {8 * c + t, 8 * c + t, 8 * c + t + 4, 8 * c + t + 4};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_tf32(q_elem<T, ROTARY>(qh, cosb, sinb, rows[i], Nq, dims[i], qscale),
                   qb[c][i], qs[c][i]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + g + (i & 1) * 8;
        const int dim = 16 * c + 2 * t + (i >> 1) * 8;
        qb[c][i] = pack2<T>(q_elem<T, ROTARY>(qh, cosb, sinb, row, Nq, dim, 1.f),
                            q_elem<T, ROTARY>(qh, cosb, sinb, row, Nq, dim + 1, 1.f));
      }
    }
  }
  const float sscale = F32 ? 1.f : scale * kLog2e;  // scores to log2 units

  float o[kD / 8][4];  // acc: dims 8n + (2t, 2t+1) of rows g, g+8
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g+8 (log2 units)
  float l[2] = {0.f, 0.f};              // this thread's part of the running sums

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int buf = (tile - t_begin) & 1;
    const bool more = tile + 1 < t_end;
    bool nlo = false, nhi = false;
    if (more) {
      load_tile(ktile + (buf ^ 1) * Tile<T>::kElems, vtile + (buf ^ 1) * Tile<T>::kElems,
                kh, vh, (tile + 1) * kTile, Nk);
      if (warp == 0) load_keep(maskb, (tile + 1) * kTile, Nk, lane, nlo, nhi);
    }
    cp_async_commit();
    cp_async_wait_one();  // this tile's copies have landed
    __syncthreads();

    const T* ks = ktile + buf * Tile<T>::kElems;
    const T* vs = vtile + buf * Tile<T>::kElems;
    const uint64_t kbits = static_cast<uint64_t>(keep[2 * buf]) |
                           (static_cast<uint64_t>(keep[2 * buf + 1]) << 32);

    // S = q k^T: 8 fragments of 8 keys, keys 8j + (2t, 2t+1) of rows g, g+8
    float s[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (F32) {
#pragma unroll
      for (int c = 0; c < QF; c += kChunksPerAdd) {
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j) {
          const float* kr = reinterpret_cast<const float*>(ks) + (8 * j + g) * Tile<T>::kStride;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int cc = c; cc < c + kChunksPerAdd; ++cc)
            mma_3xtf32(acc, qb[cc], qs[cc], kr[8 * cc + t], kr[8 * cc + t + 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) s[j][i] += acc[i];
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < QF; ++c) {
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j) {
          const T* kr = ks + (8 * j + g) * Tile<T>::kStride + 16 * c + 2 * t;
          mma_16bit<T>(s[j], qb[c], *reinterpret_cast<const uint32_t*>(kr),
                       *reinterpret_cast<const uint32_t*>(kr + 8));
        }
      }
    }

    // online softmax over this tile, rows g (h = 0) and g + 8 (h = 1)
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * t + (e & 1);
        s[j][e] = (kbits >> key) & 1 ? s[j][e] * sscale : -INFINITY;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[j][e]);
      }
    }
    float base[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
      const float m_new = fmaxf(m[h], tmax[h]);
      // no kept key yet: exp2(-inf - -inf) would be NaN, so p = 0 instead
      base[h] = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = m_new == -INFINITY ? 1.f : exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - base[e >> 1]);  // 0 for a masked key
        l[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // acc += P V
    if constexpr (F32) {
      // keys 8j + (2t, 2t+1) sit in A-fragment columns (t, t + 4): read V's
      // rows 8j + 2t and 8j + 2t + 1 as the B-fragment's rows t and t + 4
#pragma unroll
      for (int j = 0; j < kTile / 8; j += kChunksPerAdd) {
        uint32_t pb[kChunksPerAdd][4], ps[kChunksPerAdd][4];
#pragma unroll
        for (int jj = 0; jj < kChunksPerAdd; ++jj) {
          split_tf32(s[j + jj][0], pb[jj][0], ps[jj][0]);
          split_tf32(s[j + jj][2], pb[jj][1], ps[jj][1]);
          split_tf32(s[j + jj][1], pb[jj][2], ps[jj][2]);
          split_tf32(s[j + jj][3], pb[jj][3], ps[jj][3]);
        }
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int jj = 0; jj < kChunksPerAdd; ++jj) {
            const float* v0 =
                reinterpret_cast<const float*>(vs) + (8 * (j + jj) + 2 * t) * Tile<T>::kStride;
            mma_3xtf32(acc, pb[jj], ps[jj], v0[8 * n + g], v0[Tile<T>::kStride + 8 * n + g]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) o[n][i] += acc[i];
        }
      }
    } else {
      // 16 keys a step: the score fragments j = 2c, 2c+1 are the A-fragment
#pragma unroll
      for (int c = 0; c < kTile / 16; ++c) {
        const uint32_t pa[4] = {pack2<T>(s[2 * c][0], s[2 * c][1]),
                                pack2<T>(s[2 * c][2], s[2 * c][3]),
                                pack2<T>(s[2 * c + 1][0], s[2 * c + 1][1]),
                                pack2<T>(s[2 * c + 1][2], s[2 * c + 1][3])};
        const uint16_t* v0 =
            reinterpret_cast<const uint16_t*>(vs) + (16 * c + 2 * t) * Tile<T>::kStride;
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          const uint16_t* vc = v0 + 8 * n + g;
          mma_16bit<T>(o[n], pa, pack_bits(vc[0], vc[Tile<T>::kStride]),
                       pack_bits(vc[8 * Tile<T>::kStride], vc[9 * Tile<T>::kStride]));
        }
      }
    }

    if (more && warp == 0) store_keep(keep + 2 * (buf ^ 1), nlo, nhi, lane);
    __syncthreads();  // this buffer is free for the tile after next
  }

  // the 4 threads of a row hold parts of its sum
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + g + 8 * h;
    if (row >= Nq) continue;
    const size_t r = static_cast<size_t>(bh) * Nq + row;
    if (nsplit == 1) {
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
      T* dst = out + r * kD + 2 * t;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        dst[8 * n] = from_f32<T>(o[n][2 * h] * inv);
        dst[8 * n + 1] = from_f32<T>(o[n][2 * h + 1] * inv);
      }
    } else {
      const size_t pr = static_cast<size_t>(split) * gridDim.y * Nq + r;
      float* dst = part_o + pr * kD + 2 * t;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n)
        *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(o[n][2 * h], o[n][2 * h + 1]);
      if (t == 0) *reinterpret_cast<float2*>(part_ml + 2 * pr) = make_float2(m[h], l[h]);
    }
  }
}

// out = sum_s 2^(m_s - M) acc_s / max(sum_s 2^(m_s - M) l_s, 1e-30) with
// M = max_s m_s, and 0 where every split saw only masked keys. One thread
// per output element; rows = B*H*Nq.
template <typename T>
__global__ void merge_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                             T* __restrict__ out, size_t rows, int splits) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= rows * kD) return;
  const size_t r = e / kD;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_ml[2 * (s * rows + r)]);
  float num = 0.f, den = 0.f;
  if (mx != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      const float w = exp2f(part_ml[2 * (s * rows + r)] - mx);
      den += w * part_ml[2 * (s * rows + r) + 1];
      num += w * part_o[s * rows * kD + e];
    }
  }
  out[e] = from_f32<T>(num / fmaxf(den, 1e-30f));
}

// The kernel's shared memory is above the 48 KB a launch gets unasked, so
// each device must allow it once before the first launch there; a refused
// launch would never run.
template <typename T, bool ROTARY>
cudaError_t allow_smem() {
  static std::atomic<uint64_t> allowed{0};  // bit i: device i has opted in
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (allowed.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(attention_kernel<T, ROTARY>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<T>::kSmemBytes);
  if (err == cudaSuccess) allowed.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <typename T, bool ROTARY>
int launch(const void* q, const void* k, const void* v, const void* cos_, const void* sin_,
           const void* mask, void* out, float* part_o, float* part_ml, int B, int H, int Nq,
           int Nk, int rows, int tps, int splits, cudaStream_t stream) {
  const int n_tiles = (Nk + kTile - 1) / kTile;
  if ((rows != 16 && rows != 32 && rows != 64) || tps < 1 || splits < 1 ||
      (splits - 1) * tps >= n_tiles || splits * tps < n_tiles ||
      (splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return -1;  // a plan that does not cover every key exactly once
  const cudaError_t allowed = allow_smem<T, ROTARY>();
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const dim3 grid((Nq + rows - 1) / rows, B * H, splits);
  attention_kernel<T, ROTARY><<<grid, rows * 2, Tile<T>::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(cos_), static_cast<const T*>(sin_),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), part_o, part_ml, H, Nq, Nk,
      tps, 1.0f / sqrtf(static_cast<float>(kD)));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n_rows = static_cast<size_t>(B) * H * Nq;
  const unsigned blocks = static_cast<unsigned>((n_rows * kD + 255) / 256);
  merge_kernel<T><<<blocks, 256, 0, stream>>>(part_o, part_ml, static_cast<T*>(out), n_rows,
                                               splits);
  return static_cast<int>(cudaGetLastError());
}

template <bool ROTARY>
int dispatch(int dtype, const void* q, const void* k, const void* v, const void* cos_,
             const void* sin_, const void* mask, void* out, float* part_o, float* part_ml,
             int B, int H, int Nq, int Nk, int D, int rows, int tps, int splits,
             cudaStream_t stream) {
  // head dim 64 is what every attention of the system uses (LightGlue,
  // SuperGlue and GlueStick at 256/4, DINOv2 at 384/6); each further
  // instantiation adds seconds to every build
  if (D != kD) return -1;
  switch (dtype) {
    case 0: return launch<float, ROTARY>(q, k, v, cos_, sin_, mask, out, part_o, part_ml, B, H,
                                         Nq, Nk, rows, tps, splits, stream);
    case 1: return launch<__half, ROTARY>(q, k, v, cos_, sin_, mask, out, part_o, part_ml, B, H,
                                          Nq, Nk, rows, tps, splits, stream);
    case 2: return launch<__nv_bfloat16, ROTARY>(q, k, v, cos_, sin_, mask, out, part_o, part_ml,
                                                 B, H, Nq, Nk, rows, tps, splits, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. The plan (rows per block,
// key tiles per split, splits) comes from ops/attention.py plan_attention;
// part_o (splits, B*H, Nq, D) and part_ml (splits, B*H, Nq, 2) are f32
// scratch, needed when splits > 1. Returns cudaGetLastError() after the
// launches, or -1 for a dtype, head dim or plan that has no kernel.
extern "C" int gf_attention(int dtype, const void* q, const void* k, const void* v,
                            const void* mask, void* out, void* part_o, void* part_ml, int B,
                            int H, int Nq, int Nk, int D, int rows, int tps, int splits,
                            void* stream) {
  return dispatch<false>(dtype, q, k, v, nullptr, nullptr, mask, out,
                         static_cast<float*>(part_o), static_cast<float*>(part_ml), B, H, Nq,
                         Nk, D, rows, tps, splits, static_cast<cudaStream_t>(stream));
}

extern "C" int gf_attention_rotary(int dtype, const void* q, const void* k, const void* v,
                                   const void* cos_, const void* sin_, const void* mask,
                                   void* out, void* part_o, void* part_ml, int B, int H, int N,
                                   int D, int rows, int tps, int splits, void* stream) {
  return dispatch<true>(dtype, q, k, v, cos_, sin_, mask, out, static_cast<float*>(part_o),
                        static_cast<float*>(part_ml), B, H, N, N, D, rows, tps, splits,
                        static_cast<cudaStream_t>(stream));
}
