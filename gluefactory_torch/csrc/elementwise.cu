// Elementwise out = x + y over contiguous float32 buffers (kernel K3).
//
// Replaces the Pallas TPU kernel of gluefactory_tpu/scripts/pallas_probe.py
// (_worker.kernel, lines 35-40): one VMEM block add, the smallest kernel the
// toolchain probe launches before it tries the attention kernel.
//
// What bounds it on an H100: it reads 8 bytes and writes 4 for each FLOP, so
// it is bound by bytes: 3 * 4 * n bytes over 3.35 TB/s. At the probe's
// 256x256 that is 786 KB and 0.23 us, below the few microseconds a launch
// costs, so at that size the launch is the time.
//
// What the design does about it: a grid-stride loop in which each thread
// moves 16 bytes per load and store (float4) when all three pointers are
// 16-byte aligned; the n % 4 tail, or the whole buffer when a pointer is not
// aligned, goes element by element. Enough blocks to cover n once, capped at
// a few waves of the 132 SMs.
//
// Built with plain nvcc into a shared library with a C interface; no
// PyTorch headers (see gluefactory_torch/ops/kernels.py).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

__global__ void add_f32_vec4(const float4* __restrict__ x, const float4* __restrict__ y,
                             float4* __restrict__ out, long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 a = x[i];
    const float4 b = y[i];
    out[i] = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
}

__global__ void add_f32_scalar(const float* __restrict__ x, const float* __restrict__ y,
                               float* __restrict__ out, long long begin, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = begin + static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = x[i] + y[i];
  }
}

int blocks_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? (blocks > 0 ? blocks : 1) : kMaxBlocks);
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0; }

}  // namespace

// out[i] = x[i] + y[i] for i < n. Returns cudaGetLastError() after the
// launches, or -1 for a negative n.
extern "C" int gf_add_f32(const float* x, const float* y, float* out, long long n,
                          void* stream_) {
  if (n < 0) return -1;
  if (n == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  long long done = 0;
  if (aligned16(x) && aligned16(y) && aligned16(out)) {
    const long long n4 = n / 4;
    if (n4 > 0) {
      add_f32_vec4<<<blocks_for(n4), kThreads, 0, stream>>>(
          reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(y),
          reinterpret_cast<float4*>(out), n4);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    done = n4 * 4;
  }
  if (done < n) {
    add_f32_scalar<<<blocks_for(n - done), kThreads, 0, stream>>>(x, y, out, done, n);
  }
  return static_cast<int>(cudaGetLastError());
}
