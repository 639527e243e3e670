// Per-cluster threshold counts for the bisection medians, on Hopper (sm_90a):
//
//   counts[j, r*d + f] = #{ i : labels_i = j  and  x[i, f] <= thr[r, j, f] }
//
// for r in {0, 1} (the two middle ranks bisected together), labels < 0 or
// >= k meaning "no cluster".
//
// Replaces the TPU kernel label_segment_matmul (cdrs_tpu/ops/pallas_kernels.py,
// _kernel_seg / _build_seg) applied to the 0/1 matrix y its only caller
// builds (cdrs_tpu/ops/scoring_jax.py, _bisect_core): there the threshold
// gather, the compare and a bf16 y of width 2d are materialised per chunk and
// reduced by a one-hot matmul on the MXU.  Here the gather and the compare are
// fused into the counting pass, so y never exists, and counts are integers:
// exact, and independent of the order of the atomics.
//
// What bounds it on this card: each element of x is read once and compared
// twice, so the pass is memory bound (4 or 2 bytes per compare pair).  The
// cost beyond the read is atomic contention: with few clusters (k = 8,
// d = 5: 80 counters) a warp's 32 lanes hit the same counters, so lanes with
// equal counter index are merged first (__match_any_sync) and one lane adds
// the popcount.  The (k, 2d) histogram and the thresholds sit in shared
// memory when they fit (16*k*d bytes <= 192 KB); otherwise both are read from
// and added into global memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kSmemBudget = 192 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void add_key(int* hist, int key) {
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int leader = __ffs(peers) - 1;
  if (key >= 0 && (int)(threadIdx.x & 31) == leader) atomicAdd(&hist[key], __popc(peers));
}

template <typename T, bool SHARED>
__global__ void __launch_bounds__(kThreads)
seg_count_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                 const float* __restrict__ thr, int64_t n, int d, int k,
                 int* __restrict__ out) {
  extern __shared__ int smem_i[];
  const int64_t kd = (int64_t)k * d;
  int* hist = out;
  const float* th = thr;
  if (SHARED) {
    hist = smem_i;                                   // k * 2d ints
    float* s_thr = (float*)(smem_i + 2 * kd);        // 2 * k * d floats
    for (int64_t e = threadIdx.x; e < 2 * kd; e += kThreads) {
      hist[e] = 0;
      s_thr[e] = thr[e];
    }
    th = s_thr;
    __syncthreads();
  }
  const int64_t total = n * d;
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * kThreads) >> 5;
  // Warp-uniform trip count: every lane reaches each __match_any_sync.
  for (int64_t base = warp * 32; base < total; base += n_warps * 32) {
    const int64_t e = base + lane;
    int key0 = -1, key1 = -1;
    if (e < total) {
      const int64_t i = e / d;
      const int f = (int)(e - i * d);
      const int j = labels[i];
      if (j >= 0 && j < k) {
        const float v = to_f(x[e]);
        const int64_t t = (int64_t)j * d + f;
        if (v <= th[t]) key0 = (int)(j * 2 * d + f);
        if (v <= th[kd + t]) key1 = (int)(j * 2 * d + d + f);
      }
    }
    add_key(hist, key0);
    add_key(hist, key1);
  }
  if (SHARED) {
    __syncthreads();
    for (int64_t e = threadIdx.x; e < 2 * kd; e += kThreads)
      if (hist[e]) atomicAdd(&out[e], hist[e]);
  }
}

template <typename T>
int launch(const void* x, const void* labels, const void* thr, int64_t n, int d, int k,
           void* out, int nb, void* stream) {
  if (n < 0 || d < 1 || k < 1 || nb < 1) return (int)cudaErrorInvalidValue;
  if (2 * (int64_t)k * d >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t kd = (size_t)k * d;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int) * 2 * kd, s);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 2 * kd * (sizeof(int) + sizeof(float));
  if (smem <= kSmemBudget) {
    auto kern = seg_count_kernel<T, true>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<nb, kThreads, smem, s>>>((const T*)x, (const int*)labels, (const float*)thr,
                                    n, d, k, (int*)out);
  } else {
    seg_count_kernel<T, false><<<nb, kThreads, 0, s>>>(
        (const T*)x, (const int*)labels, (const float*)thr, n, d, k, (int*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, d) row-major f32 or bf16; labels (n,) int32; thr (2, k, d) f32;
// out (k, 2d) int32 (zeroed here).  Returns a cudaError_t code.
int cdrs_seg_count_f32(const void* x, const void* labels, const void* thr, int64_t n,
                       int d, int k, void* out, int nb, void* stream) {
  return launch<float>(x, labels, thr, n, d, k, out, nb, stream);
}

int cdrs_seg_count_bf16(const void* x, const void* labels, const void* thr, int64_t n,
                        int d, int k, void* out, int nb, void* stream) {
  return launch<__nv_bfloat16>(x, labels, thr, n, d, k, out, nb, stream);
}

}  // extern "C"
