// Fused Lloyd step for Hopper (sm_90a): nearest-centroid labels plus the
// per-cluster (sum, count) statistics, in one pass over the points.
//
// Replaces both TPU kernels of the fused Lloyd step in
// cdrs_tpu/ops/pallas_kernels.py: lloyd_assign_reduce_pallas_t (feature-major,
// _kernel_t / _build_t; the full-batch Lloyd loop) and lloyd_assign_reduce_pallas
// (row-major with a runtime n_valid mask and every label, _kernel / _build; the
// mini-batch update and predict and the drift step).  The TPU needed two only
// for its lane padding of narrow rows; this kernel has the row-major contract.
// What it computes:
//   label_i = first argmin_j ( |c_j|^2 - 2 <x_i, c_j> )
//   sums[j] = sum_{i < n_valid, label_i = j} x_i     counts[j] = #{...}
//
// What bounds it on this card.  At the pipeline's shape (d = 5, k = 8) each
// row costs k*d FMAs per 4*d bytes read, ~2 FMA/byte: memory bound by a
// wide margin (the card does ~10 f32 FMA per byte of HBM).  At d = 32,
// k = 128 it is ~32 FMA/byte and at d = 128, k = 1024 ~256 FMA/byte, both on
// the f32 CUDA-core side of the roofline.  Distances stay in IEEE f32 FMAs
// (no TF32: it flips argmin ties), so the tensor cores are not used.
//
// Design.
// * x is read row-major (n, d).  The TPU kernel's feature-major copy existed
//   only because the TPU lane-pads d < 128; a row here is contiguous.  Rows of
//   d <= 32 are held in registers for the whole scan over the centroids.
// * Rows >= n_valid are masked in the kernel (label still written), so there
//   is no zero-pad contract and no count correction.
// * Centroids and |c|^2 sit in shared memory, in tiles of kt rows when the
//   whole table does not fit (d = 128, k = 1024 is 512 KB).  Rows scan the
//   tiles in increasing j with a strict <, so the first minimum wins.
// * Deterministic statistics without float atomics: a persistent grid of
//   nb blocks, block b owning a fixed contiguous row range.  Per chunk of
//   256 rows, G thread groups each own every G-th row and add into their own
//   shared-memory slab (each (cluster, feature) cell has one writer).  When
//   the slabs hold every cluster they accumulate over the whole row range and
//   are summed in group order once; otherwise they cover kts clusters at a
//   time and are flushed into the block's private slice of a global partial
//   buffer after every chunk.  A second kernel sums the nb partials in block
//   order.  Counts are int32 (shared-memory integer atomics, exact).
// * with_labels = false skips the labels store (the Lloyd loop's variant).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kTileBytes = 64 * 1024;   // centroid tile budget
constexpr size_t kSlabBytes = 64 * 1024;   // statistics slab budget
constexpr int kJB = 16;                    // centroids per register tile (d > 32)
constexpr int kFC = 32;                    // features per register chunk (d > 32)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Plan {
  int kt;       // centroid rows per distance tile
  int gs;       // threads per group (features handled by a group)
  int groups;   // groups G
  int kts;      // clusters per statistics slab
  size_t smem;  // dynamic shared memory bytes
};

Plan make_plan(int d, int k) {
  Plan p;
  int kt = (int)(kTileBytes / (sizeof(float) * (size_t)(d + 1)));
  p.kt = kt < k ? (kt < 1 ? 1 : kt) : k;
  p.gs = d < kThreads ? d : kThreads;
  int groups = kThreads / p.gs;
  size_t cell = sizeof(float) * (size_t)k * d;
  int fit = (int)(kSlabBytes / cell);
  if (fit >= 1) {
    p.groups = fit < groups ? fit : groups;
    p.kts = k;
  } else {
    p.groups = 1;
    int kts = (int)(kSlabBytes / (sizeof(float) * (size_t)d));
    p.kts = kts < 1 ? 1 : kts;
  }
  p.smem = sizeof(float) * (size_t)p.kt * (d + 1)            // centroid tile + |c|^2
         + sizeof(int) * kThreads                            // chunk labels
         + sizeof(int) * (size_t)k                           // block counts
         + sizeof(float) * (size_t)p.groups * p.kts * d;     // slabs
  return p;
}

// DMAX > 0: rows (d <= DMAX) are loaded once into registers; DMAX == 0: any d,
// the row is re-read (from L1) once per tile of kJB centroids.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
lloyd_stats_kernel(const T* __restrict__ x, const float* __restrict__ c,
                   const float* __restrict__ csq, int64_t n, int64_t n_valid,
                   int d, int k, int64_t rows_per_block, Plan plan,
                   int* __restrict__ labels, float* __restrict__ part_sums,
                   int* __restrict__ part_counts) {
  extern __shared__ float smem[];
  float* s_c = smem;                                   // kt * d
  float* s_csq = s_c + (size_t)plan.kt * d;            // kt
  int* s_lab = (int*)(s_csq + plan.kt);                // kThreads
  int* s_cnt = s_lab + kThreads;                       // k
  float* s_slab = (float*)(s_cnt + k);                 // groups * kts * d

  const int t = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t row0 = b * rows_per_block;
  int64_t row1 = row0 + rows_per_block;
  if (row1 > n) row1 = n;
  const int64_t kd = (int64_t)k * d;
  float* my_part = part_sums + b * kd;
  const int slab_elems = plan.groups * plan.kts * d;
  const bool one_tile = plan.kt >= k;
  const bool one_slab = plan.kts >= k;

  for (int j = t; j < k; j += kThreads) s_cnt[j] = 0;
  if (one_slab) {
    for (int e = t; e < slab_elems; e += kThreads) s_slab[e] = 0.f;
  } else {
    for (int64_t e = t; e < kd; e += kThreads) my_part[e] = 0.f;
  }
  if (one_tile) {
    for (int e = t; e < k * d; e += kThreads) s_c[e] = c[e];
    for (int j = t; j < k; j += kThreads) s_csq[j] = csq[j];
  }
  __syncthreads();

  const int g = t / plan.gs;
  const int lane = t - g * plan.gs;

  for (int64_t base = row0; base < row1; base += kThreads) {
    const int64_t r = base + t;
    const bool in = r < row1;
    const T* xrow = x + r * d;
    float xr[DMAX > 0 ? DMAX : 1];
    if (DMAX > 0 && in) {
#pragma unroll
      for (int f = 0; f < DMAX; ++f)
        if (f < d) xr[f] = to_f(xrow[f]);
    }
    float best = INFINITY;
    int best_j = 0;
    for (int j0 = 0; j0 < k; j0 += plan.kt) {
      const int ktc = (k - j0) < plan.kt ? (k - j0) : plan.kt;
      if (!one_tile) {
        __syncthreads();
        for (int e = t; e < ktc * d; e += kThreads) s_c[e] = c[(int64_t)j0 * d + e];
        for (int j = t; j < ktc; j += kThreads) s_csq[j] = csq[j0 + j];
        __syncthreads();
      }
      if (in && DMAX > 0) {
        for (int j = 0; j < ktc; ++j) {
          const float* cj = s_c + (size_t)j * d;
          float dot = 0.f;
#pragma unroll
          for (int f = 0; f < (DMAX > 0 ? DMAX : 1); ++f)
            if (f < d) dot = fmaf(xr[f], cj[f], dot);
          const float dist = s_csq[j] - 2.f * dot;
          if (dist < best) { best = dist; best_j = j0 + j; }
        }
      } else if (in) {
        // Any d: kJB centroids at a time, the row streamed through registers
        // kFC features at a time, so each row element is loaded once per kJB
        // centroids.  Each dot still adds its features in order 0..d-1.
        for (int jb = 0; jb < ktc; jb += kJB) {
          const int nj = (ktc - jb) < kJB ? (ktc - jb) : kJB;
          float acc[kJB];
#pragma unroll
          for (int q = 0; q < kJB; ++q) acc[q] = 0.f;
          for (int f0 = 0; f0 < d; f0 += kFC) {
            float xc[kFC];
#pragma unroll
            for (int f = 0; f < kFC; ++f) xc[f] = (f0 + f < d) ? to_f(xrow[f0 + f]) : 0.f;
#pragma unroll
            for (int q = 0; q < kJB; ++q) {
              if (q < nj) {
                const float* cq = s_c + (size_t)(jb + q) * d + f0;
#pragma unroll
                for (int f = 0; f < kFC; ++f)
                  if (f0 + f < d) acc[q] = fmaf(xc[f], cq[f], acc[q]);
              }
            }
          }
#pragma unroll
          for (int q = 0; q < kJB; ++q) {
            if (q < nj) {
              const float dist = s_csq[jb + q] - 2.f * acc[q];
              if (dist < best) { best = dist; best_j = j0 + jb + q; }
            }
          }
        }
      }
    }
    if (in && labels != nullptr) labels[r] = best_j;
    const int lab = (in && r < n_valid) ? best_j : -1;
    s_lab[t] = lab;
    if (lab >= 0) atomicAdd(&s_cnt[lab], 1);
    __syncthreads();

    if (one_slab) {
      if (g < plan.groups) {
        float* slab = s_slab + (size_t)g * plan.kts * d;
        for (int rr = g; rr < kThreads; rr += plan.groups) {
          const int lj = s_lab[rr];
          if (lj < 0) continue;
          const T* xs = x + (base + rr) * d;
          for (int f = lane; f < d; f += plan.gs) slab[lj * d + f] += to_f(xs[f]);
        }
      }
      __syncthreads();  // s_lab is rewritten by the next chunk
      continue;
    }
    for (int k0 = 0; k0 < k; k0 += plan.kts) {
      const int ktc = (k - k0) < plan.kts ? (k - k0) : plan.kts;
      const int cells = ktc * d;
      for (int e = t; e < slab_elems; e += kThreads) s_slab[e] = 0.f;
      __syncthreads();
      if (g < plan.groups) {
        float* slab = s_slab + (size_t)g * plan.kts * d;
        for (int rr = g; rr < kThreads; rr += plan.groups) {
          const int lj = s_lab[rr] - k0;
          if (s_lab[rr] < 0 || lj < 0 || lj >= ktc) continue;
          const T* xs = x + (base + rr) * d;
          for (int f = lane; f < d; f += plan.gs) slab[lj * d + f] += to_f(xs[f]);
        }
      }
      __syncthreads();
      for (int e = t; e < cells; e += kThreads) {
        float s = 0.f;
        for (int gg = 0; gg < plan.groups; ++gg) s += s_slab[(size_t)gg * plan.kts * d + e];
        my_part[(int64_t)k0 * d + e] += s;
      }
      __syncthreads();
    }
  }
  __syncthreads();
  if (one_slab) {
    for (int64_t e = t; e < kd; e += kThreads) {
      float s = 0.f;
      for (int gg = 0; gg < plan.groups; ++gg) s += s_slab[(size_t)gg * plan.kts * d + e];
      my_part[e] = s;
    }
  }
  for (int j = t; j < k; j += kThreads) part_counts[b * k + j] = s_cnt[j];
}

__global__ void lloyd_reduce_kernel(const float* __restrict__ part_sums,
                                    const int* __restrict__ part_counts, int nb,
                                    int64_t kd, int k, float* __restrict__ sums,
                                    int* __restrict__ counts) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < kd) {
    float s = 0.f;
    for (int b = 0; b < nb; ++b) s += part_sums[(int64_t)b * kd + e];
    sums[e] = s;
  }
  if (e < k) {
    int s = 0;
    for (int b = 0; b < nb; ++b) s += part_counts[(int64_t)b * k + e];
    counts[e] = s;
  }
}

template <typename T, int DMAX>
cudaError_t launch_stats(const Plan& plan, int nb, cudaStream_t s, const void* x,
                         const void* c, const void* csq, int64_t n, int64_t n_valid,
                         int d, int k, int64_t rows_per_block, void* labels,
                         void* part_sums, void* part_counts) {
  auto kern = lloyd_stats_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (err != cudaSuccess) return err;
  kern<<<nb, kThreads, plan.smem, s>>>((const T*)x, (const float*)c, (const float*)csq,
                                       n, n_valid, d, k, rows_per_block, plan,
                                       (int*)labels, (float*)part_sums, (int*)part_counts);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* c, const void* csq, int64_t n, int64_t n_valid,
           int d, int k, void* labels, void* part_sums, void* part_counts,
           void* sums, void* counts, int nb, void* stream) {
  if (n < 0 || d < 1 || k < 1 || nb < 1) return (int)cudaErrorInvalidValue;
  const Plan plan = make_plan(d, k);
  if (plan.smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t rows_per_block = (n + nb - 1) / nb;
  cudaError_t err;
  if (d <= 8) {
    err = launch_stats<T, 8>(plan, nb, s, x, c, csq, n, n_valid, d, k, rows_per_block,
                             labels, part_sums, part_counts);
  } else if (d <= 32) {
    err = launch_stats<T, 32>(plan, nb, s, x, c, csq, n, n_valid, d, k, rows_per_block,
                              labels, part_sums, part_counts);
  } else {
    err = launch_stats<T, 0>(plan, nb, s, x, c, csq, n, n_valid, d, k, rows_per_block,
                             labels, part_sums, part_counts);
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t kd = (int64_t)k * d;
  const int64_t work = kd > k ? kd : k;
  const int rb = 256;
  lloyd_reduce_kernel<<<(unsigned)((work + rb - 1) / rb), rb, 0, s>>>(
      (const float*)part_sums, (const int*)part_counts, nb, kd, k, (float*)sums, (int*)counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, d) row-major f32 or bf16; c (k, d) f32 (already rounded to x's type);
// csq (k,) f32; labels (n,) int32 or NULL; part_sums (nb, k, d) f32 and
// part_counts (nb, k) int32 scratch; sums (k, d) f32; counts (k,) int32.
// Returns a cudaError_t code (0 = launched).
int cdrs_lloyd_f32(const void* x, const void* c, const void* csq, int64_t n, int64_t n_valid,
                   int d, int k, void* labels, void* part_sums, void* part_counts,
                   void* sums, void* counts, int nb, void* stream) {
  return launch<float>(x, c, csq, n, n_valid, d, k, labels, part_sums, part_counts,
                       sums, counts, nb, stream);
}

int cdrs_lloyd_bf16(const void* x, const void* c, const void* csq, int64_t n, int64_t n_valid,
                    int d, int k, void* labels, void* part_sums, void* part_counts,
                    void* sums, void* counts, int nb, void* stream) {
  return launch<__nv_bfloat16>(x, c, csq, n, n_valid, d, k, labels, part_sums, part_counts,
                               sums, counts, nb, stream);
}

}  // extern "C"
