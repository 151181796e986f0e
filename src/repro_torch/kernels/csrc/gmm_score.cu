// GMM log densities and Definition-1 scoring on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   gmm_score_kernel <- repro/kernels/gmm_score.py::_score_kernel (gmm_score_pallas)
//   gmm_best_kernel  <- repro/kernels/gmm_score.py::_best_kernel  (gmm_best_pallas)
//
// For each row x of X (N, D) and each component k:
//   log N(x | mu_k, Sigma_k) = -1/2 (D log 2pi + |x U_k - mu_k U_k|^2) + logdet_k
// with Sigma_k^-1 = U_k U_k^T. The wrapper computes mu_k U_k and logdet_k with
// torch before the launch, as the Pallas wrapper's `_common` does.
//
// Bound: at the shapes in use (D = 3 or 4, K <= 4) a row costs ~K (2 D^2 + 2 D)
// flops against D*4 bytes read and K*4 (score) or 8 (best) bytes written,
// about 5 flops a byte, under the card's float32 ridge of ~20: the kernels are
// bound by device-memory bytes. The TPU version ran the contraction on the
// matrix unit; at D <= 32 it is far below a tensor-core tile, so here each
// thread owns one row, keeps it in registers, and reads the parameters from
// shared memory, where all lanes of a warp read the same word (a broadcast).
// Blocks carry nothing between them, so there is no cross-block reduction and
// no atomics; the ragged last block is masked by the grid-stride loop bound.
// At the main path's N (hundreds to thousands of rows a layer) a launch is
// dominated by launch overhead, not by this arithmetic.
//
// Shared memory: K*D*D + K*D + K floats, 67,648 bytes at the largest shape
// (D = 32, K = 16); above 48 KB it needs the dynamic-shared-memory opt-in,
// which the launcher requests.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes; each launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 32;
constexpr int kMaxK = 16;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // grid-stride beyond 16 blocks per SM
constexpr double kLog2Pi = 1.8378770664093453;  // log(2 pi)
constexpr size_t kStaticSmemLimit = 48 * 1024;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// BEST = false: out is (N, K) log densities.
// BEST = true:  out is (N,) best log density and arg (N,) its first index.
template <typename T, bool BEST>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const T* __restrict__ X, const float* __restrict__ U,
           const float* __restrict__ mu_u, const float* __restrict__ logdet,
           float* __restrict__ out, int32_t* __restrict__ arg,
           int64_t N, int D, int K) {
  extern __shared__ float smem[];
  float* sU = smem;                 // (K, D, D)
  float* sMu = sU + K * D * D;      // (K, D)
  float* sLd = sMu + K * D;         // (K,)
  for (int i = threadIdx.x; i < K * D * D; i += blockDim.x) sU[i] = U[i];
  for (int i = threadIdx.x; i < K * D; i += blockDim.x) sMu[i] = mu_u[i];
  for (int i = threadIdx.x; i < K; i += blockDim.x) sLd[i] = logdet[i];
  __syncthreads();

  const float d_log2pi = static_cast<float>(D * kLog2Pi);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       n < N; n += stride) {
    const T* xrow = X + n * D;
    float x[kMaxD];
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) x[d] = d < D ? load_f32(xrow + d) : 0.f;

    float best = 0.f;
    int32_t best_k = 0;
    bool best_nan = false;
    for (int k = 0; k < K; ++k) {
      const float* Uk = sU + k * D * D;
      float quad = 0.f;
      for (int e = 0; e < D; ++e) {
        // z_e = (x U_k)_e - (mu_k U_k)_e, the reference's order
        float xu = 0.f;
#pragma unroll
        for (int d = 0; d < kMaxD; ++d) {
          if (d < D) xu = fmaf(x[d], Uk[d * D + e], xu);
        }
        const float z = xu - sMu[k * D + e];
        quad = fmaf(z, z, quad);
      }
      const float lp = -0.5f * (d_log2pi + quad) + sLd[k];
      if (!BEST) {
        out[n * K + k] = lp;
      } else if (k == 0) {
        best = lp;
        best_nan = isnan(lp);
      } else if (!best_nan) {
        // strict > keeps the first index on ties; the first NaN wins and
        // sticks, as jnp.max / jnp.argmax (and torch.amax / argmax) do
        if (isnan(lp)) {
          best = lp;
          best_k = k;
          best_nan = true;
        } else if (lp > best) {
          best = lp;
          best_k = k;
        }
      }
    }
    if (BEST) {
      out[n] = best;
      arg[n] = best_k;
    }
  }
}

template <typename T, bool BEST>
int launch(const void* X, const void* U, const void* mu_u, const void* logdet,
           void* out, void* arg, int64_t N, int D, int K, void* stream) {
  if (N <= 0 || D < 1 || D > kMaxD || K < 1 || K > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * (static_cast<size_t>(K) * D * D +
                                       static_cast<size_t>(K) * D + K);
  auto kernel = gmm_kernel<T, BEST>;
  if (smem > kStaticSmemLimit) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int64_t blocks = (N + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const float*>(U),
      static_cast<const float*>(mu_u), static_cast<const float*>(logdet),
      static_cast<float*>(out), static_cast<int32_t*>(arg), N, D, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
extern "C" int gmm_score_launch(const void* X, int x_dtype, const void* U,
                                const void* mu_u, const void* logdet,
                                void* out, int64_t N, int D, int K,
                                void* stream) {
  if (x_dtype == 0)
    return launch<float, false>(X, U, mu_u, logdet, out, nullptr, N, D, K,
                                stream);
  if (x_dtype == 1)
    return launch<__nv_bfloat16, false>(X, U, mu_u, logdet, out, nullptr, N,
                                        D, K, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int gmm_best_launch(const void* X, int x_dtype, const void* U,
                               const void* mu_u, const void* logdet,
                               void* best, void* arg, int64_t N, int D, int K,
                               void* stream) {
  if (x_dtype == 0)
    return launch<float, true>(X, U, mu_u, logdet, best, arg, N, D, K, stream);
  if (x_dtype == 1)
    return launch<__nv_bfloat16, true>(X, U, mu_u, logdet, best, arg, N, D, K,
                                       stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
