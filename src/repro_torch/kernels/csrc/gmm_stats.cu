// GMM E-step sufficient statistics and the fused EM iteration on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   gmm_stats_launch  <- repro/kernels/gmm_stats.py::_stats_kernel  (gmm_stats_pallas)
//   gmm_update_launch <- repro/kernels/gmm_stats.py::_update_kernel (gmm_update_pallas)
// Both share the E-step body `_accumulate_estep`. For the rows n < nvalid of
// X (N, D) and components k, with log p_nk = log N(x_n | mu_k, Sigma_k):
//   resp_nk = softmax_k(log w_k + log p_nk),  norm_n = logsumexp_k(...)
//   nk_k = sum_n resp_nk            sx_kd  = sum_n resp_nk x_nd
//   sxx_kde = sum_n resp_nk x_nd x_ne           ll = sum_n norm_n
// gmm_update adds the M-step: mu = sx / (nk + 1e-10),
// Sigma = sxx / (nk + 1e-10) - mu mu^T, and returns nk without the 1e-10.
// The wrapper forms mu_k U_k and log|det U_k| with torch before the launch,
// as the Pallas wrapper's `_prepare` does.
//
// The TPU kernel keeps its accumulators in scratch across a grid that runs
// in order: it zeroes them at program 0, adds in every block and finishes
// the M-step in the last. CUDA blocks run in parallel and in no order, so
// the work is split in two launches with no float atomics:
//
//   pass 1 (estep_partials): each block walks its tiles of kThreads rows
//     (grid-stride). The tile's valid rows are copied into shared memory
//     with coalesced loads (rows >= nvalid are never loaded); each thread
//     then turns one row into its responsibilities and log-sum-exp norm,
//     also kept in shared memory. Then every thread owns fixed output
//     entries -- one entry of (nk, sx, sxx, ll) over one contiguous group
//     of the tile's rows -- and sums them in row order into an accumulator
//     in shared memory. When the output is smaller than the block (E <
//     kThreads), the tile's rows are split into G groups so that every
//     thread has work. At the end a block sums its groups in order and
//     writes its partial vector (E floats) to a workspace the wrapper
//     allocated.
//   pass 2 (reduce_partials): one block sums the partials in block-index
//     order (in G2 contiguous ranges of blocks, then the ranges in order)
//     and, for gmm_update, applies the M-step before writing the outputs.
//
// Every sum runs in a fixed order, and the grid size is a function of N,
// D and K alone (never of the device), so two calls on the same input give
// bitwise equal outputs.
//
// Bound: the function needs K (3 D^2 + 6 D + 10) + 1 flops a row (the
// density K (2 D^2 + 3 D + 3), the responsibilities' log-sum-exp 6 K with
// exp counted as one, nk and sx K (1 + 2 D), sxx as the symmetric product
// K (D^2 + D), ll 1) for 4 D bytes read. At D = 4, K = 3 that is 247 flops
// per 16-byte row, ~15 flops a byte, against the card's float32 ridge of
// ~20 flops a byte, so at large N (2^20 rows) the kernels are bound by
// device-memory bytes: the design reads X once, with coalesced loads, and
// writes only the (K, D, D) outputs. At the streaming detector's N (2048 fit rows, 256-1024 bucket
// rows) a call is bound by its two launches, not by this arithmetic.
//
// Shared memory, pass 1: K*D*D + K*D + 2K + kThreads*(D + K + 1) + G*E
// floats, 185,540 bytes at the largest shape (D = 32, K = 16, E = 16,913);
// pass 2: G2*E (+ E when G2 > 1) floats. Above 48 KB each launch requests
// the dynamic-shared-memory opt-in.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes; each launcher returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 32;
constexpr int kMaxK = 16;
constexpr int kThreads = 256;
constexpr double kLog2Pi = 1.8378770664093453;  // log(2 pi)
constexpr size_t kStaticSmemLimit = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Output entries, in the order of the partial vector and of the outputs:
//   [0, K)                      nk_k
//   [K, K + K*D)                sx_kd
//   [K + K*D, K + K*D + K*D*D)  sxx_kde
//   E - 1                       ll
__host__ __device__ __forceinline__ int n_entries(int D, int K) {
  return K + K * D + K * D * D + 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
estep_partials(const T* __restrict__ X, const float* __restrict__ log_w,
               const float* __restrict__ U, const float* __restrict__ mu_u,
               const float* __restrict__ logdet, float* __restrict__ partial,
               int64_t n_eff, int D, int K, int G) {
  extern __shared__ float smem[];
  const int E = n_entries(D, K);
  float* sU = smem;                  // (K, D, D)
  float* sMu = sU + K * D * D;       // (K, D)
  float* sLd = sMu + K * D;          // (K,)
  float* sLw = sLd + K;              // (K,)
  float* sX = sLw + K;               // (kThreads, D) the tile's rows
  float* sR = sX + kThreads * D;     // (kThreads, K) responsibilities
  float* sN = sR + kThreads * K;     // (kThreads,) log-sum-exp norms
  float* sAcc = sN + kThreads;       // (G, E) this block's sums
  const int tid = threadIdx.x;
  for (int i = tid; i < K * D * D; i += kThreads) sU[i] = U[i];
  for (int i = tid; i < K * D; i += kThreads) sMu[i] = mu_u[i];
  for (int i = tid; i < K; i += kThreads) {
    sLd[i] = logdet[i];
    sLw[i] = log_w[i];
  }
  for (int i = tid; i < G * E; i += kThreads) sAcc[i] = 0.f;
  const int R = (kThreads + G - 1) / G;  // rows of a tile per group
  const float d_log2pi = static_cast<float>(D * kLog2Pi);
  __syncthreads();

  for (int64_t row0 = static_cast<int64_t>(blockIdx.x) * kThreads;
       row0 < n_eff; row0 += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int rows = static_cast<int>(
        n_eff - row0 < kThreads ? n_eff - row0 : kThreads);
    const T* src = X + row0 * D;
    for (int i = tid; i < rows * D; i += kThreads) sX[i] = to_f32(src[i]);
    __syncthreads();

    if (tid < rows) {
      const float* x = sX + tid * D;
      float logr[kMaxK];
      float m = -INFINITY;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) {
          const float* Uk = sU + k * D * D;
          float quad = 0.f;
          for (int e = 0; e < D; ++e) {
            // z_e = (x U_k)_e - (mu_k U_k)_e, the reference's order
            float xu = 0.f;
            for (int d = 0; d < D; ++d) xu = fmaf(x[d], Uk[d * D + e], xu);
            const float z = xu - sMu[k * D + e];
            quad = fmaf(z, z, quad);
          }
          logr[k] = (-0.5f * (d_log2pi + quad) + sLd[k]) + sLw[k];
          m = fmaxf(m, logr[k]);
        }
      }
      // a NaN density makes the sum, the norm and every responsibility
      // NaN, as jnp.max / logsumexp do in the reference
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) s += expf(logr[k] - m);
      }
      const float norm = m + logf(s);
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) sR[tid * K + k] = expf(logr[k] - norm);
      }
      sN[tid] = norm;
    }
    __syncthreads();

    for (int slot = tid; slot < G * E; slot += kThreads) {
      const int g = slot / E;
      const int e = slot - g * E;
      const int r0 = g * R;
      const int r1 = r0 + R < rows ? r0 + R : rows;
      float acc = 0.f;
      if (e < K) {
        for (int r = r0; r < r1; ++r) acc += sR[r * K + e];
      } else if (e < K + K * D) {
        const int k = (e - K) / D, d = (e - K) % D;
        for (int r = r0; r < r1; ++r)
          acc = fmaf(sR[r * K + k], sX[r * D + d], acc);
      } else if (e < E - 1) {
        const int j = e - K - K * D;
        const int k = j / (D * D), d = (j / D) % D, f = j % D;
        for (int r = r0; r < r1; ++r)
          acc = fmaf(sR[r * K + k] * sX[r * D + d], sX[r * D + f], acc);
      } else {
        for (int r = r0; r < r1; ++r) acc += sN[r];
      }
      sAcc[slot] += acc;
    }
    __syncthreads();  // the next tile overwrites sX, sR and sN
  }

  for (int e = tid; e < E; e += kThreads) {
    float tot = 0.f;
    for (int g = 0; g < G; ++g) tot += sAcc[g * E + e];
    partial[static_cast<int64_t>(blockIdx.x) * E + e] = tot;
  }
}

__global__ void __launch_bounds__(kThreads)
reduce_partials(const float* __restrict__ partial, int nb, int D, int K,
                int G2, bool m_step, float* __restrict__ nk,
                float* __restrict__ sx, float* __restrict__ sxx,
                float* __restrict__ ll) {
  extern __shared__ float smem[];
  const int E = n_entries(D, K);
  float* sPart = smem;                            // (G2, E)
  float* sTot = G2 > 1 ? sPart + G2 * E : sPart;  // (E,)
  const int tid = threadIdx.x;
  const int B = (nb + G2 - 1) / G2;  // blocks' partials per range
  for (int slot = tid; slot < G2 * E; slot += kThreads) {
    const int g = slot / E;
    const int e = slot - g * E;
    const int b1 = (g + 1) * B < nb ? (g + 1) * B : nb;
    float acc = 0.f;
    for (int b = g * B; b < b1; ++b)
      acc += partial[static_cast<int64_t>(b) * E + e];
    sPart[slot] = acc;
  }
  __syncthreads();
  if (G2 > 1) {
    for (int e = tid; e < E; e += kThreads) {
      float tot = 0.f;
      for (int g = 0; g < G2; ++g) tot += sPart[g * E + e];
      sTot[e] = tot;
    }
    __syncthreads();
  }

  for (int e = tid; e < E; e += kThreads) {
    const float v = sTot[e];
    if (e < K) {
      nk[e] = v;  // without the 1e-10, as the reference returns it
    } else if (e < K + K * D) {
      const int j = e - K, k = j / D;
      sx[j] = m_step ? v / (sTot[k] + 1e-10f) : v;
    } else if (e < E - 1) {
      const int j = e - K - K * D;
      if (m_step) {
        const int k = j / (D * D), d = (j / D) % D, f = j % D;
        const float den = sTot[k] + 1e-10f;
        const float mu_d = sTot[K + k * D + d] / den;
        const float mu_f = sTot[K + k * D + f] / den;
        // sxx / den - mu mu^T as two rounded steps, like the reference
        sxx[j] = __fsub_rn(v / den, __fmul_rn(mu_d, mu_f));
      } else {
        sxx[j] = v;
      }
    } else {
      ll[0] = v;
    }
  }
}

template <typename F>
int set_smem(F* kernel, size_t smem) {
  if (smem <= kStaticSmemLimit) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename T>
int launch(const void* X, const void* log_w, const void* U, const void* mu_u,
           const void* logdet, void* nk, void* sx, void* sxx, void* ll,
           void* work, int64_t N, int64_t nvalid, int D, int K, int nb,
           bool m_step, void* stream) {
  if (N < 0 || nvalid < 0 || D < 1 || D > kMaxD || K < 1 || K > kMaxK ||
      nb < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_eff = nvalid < N ? nvalid : N;
  const int E = n_entries(D, K);
  const int G = E < kThreads ? kThreads / E : 1;
  const size_t smem1 =
      sizeof(float) * (static_cast<size_t>(K) * D * D + K * D + 2 * K +
                       static_cast<size_t>(kThreads) * (D + K + 1) +
                       static_cast<size_t>(G) * E);
  const int G2 = E < kThreads ? kThreads / E : 1;
  const size_t smem2 =
      sizeof(float) * (static_cast<size_t>(G2) * E + (G2 > 1 ? E : 0));
  auto pass1 = estep_partials<T>;
  int err = set_smem(pass1, smem1);
  if (err) return err;
  err = set_smem(reduce_partials, smem2);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pass1<<<nb, kThreads, smem1, s>>>(
      static_cast<const T*>(X), static_cast<const float*>(log_w),
      static_cast<const float*>(U), static_cast<const float*>(mu_u),
      static_cast<const float*>(logdet), static_cast<float*>(work), n_eff, D,
      K, G);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  reduce_partials<<<1, kThreads, smem2, s>>>(
      static_cast<const float*>(work), nb, D, K, G2, m_step,
      static_cast<float*>(nk), static_cast<float*>(sx),
      static_cast<float*>(sxx), static_cast<float*>(ll));
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int x_dtype, const void* X, const void* log_w, const void* U,
             const void* mu_u, const void* logdet, void* nk, void* sx,
             void* sxx, void* ll, void* work, int64_t N, int64_t nvalid,
             int D, int K, int nb, bool m_step, void* stream) {
  if (x_dtype == 0)
    return launch<float>(X, log_w, U, mu_u, logdet, nk, sx, sxx, ll, work, N,
                         nvalid, D, K, nb, m_step, stream);
  if (x_dtype == 1)
    return launch<__nv_bfloat16>(X, log_w, U, mu_u, logdet, nk, sx, sxx, ll,
                                 work, N, nvalid, D, K, nb, m_step, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16. `work` holds nb * E floats, where nb
// is the pass-1 grid the wrapper computed (`grid_blocks`). Returns a
// cudaError_t (0 = success).
extern "C" int gmm_stats_launch(const void* X, int x_dtype, const void* log_w,
                                const void* U, const void* mu_u,
                                const void* logdet, void* nk, void* sx,
                                void* sxx, void* ll, void* work, int64_t N,
                                int64_t nvalid, int D, int K, int nb,
                                void* stream) {
  return dispatch(x_dtype, X, log_w, U, mu_u, logdet, nk, sx, sxx, ll, work,
                  N, nvalid, D, K, nb, false, stream);
}

// The same, with the M-step: `sx` receives the means, `sxx` the
// covariances.
extern "C" int gmm_update_launch(const void* X, int x_dtype,
                                 const void* log_w, const void* U,
                                 const void* mu_u, const void* logdet,
                                 void* nk, void* means, void* cov, void* ll,
                                 void* work, int64_t N, int64_t nvalid, int D,
                                 int K, int nb, void* stream) {
  return dispatch(x_dtype, X, log_w, U, mu_u, logdet, nk, means, cov, ll,
                  work, N, nvalid, D, K, nb, true, stream);
}
