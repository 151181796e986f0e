// GMM log densities and Definition-1 scoring on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   score_* <BEST = false> <- repro/kernels/gmm_score.py::_score_kernel (gmm_score_pallas)
//   score_* <BEST = true>  <- repro/kernels/gmm_score.py::_best_kernel  (gmm_best_pallas)
//
// For each row x of X (N, D) and each component k:
//   log N(x | mu_k, Sigma_k) = -1/2 (D log 2pi + |x U_k - mu_k U_k|^2) + logdet_k
// with Sigma_k^-1 = U_k U_k^T. gmm_score writes the (N, K) densities;
// gmm_best the best density of each row and its first index (ties go to
// the first component, the first NaN wins and sticks, as jnp.argmax).
//
// What bounds it on this card, and what the design does about it:
//
// - At the paths' N (a few hundred rows a layer, one tile) a call is one
//   launch and its dependent chain. So a wrapper call is ONE kernel: each
//   block forms mu_k U_k and log|det U_k| from U itself (load_params, K D^2
//   FMAs), reading means and U through their strides, so the transposed U
//   of the EM loop is never copied and no torch op runs before the launch.
//   The first tiles' copies start before that prologue and overlap it.
// - At large N it is bound by device-memory bytes: ~K (2 D^2 + 3 D + 3)
//   flops a row against 4 D bytes read and 4 K (score) or 8 (best) bytes
//   written, ~5 flops a byte under the card's float32 ridge of ~20. The
//   TPU version ran the contraction on the matrix unit; at D <= 4 it is far
//   below a tensor-core tile, so each thread owns a row. For the (D, K) in
//   use (GMM_FIXED_SHAPES) the kernel is specialised: the row, U, mu U and
//   log|det U| live in registers, the K D^2 contraction is fully unrolled
//   with no predicate and no shared-memory read; each warp streams its own
//   tiles of 32 rows through a 4-deep ring in shared memory by 16-byte
//   cp.async of the tile's contiguous span (12-byte rows at D = 3
//   included), with no block barrier in the loop; the (N, K) output goes
//   out coalesced, one vector store a row for K = 1, 2, 4 and through
//   shared memory for K = 3. The grid is at most 264 blocks, two on each
//   SM, each walking its tiles, so the prologue is paid once a block.
// - Other shapes (up to D = 32, K = 16) take the general kernel: one row a
//   thread, the parameters in shared memory, loops over d bounded by
//   kMaxD under a predicate. Shared memory: K D^2 + 2 K D + K floats,
//   69,696 bytes at D = 32, K = 16, with the dynamic-shared-memory opt-in.
//
// Blocks carry nothing between them: no cross-block reduction, no atomics.
// The wrapper picks the variant (`gmm_score.SPECIALISED`); a specialised
// call for a (D, K) without an instantiation returns cudaErrorInvalidValue.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes; each launcher returns cudaGetLastError().

#include "gmm_common.cuh"

namespace {

using namespace gmm;

// A row's best density and its first index over the components in order.
struct Best {
  float best = 0.f;
  int32_t arg = 0;
  bool nan = false;

  __device__ __forceinline__ void add(int k, float lp) {
    if (k == 0) {
      best = lp;
      nan = isnan(lp);
    } else if (!nan) {
      // strict > keeps the first index on ties; the first NaN wins and
      // sticks, as jnp.max / jnp.argmax (and torch.amax / argmax) do
      if (isnan(lp)) {
        best = lp;
        arg = k;
        nan = true;
      } else if (lp > best) {
        best = lp;
        arg = k;
      }
    }
  }
};

// BEST = false: out is (N, K) log densities.
// BEST = true:  out is (N,) best log density and arg (N,) its first index.
template <typename T, int D, int K, bool BEST>
__global__ void __launch_bounds__(kThreads, 2)
score_fixed(const T* __restrict__ X, Params p, float* __restrict__ out,
            int32_t* __restrict__ arg, int64_t N) {
  constexpr bool kStageOut = !BEST && K == 3;  // 12-byte rows: via smem
  __shared__ WarpPipe<T, D> pipe;
  __shared__ __align__(16) float sOut[kStageOut ? kWarps : 1]
                                     [kStageOut ? 32 * K : 4];
  __shared__ float sU[K * D * D], sMean[K * D], sMuU[K * D], sLd[K];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool vec = (reinterpret_cast<uintptr_t>(X) & 15) == 0;
  const bool vec_out = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int64_t ntiles = (N + 31) / 32;
  const int64_t wstep = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    pipe.issue(warp, s, X, w0 + s * wstep, N, vec);
  }
  load_params<D, K>(p, D, K, sU, sMean, sMuU, sLd, nullptr);
  FixedParams<D, K> prm;
  prm.load(sU, sMuU, sLd);
  const float d_log2pi = static_cast<float>(D * kLog2Pi);

  int slot = 0;
  for (int64_t t = w0; t < ntiles; t += wstep) {
    cp_async_wait<kStages - 2>();  // this lane's copies of the tile ...
    __syncwarp();  // ... and the other lanes'; all are done with the last
    pipe.issue(warp, (slot + kStages - 1) % kStages, X,
               t + (kStages - 1) * wstep, N, vec);

    const int64_t row0 = t * 32;
    const int64_t n = row0 + lane;
    if (n < N) {
      float x[D];
      row_from_smem<D>(pipe.tile(warp, slot) + lane * D, x);
      float lp[K];
      Best b;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        lp[k] = log_density<D>(x, prm.u[k], prm.mu[k], prm.ld[k], d_log2pi);
        if (BEST) b.add(k, lp[k]);
      }
      if constexpr (BEST) {
        out[n] = b.best;
        arg[n] = b.arg;
      } else if constexpr (kStageOut) {
#pragma unroll
        for (int k = 0; k < K; ++k) sOut[warp][lane * K + k] = lp[k];
      } else if constexpr (K == 4) {
        if (vec_out) {
          reinterpret_cast<float4*>(out)[n] =
              make_float4(lp[0], lp[1], lp[2], lp[3]);
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) out[n * K + k] = lp[k];
        }
      } else if constexpr (K == 2) {
        if (vec_out) {
          reinterpret_cast<float2*>(out)[n] = make_float2(lp[0], lp[1]);
        } else {
          out[n * 2] = lp[0];
          out[n * 2 + 1] = lp[1];
        }
      } else {
        out[n] = lp[0];
      }
    }
    if constexpr (kStageOut) {
      // the tile's span of out (32 rows of 12 bytes) starts 16-byte aligned
      __syncwarp();
      const int count = (N - row0 < 32 ? static_cast<int>(N - row0) : 32) * K;
      float* dst = out + row0 * K;
      const int nvec = vec_out ? count / 4 : 0;
      if (lane < nvec) {
        reinterpret_cast<float4*>(dst)[lane] =
            reinterpret_cast<const float4*>(sOut[warp])[lane];
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int i = nvec * 4 + lane + 32 * j;
        if (i < count) dst[i] = sOut[warp][i];
      }
    }
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
  cp_async_wait<0>();
}

template <typename T, bool BEST>
__global__ void __launch_bounds__(kThreads)
score_general(const T* __restrict__ X, Params p, float* __restrict__ out,
              int32_t* __restrict__ arg, int64_t N, int D, int K) {
  extern __shared__ float smem[];
  float* sU = smem;             // (K, D, D)
  float* sMean = sU + K * D * D;  // (K, D)
  float* sMu = sMean + K * D;   // (K, D)
  float* sLd = sMu + K * D;     // (K,)
  load_params(p, D, K, sU, sMean, sMu, sLd, nullptr);

  const float d_log2pi = static_cast<float>(D * kLog2Pi);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       n < N; n += stride) {
    const T* xrow = X + n * D;
    float x[kMaxD];
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) x[d] = d < D ? to_f32(xrow[d]) : 0.f;

    Best b;
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
      } else {
        b.add(k, lp);
      }
    }
    if (BEST) {
      out[n] = b.best;
      arg[n] = b.arg;
    }
  }
}

template <typename T, bool BEST>
int launch(const void* Xv, const Params& p, void* outv, void* argv,
           int64_t N, int D, int K, bool specialised, void* stream) {
  if (N <= 0 || D < 1 || D > kMaxD || K < 1 || K > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* X = static_cast<const T*>(Xv);
  float* out = static_cast<float*>(outv);
  int32_t* arg = static_cast<int32_t*>(argv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = fixed_grid(N);
  if (specialised) {
#define GMM_CASE(d, k)                                                    \
  if (D == d && K == k) {                                                 \
    score_fixed<T, d, k, BEST><<<blocks, kThreads, 0, s>>>(X, p, out, arg, \
                                                          N);             \
    return static_cast<int>(cudaGetLastError());                          \
  }
    GMM_FIXED_SHAPES(GMM_CASE)
#undef GMM_CASE
    return static_cast<int>(cudaErrorInvalidValue);  // no such instantiation
  }
  const size_t smem = sizeof(float) * (static_cast<size_t>(K) * D * D +
                                       2 * static_cast<size_t>(K) * D + K);
  auto kernel = score_general<T, BEST>;
  const int err = set_smem(kernel, smem);
  if (err) return err;
  kernel<<<blocks, kThreads, smem, s>>>(X, p, out, arg, N, D, K);
  return static_cast<int>(cudaGetLastError());
}

template <bool BEST>
int dispatch(const void* X, int x_dtype, const void* means, int64_t ms0,
             int64_t ms1, const void* U, int64_t us0, int64_t us1,
             int64_t us2, void* out, void* arg, int64_t N, int D, int K,
             int specialised, void* stream) {
  const Params p{static_cast<const float*>(means), ms0, ms1,
                 static_cast<const float*>(U), us0, us1, us2, nullptr, 0};
  if (x_dtype == 0)
    return launch<float, BEST>(X, p, out, arg, N, D, K, specialised != 0,
                               stream);
  if (x_dtype == 1)
    return launch<__nv_bfloat16, BEST>(X, p, out, arg, N, D, K,
                                       specialised != 0, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16. means (K, D) and U (K, D, D) are
// float32 with the given strides, in elements. specialised: 1 for the
// kernel specialised on (D, K), 0 for the general one. Returns a
// cudaError_t (0 = success).
extern "C" int gmm_score_launch(const void* X, int x_dtype, const void* means,
                                int64_t ms0, int64_t ms1, const void* U,
                                int64_t us0, int64_t us1, int64_t us2,
                                void* out, int64_t N, int D, int K,
                                int specialised, void* stream) {
  return dispatch<false>(X, x_dtype, means, ms0, ms1, U, us0, us1, us2, out,
                         nullptr, N, D, K, specialised, stream);
}

extern "C" int gmm_best_launch(const void* X, int x_dtype, const void* means,
                               int64_t ms0, int64_t ms1, const void* U,
                               int64_t us0, int64_t us1, int64_t us2,
                               void* best, void* arg, int64_t N, int D, int K,
                               int specialised, void* stream) {
  return dispatch<true>(X, x_dtype, means, ms0, ms1, U, us0, us1, us2, best,
                        arg, N, D, K, specialised, stream);
}
