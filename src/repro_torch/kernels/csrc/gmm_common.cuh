// Pieces shared by gmm_score.cu and gmm_stats.cu (Hopper, sm_90a).
//
// - Params: the GMM's parameters as the caller holds them. The kernels read
//   means, U (and log w) through their strides, so the transposed U that
//   the EM loop hands over (`_prec_chol_from_cov` returns L^-T as a view)
//   needs no copy.
// - load_params: every block forms mu_k U_k and log|det U_k| itself, from U
//   read into shared memory (K D^2 FMAs a block), so a wrapper call is one
//   launch with no torch op before it.
// - GMM_FIXED_SHAPES: the (D, K) pairs with specialised kernels. They cover
//   the features in use (D = 3 latency, D = 4 device and collective) with
//   K <= 4 components; the Python wrappers hold the same list
//   (`gmm_score.SPECIALISED`, checked against this one by the CPU tests).
// - WarpPipe / row_from_smem: in a specialised kernel each warp streams its
//   own tiles of 32 rows through a ring of kStages stages in shared memory.
//   A tile's contiguous span is copied with 16-byte cp.async (whatever D, so
//   12-byte rows at D = 3 too) while the warp computes on an earlier tile;
//   each lane then reads its row into registers with the widest aligned
//   shared-memory load. Warps sync with __syncwarp alone.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// (D, K) pairs with specialised kernels, as S(D, K).
#define GMM_FIXED_SHAPES(S)                 \
  S(2, 1) S(2, 2) S(2, 3) S(2, 4)           \
  S(3, 1) S(3, 2) S(3, 3) S(3, 4)           \
  S(4, 1) S(4, 2) S(4, 3) S(4, 4)

namespace gmm {

constexpr int kThreads = 256;  // threads of a block, rows of a tile
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;     // the specialised kernels' ring of tiles
constexpr int kMaxBlocks = 264;  // 2 blocks on each of the H100's 132 SMs
constexpr int kMaxD = 32;
constexpr int kMaxK = 16;
constexpr double kLog2Pi = 1.8378770664093453;  // log(2 pi)
constexpr size_t kStaticSmemLimit = 48 * 1024;

struct Params {
  const float* means;  // (K, D)
  int64_t ms0, ms1;
  const float* U;      // (K, D, D), Sigma_k^-1 = U_k U_k^T
  int64_t us0, us1, us2;
  const float* log_w;  // (K,); null for the scoring kernels
  int64_t lws;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Fills sU (K, D, D), sMuU (K, D) = mu_k U_k, sLd (K,) = log|det U_k| and,
// when p.log_w is set, sLw (K,); sMean (K, D) is scratch. Every thread of
// the block calls it; it ends with a barrier. A NaN U gives NaN mu U and
// log|det U|, as `ref._log_prob` does. kD, kK > 0 fix the shape at compile
// time (the specialised kernels); 0 takes D and K at run time.
template <int kD = 0, int kK = 0>
__device__ __forceinline__ void load_params(const Params& p, int D_, int K_,
                                            float* sU, float* sMean,
                                            float* sMuU, float* sLd,
                                            float* sLw) {
  const int D = kD > 0 ? kD : D_, K = kK > 0 ? kK : K_;
  const int DD = D * D;
  for (int i = threadIdx.x; i < K * DD; i += blockDim.x) {
    const int k = i / DD, d = (i / D) % D, e = i % D;
    sU[i] = p.U[k * p.us0 + d * p.us1 + e * p.us2];
  }
  for (int i = threadIdx.x; i < K * D; i += blockDim.x) {
    sMean[i] = p.means[(i / D) * p.ms0 + (i % D) * p.ms1];
  }
  if (p.log_w != nullptr) {
    for (int k = threadIdx.x; k < K; k += blockDim.x) sLw[k] = p.log_w[k * p.lws];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K * D; i += blockDim.x) {
    const int k = i / D, e = i % D;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(sMean[k * D + d], sU[k * DD + d * D + e], acc);
    sMuU[i] = acc;
  }
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s += logf(fabsf(sU[k * DD + d * D + d]));
    sLd[k] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts copying warp tile `wt` (the 32 rows [32 wt, 32 wt + 32) below
// n_rows) of X (D elements of T a row) into dst, a 16-byte aligned buffer;
// called by every lane of a warp. When X is 16-byte aligned every warp
// tile's span is too (32 D sizeof(T) is a multiple of 16): its body goes by
// one 16-byte cp.async a lane (at most 32 of them for D <= 4), the last
// few elements of a ragged tile by plain loads. An unaligned X (a view at
// an odd row) is copied element by element. A tile past the end is nothing.
template <typename T, int D>
__device__ __forceinline__ void issue_warp_tile(T* dst,
                                                const T* __restrict__ X,
                                                int64_t wt, int64_t n_rows,
                                                bool vec) {
  constexpr int V = 16 / sizeof(T);
  static_assert(32 * D * sizeof(T) <= 32 * 16, "one 16-byte copy a lane");
  const int64_t row0 = wt * 32;
  if (row0 >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int count = (n_rows - row0 < 32 ? static_cast<int>(n_rows - row0)
                                        : 32) * D;
  const T* src = X + row0 * D;
  const int nvec = vec ? count / V : 0;
  if (lane < nvec) cp_async16(dst + lane * V, src + lane * V);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const int i = nvec * V + lane + 32 * j;
    if (i < count) dst[i] = src[i];
  }
}

// A warp's pipeline of row tiles, for the specialised kernels. Each warp
// streams its own tiles of 32 rows, grid-stride over all the grid's warps
// (warp tile w, w + wstep, ... with wstep = gridDim.x * kWarps), through a
// ring of kStages tiles in shared memory (declared as bytes, 16-byte
// aligned, so that no constructor of T runs on shared memory). A tile's
// copies are one cp.async group of each lane, so a warp waits on its own
// copies and syncs with __syncwarp alone: no block barrier in the loop, and
// the warps of a block run at their own pace.
template <typename T, int D>
struct WarpPipe {
  static constexpr int kTileElems = 32 * D;
  alignas(16) unsigned char bytes[kWarps][kStages * kTileElems * sizeof(T)];

  __device__ __forceinline__ T* tile(int warp, int slot) {
    return reinterpret_cast<T*>(bytes[warp]) + slot * kTileElems;
  }
  // starts copying warp tile wt into `slot`
  __device__ __forceinline__ void issue(int warp, int slot, const T* X,
                                        int64_t wt, int64_t n_rows,
                                        bool vec) {
    issue_warp_tile<T, D>(tile(warp, slot), X, wt, n_rows, vec);
    cp_async_commit();
  }
};

// One row of a tile from shared memory into registers, by float4 / float2
// (or bf16 pairs) where D allows it. A row starts at r * D * sizeof(T)
// bytes into a 16-byte aligned buffer, so each vector load is aligned.
template <int D>
__device__ __forceinline__ void row_from_smem(const float* s, float (&x)[D]) {
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 v = *reinterpret_cast<const float4*>(s + d);
      x[d] = v.x; x[d + 1] = v.y; x[d + 2] = v.z; x[d + 3] = v.w;
    }
  } else if constexpr (D % 2 == 0) {
#pragma unroll
    for (int d = 0; d < D; d += 2) {
      const float2 v = *reinterpret_cast<const float2*>(s + d);
      x[d] = v.x; x[d + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) x[d] = s[d];
  }
}
template <int D>
__device__ __forceinline__ void row_from_smem(const __nv_bfloat16* s,
                                              float (&x)[D]) {
  if constexpr (D % 2 == 0) {
#pragma unroll
    for (int d = 0; d < D; d += 2) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(s + d));
      x[d] = v.x; x[d + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) x[d] = __bfloat162float(s[d]);
  }
}

// z_e = (x U_k)_e - (mu_k U_k)_e, the reference's order, fully unrolled;
// returns log N(x | mu_k, Sigma_k) = -1/2 (D log 2pi + |z|^2) + log|det U_k|.
template <int D>
__device__ __forceinline__ float log_density(const float (&x)[D],
                                             const float (&u)[D][D],
                                             const float (&mu)[D], float ld,
                                             float d_log2pi) {
  float quad = 0.f;
#pragma unroll
  for (int e = 0; e < D; ++e) {
    float xu = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) xu = fmaf(x[d], u[d][e], xu);
    const float z = xu - mu[e];
    quad = fmaf(z, z, quad);
  }
  return -0.5f * (d_log2pi + quad) + ld;
}

// The parameters of a specialised kernel, copied from shared memory into
// registers once a block (every index a compile-time constant).
template <int D, int K>
struct FixedParams {
  float u[K][D][D];
  float mu[K][D];
  float ld[K];

  __device__ __forceinline__ void load(const float* sU, const float* sMuU,
                                       const float* sLd) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
#pragma unroll
        for (int e = 0; e < D; ++e) u[k][d][e] = sU[(k * D + d) * D + e];
        mu[k][d] = sMuU[k * D + d];
      }
      ld[k] = sLd[k];
    }
  }
};

inline unsigned fixed_grid(int64_t n_rows) {
  const int64_t tiles = (n_rows + kThreads - 1) / kThreads;
  return static_cast<unsigned>(tiles < kMaxBlocks ? tiles : kMaxBlocks);
}

template <typename F>
int set_smem(F* kernel, size_t smem) {
  if (smem <= kStaticSmemLimit) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace gmm
