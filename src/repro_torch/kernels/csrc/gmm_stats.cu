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
// The reference masks a padding row by multiplying its resp by 0, so a
// padding row whose E-step is not finite still makes nk, sx and sxx NaN
// (its norm is selected away: XLA turns that same-shape multiply by the
// mask into a select, so ll stays 0). With nvalid >= 1 the rows >= nvalid
// are skipped (never loaded). With nvalid = 0 and N > 0 every row is read
// and its resp weighted by 0 (`weight`) and its norm dropped, so the
// outputs are zeros, or NaN where the reference's are: a non-finite U,
// mean or padding row.
// gmm_update adds the M-step: mu = sx / (nk + 1e-10),
// Sigma = sxx / (nk + 1e-10) - mu mu^T, and returns nk without the 1e-10.
//
// What bounds it on this card, and what the design does about it:
//
// - At the streaming detector's N (2,048 fit rows, 256-1,024 bucket rows) a
//   call is bound by its launches and its dependent chain, not by the
//   arithmetic. So a wrapper call is ONE kernel (and a 4-byte memset):
//   - each block forms mu_k U_k and log|det U_k| from U itself
//     (load_params), reading means, U and log w through their strides, so
//     no torch op runs before the launch and the transposed U of the EM
//     loop is never copied;
//   - each block writes its partial sums to a workspace, fences, and takes
//     a ticket with an integer atomicAdd on a counter the launcher zeroed
//     (cudaMemsetAsync on the caller's stream: a memset node, captured
//     with the kernel into a CUDA graph). The block that draws the last
//     ticket sums all partials and applies gmm_update's M-step; the TPU
//     kernel did this in the last program of a grid that runs in order.
//     The partials are entry-major, so each warp of the last block reads
//     consecutive blocks' partials of its entries, coalesced, past L1
//     (__ldcg), with all of a lane's loads in flight at once; each lane
//     sums its blocks in order, then a shuffle tree.
//   There are no float atomics, and the grid (`grid_blocks` in the
//   wrapper, at most 264 blocks) is a function of (N, D, K) alone, so
//   every sum runs in an order fixed by the input: two calls, eager or
//   replayed in a graph, give bitwise equal outputs.
// - At large N (2^20 rows) it is bound by device-memory bytes: the function
//   needs K (3 D^2 + 6 D + 10) + 1 flops a row (the density K (2 D^2 + 3 D
//   + 3), the responsibilities' log-sum-exp 6 K with exp counted as one, nk
//   and sx K (1 + 2 D), sxx as the symmetric product K (D^2 + D), ll 1) for
//   4 D bytes read: 247 flops per 16-byte row at D = 4, K = 3, ~15 a byte
//   against the float32 ridge of ~20. For the (D, K) in use
//   (GMM_FIXED_SHAPES) the kernel is specialised: each warp streams its
//   own tiles of 32 rows through a 4-deep ring in shared memory by 16-byte
//   cp.async of the tile's span, with no block barrier in the loop (rows
//   >= nvalid are never loaded, but at nvalid = 0); the row, U, mu U, log|det U| and log w
//   live in registers and the density is fully unrolled; resp_k is
//   exp(logr_k - m) / s (K exps a row, not 2 K); each thread keeps its own
//   nk, sx, the symmetric half of sxx and ll in registers (K (1 + D + D (D
//   + 1) / 2) + 1 of them, 46 at D = 4, K = 3) over its rows, walked
//   grid-stride; the block reduces them in a fixed order, each warp by a
//   reduce-scatter of shuffles (P - P / 32 of them for P values, where a
//   tree takes 5 P) and then the warps in order through shared memory,
//   and the mirrored sxx entries are written from the same sum, so the
//   covariance is exactly symmetric. A kernel whose registers fit 128 asks
//   for two blocks an SM.
// - Other shapes (up to D = 32, K = 16) take the general kernel: the tile's
//   rows are copied into shared memory, each thread turns one row into its
//   responsibilities and norm there, then every thread owns fixed (output
//   entry, row group) slots and sums them in row order into a shared-memory
//   accumulator. Shared memory: K D^2 + 2 K D + 2 K + 256 (D + K + 1) +
//   G E floats (E = K + K D + K D^2 + 1, G = max(1, 256 / E)), 187,588
//   bytes at D = 32, K = 16, with the dynamic-shared-memory opt-in.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes; each launcher returns a cudaError_t.

#include "gmm_common.cuh"

namespace {

using namespace gmm;

// Entries of the general kernel's partial vector, in the order of the
// outputs:
//   [0, K)                      nk_k
//   [K, K + K*D)                sx_kd
//   [K + K*D, K + K*D + K*D*D)  sxx_kde
//   E - 1                       ll
// The specialised kernel keeps only the upper triangle d <= e of each
// sxx_k (tri(d, e) below), so its vector is shorter; the workspace holds
// the longer one.
__host__ __device__ constexpr int n_entries(int D, int K) {
  return K + K * D + K * D * D + 1;
}
__host__ __device__ constexpr int n_fixed_entries(int D, int K) {
  return K + K * D + K * D * (D + 1) / 2 + 1;
}
__host__ __device__ constexpr int tri(int d, int e, int D) {
  return d * D - d * (d - 1) / 2 + (e - d);
}

// Blocks a specialised kernel asks to keep resident on an SM: two when its
// registers (parameters, accumulators, a row and some slack) fit 128, else
// one, so that the compiler never has to spill to make room for two.
__host__ __device__ constexpr int em_min_blocks(int D, int K) {
  return K * D * D + K * D + 2 * K + n_fixed_entries(D, K) + D + K + 24 <= 112
             ? 2
             : 1;
}

// The outputs from the block totals tot (the full layout, or with kTri the
// specialised kernel's upper triangles), with gmm_update's M-step when
// m_step. kD, kK > 0 fix the shape at compile time; 0 takes D_ and K_.
template <bool kTri, int kD = 0, int kK = 0>
__device__ __forceinline__ void write_outputs(const float* tot, int D_, int K_,
                                              bool m_step, float* nk,
                                              float* sx, float* sxx,
                                              float* ll) {
  const int D = kD > 0 ? kD : D_, K = kK > 0 ? kK : K_;
  const int E = kTri ? n_fixed_entries(D, K) : n_entries(D, K);
  const int per_k = kTri ? D * (D + 1) / 2 : D * D;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    nk[i] = tot[i];  // without the 1e-10, as the reference returns it
  }
  for (int i = threadIdx.x; i < K * D; i += blockDim.x) {
    const int k = i / D;
    sx[i] = m_step ? tot[K + i] / (tot[k] + 1e-10f) : tot[K + i];
  }
  for (int i = threadIdx.x; i < K * D * D; i += blockDim.x) {
    const int k = i / (D * D), d = (i / D) % D, f = i % D;
    const int j = kTri ? tri(d < f ? d : f, d < f ? f : d, D) : d * D + f;
    const float v = tot[K + K * D + k * per_k + j];
    if (m_step) {
      const float den = tot[k] + 1e-10f;
      const float mu_d = tot[K + k * D + d] / den;
      const float mu_f = tot[K + k * D + f] / den;
      // sxx / den - mu mu^T as two rounded steps, like the reference
      sxx[i] = __fsub_rn(v / den, __fmul_rn(mu_d, mu_f));
    } else {
      sxx[i] = v;
    }
  }
  if (threadIdx.x == 0) ll[0] = tot[E - 1];
}

// The sum of v over a warp's lanes, in a fixed order (every lane gets it).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// The warp's sums of a thread's P values (P a multiple of 32), by recursive
// halving: at each of the 5 levels a lane keeps half of its vector and
// trades the other half with its partner, so a warp makes P - P / 32
// shuffles, not 5 P. Afterwards lane l holds, in v[0, P / 32), the warp
// totals of the entries l P / 32 + i. The order of every sum is fixed.
template <int L, int P>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[P], int lane) {
  if constexpr (L > P / 32) {  // the level that halves L, offset 16 L / P
    constexpr int o = 16 * L / P;
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < L / 2; ++i) {
      const float give = upper ? v[i] : v[i + L / 2];
      const float keep = upper ? v[i + L / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, give, o);
    }
    warp_reduce_scatter<L / 2, P>(v, lane);
  }
}

// After a block has written its partials (every thread fenced its own
// writes): true in the one block that draws the last ticket.
__device__ __forceinline__ bool is_last_block(unsigned* ticket) {
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

// In the last block: the partials of all blocks (entry-major: entry e of
// block b at partial[e * gridDim.x + b]) summed into tot (shared), read
// past L1. Warp w takes the entries w, w + kWarps, ...; its lanes read
// consecutive blocks' partials (coalesced), all of a lane's entries at
// once, each lane sums its blocks in order, then a shuffle tree: the order
// is fixed by the grid alone. kE > 0 is the specialised kernel's entry
// count (the entries of a lane unrolled, their loads in flight together);
// kE = 0 takes the general kernel's E at run time.
template <int kE>
__device__ __forceinline__ void sum_partials(const float* partial, float* tot,
                                             int E = kE) {
  const int nb = gridDim.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (kE > 0) {
    constexpr int kPer = (kE + kWarps - 1) / kWarps;
    float v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] = 0.f;
    for (int b = lane; b < nb; b += 32) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int e = warp + j * kWarps;
        if (e < kE) v[j] += __ldcg(partial + static_cast<int64_t>(e) * nb + b);
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float t = warp_sum(v[j]);
      const int e = warp + j * kWarps;
      if (lane == 0 && e < kE) tot[e] = t;
    }
  } else {
    for (int e = warp; e < E; e += kWarps) {
      const float* col = partial + static_cast<int64_t>(e) * nb;
      float v = 0.f;
      for (int b = lane; b < nb; b += 32) v += __ldcg(col + b);
      v = warp_sum(v);
      if (lane == 0) tot[e] = v;
    }
  }
}

template <typename T, int D, int K>
__global__ void __launch_bounds__(kThreads, em_min_blocks(D, K))
em_fixed(const T* __restrict__ X, Params p, int64_t n_eff, bool m_step,
         float weight, float* __restrict__ nk, float* __restrict__ sx,
         float* __restrict__ sxx, float* __restrict__ ll,
         float* partial, unsigned* __restrict__ ticket) {
  constexpr int E = n_fixed_entries(D, K);
  constexpr int P = (E + 31) / 32 * 32;  // E padded for the reduce-scatter
  constexpr int kSx = K, kSxx = K + K * D, kTri = D * (D + 1) / 2;
  __shared__ WarpPipe<T, D> pipe;
  __shared__ float sU[K * D * D], sMean[K * D], sMuU[K * D], sLd[K], sLw[K];
  __shared__ float sRed[kWarps][P];
  __shared__ float sTot[E];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool vec = (reinterpret_cast<uintptr_t>(X) & 15) == 0;
  const int64_t ntiles = (n_eff + 31) / 32;
  const int64_t wstep = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    pipe.issue(warp, s, X, w0 + s * wstep, n_eff, vec);
  }
  load_params<D, K>(p, D, K, sU, sMean, sMuU, sLd, sLw);
  FixedParams<D, K> prm;
  prm.load(sU, sMuU, sLd);
  float lw[K];
#pragma unroll
  for (int k = 0; k < K; ++k) lw[k] = sLw[k];
  const float d_log2pi = static_cast<float>(D * kLog2Pi);

  float acc[P];
#pragma unroll
  for (int e = 0; e < P; ++e) acc[e] = 0.f;

  int slot = 0;
  for (int64_t t = w0; t < ntiles; t += wstep) {
    cp_async_wait<kStages - 2>();  // this lane's copies of the tile ...
    __syncwarp();  // ... and the other lanes'; all are done with the last
    pipe.issue(warp, (slot + kStages - 1) % kStages, X,
               t + (kStages - 1) * wstep, n_eff, vec);
    if (t * 32 + lane < n_eff) {
      float x[D];
      row_from_smem<D>(pipe.tile(warp, slot) + lane * D, x);
      float logr[K];
      float m = -INFINITY;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        logr[k] = log_density<D>(x, prm.u[k], prm.mu[k], prm.ld[k],
                                 d_log2pi) + lw[k];
        m = fmaxf(m, logr[k]);
      }
      // a NaN density makes the sum, the norm and every responsibility
      // NaN, as jnp.max / logsumexp do in the reference. resp_k is
      // exp(logr_k - m) / s, the reference's exp(logr_k - norm) without a
      // second exp (and without the rounding of log s inside it)
      float ek[K];
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        ek[k] = expf(logr[k] - m);
        s += ek[k];
      }
      // weight is 1, or 0 for nvalid = 0 (the reference's mask)
      const float norm = weight != 0.f ? m + logf(s) : 0.f;
      const float inv_s = __frcp_rn(s);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float rk = ek[k] * inv_s * weight;
        acc[k] += rk;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float rx = rk * x[d];
          acc[kSx + k * D + d] += rx;
#pragma unroll
          for (int f = d; f < D; ++f) {
            float& a = acc[kSxx + k * kTri + tri(d, f, D)];
            a = fmaf(rx, x[f], a);
          }
        }
      }
      acc[E - 1] += norm;
    }
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
  cp_async_wait<0>();

  // the block's sums in a fixed order: each warp's by reduce-scatter, then
  // the warps in order
  warp_reduce_scatter<P, P>(acc, lane);
#pragma unroll
  for (int i = 0; i < P / 32; ++i) sRed[warp][lane * (P / 32) + i] = acc[i];
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += sRed[w][e];
    partial[static_cast<int64_t>(e) * gridDim.x + blockIdx.x] = v;
  }
  if (is_last_block(ticket)) {
    sum_partials<E>(partial, sTot);
    __syncthreads();
    write_outputs<true, D, K>(sTot, D, K, m_step, nk, sx, sxx, ll);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
em_general(const T* __restrict__ X, Params p, int64_t n_eff, bool m_step,
           int D, int K, int G, float weight, float* __restrict__ nk,
           float* __restrict__ sx, float* __restrict__ sxx,
           float* __restrict__ ll, float* partial,
           unsigned* __restrict__ ticket) {
  extern __shared__ float smem[];
  const int E = n_entries(D, K);
  float* sU = smem;                  // (K, D, D)
  float* sMean = sU + K * D * D;     // (K, D)
  float* sMu = sMean + K * D;        // (K, D)
  float* sLd = sMu + K * D;          // (K,)
  float* sLw = sLd + K;              // (K,)
  float* sX = sLw + K;               // (kThreads, D) the tile's rows
  float* sR = sX + kThreads * D;     // (kThreads, K) responsibilities
  float* sN = sR + kThreads * K;     // (kThreads,) log-sum-exp norms
  float* sAcc = sN + kThreads;       // (G, E) this block's sums
  const int tid = threadIdx.x;
  for (int i = tid; i < G * E; i += kThreads) sAcc[i] = 0.f;
  load_params(p, D, K, sU, sMean, sMu, sLd, sLw);
  const int R = (kThreads + G - 1) / G;  // rows of a tile per group
  const float d_log2pi = static_cast<float>(D * kLog2Pi);

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
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) s += expf(logr[k] - m);
      }
      const float norm = m + logf(s);
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) sR[tid * K + k] = expf(logr[k] - norm) * weight;
      }
      sN[tid] = weight != 0.f ? norm : 0.f;
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
    partial[static_cast<int64_t>(e) * gridDim.x + blockIdx.x] = tot;
  }
  if (is_last_block(ticket)) {  // its shared memory holds >= E floats
    sum_partials<0>(partial, smem, E);
    __syncthreads();
    write_outputs<false>(smem, D, K, m_step, nk, sx, sxx, ll);
  }
}

template <typename T>
int launch(const void* Xv, const Params& p, void* nk, void* sx, void* sxx,
           void* ll, void* work, int64_t N, int64_t nvalid, int D, int K,
           int nb, bool m_step, bool specialised, void* stream) {
  if (N < 0 || nvalid < 0 || D < 1 || D > kMaxD || K < 1 || K > kMaxK ||
      nb < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* X = static_cast<const T*>(Xv);
  // nvalid = 0: every row, weighted by 0 (see the head of the file)
  const bool masked = nvalid == 0 && N > 0;
  const int64_t n_eff = masked ? N : nvalid < N ? nvalid : N;
  const float weight = masked ? 0.f : 1.f;
  float* partial = static_cast<float*>(work);
  // the ticket counter sits after the nb * E partials of the longer layout
  unsigned* ticket = reinterpret_cast<unsigned*>(
      partial + static_cast<int64_t>(nb) * n_entries(D, K));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o[4] = {static_cast<float*>(nk), static_cast<float*>(sx),
                 static_cast<float*>(sxx), static_cast<float*>(ll)};
  if (specialised) {
#define GMM_CASE(d, k)                                                     \
  if (D == d && K == k) {                                                  \
    cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned), s);     \
    if (err != cudaSuccess) return static_cast<int>(err);                  \
    em_fixed<T, d, k><<<nb, kThreads, 0, s>>>(X, p, n_eff, m_step, weight, \
                                              o[0], o[1], o[2], o[3],      \
                                              partial, ticket);            \
    return static_cast<int>(cudaGetLastError());                           \
  }
    GMM_FIXED_SHAPES(GMM_CASE)
#undef GMM_CASE
    return static_cast<int>(cudaErrorInvalidValue);  // no such instantiation
  }
  const int E = n_entries(D, K);
  const int G = E < kThreads ? kThreads / E : 1;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(K) * D * D + 2 * K * D + 2 * K +
                       static_cast<size_t>(kThreads) * (D + K + 1) +
                       static_cast<size_t>(G) * E);
  auto kernel = em_general<T>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  err = static_cast<int>(cudaMemsetAsync(ticket, 0, sizeof(unsigned), s));
  if (err) return err;
  kernel<<<nb, kThreads, smem, s>>>(X, p, n_eff, m_step, D, K, G, weight,
                                    o[0], o[1], o[2], o[3], partial, ticket);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* X, int x_dtype, const void* log_w, int64_t lws,
             const void* means, int64_t ms0, int64_t ms1, const void* U,
             int64_t us0, int64_t us1, int64_t us2, void* nk, void* sx,
             void* sxx, void* ll, void* work, int64_t N, int64_t nvalid,
             int D, int K, int nb, bool m_step, int specialised,
             void* stream) {
  const Params p{static_cast<const float*>(means), ms0, ms1,
                 static_cast<const float*>(U), us0, us1, us2,
                 static_cast<const float*>(log_w), lws};
  if (x_dtype == 0)
    return launch<float>(X, p, nk, sx, sxx, ll, work, N, nvalid, D, K, nb,
                         m_step, specialised != 0, stream);
  if (x_dtype == 1)
    return launch<__nv_bfloat16>(X, p, nk, sx, sxx, ll, work, N, nvalid, D,
                                 K, nb, m_step, specialised != 0, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16. log_w (K,), means (K, D) and U
// (K, D, D) are float32 with the given strides, in elements. `work` holds
// nb * (K + K D + K D^2 + 1) floats and one 32-bit counter after them, where
// nb is the grid the wrapper computed (`grid_blocks`). specialised: 1 for
// the kernel specialised on (D, K), 0 for the general one. Returns a
// cudaError_t (0 = success).
extern "C" int gmm_stats_launch(const void* X, int x_dtype, const void* log_w,
                                int64_t lws, const void* means, int64_t ms0,
                                int64_t ms1, const void* U, int64_t us0,
                                int64_t us1, int64_t us2, void* nk, void* sx,
                                void* sxx, void* ll, void* work, int64_t N,
                                int64_t nvalid, int D, int K, int nb,
                                int specialised, void* stream) {
  return dispatch(X, x_dtype, log_w, lws, means, ms0, ms1, U, us0, us1, us2,
                  nk, sx, sxx, ll, work, N, nvalid, D, K, nb, false,
                  specialised, stream);
}

// The same, with the M-step: `sx` receives the means, `sxx` the
// covariances.
extern "C" int gmm_update_launch(const void* X, int x_dtype,
                                 const void* log_w, int64_t lws,
                                 const void* means, int64_t ms0, int64_t ms1,
                                 const void* U, int64_t us0, int64_t us1,
                                 int64_t us2, void* nk, void* means_out,
                                 void* cov, void* ll, void* work, int64_t N,
                                 int64_t nvalid, int D, int K, int nb,
                                 int specialised, void* stream) {
  return dispatch(X, x_dtype, log_w, lws, means, ms0, ms1, U, us0, us1, us2,
                  nk, means_out, cov, ll, work, N, nvalid, D, K, nb, true,
                  specialised, stream);
}
