// The fused Newton–Schulz Sigma-designer (K8).
//
// Replaces covo_mpc_tpu/ops/covariance_pallas.py::optimize_sigma_ns_pallas
// (_sigma_ns_kernel). From the Hessian R (D, D), in one launch:
//   1. symmetrize R and take the certified bound ||R||_F;
//   2. a rough lambda_min by normalized power squaring of bound I - R;
//   3. lambda_min refined through the coupled NS inverse root of the
//      generously shifted A1, then power squaring of Z1 Z1;
//   4. the main coupled NS inverse root of A / s;
//   5. one Cholesky of the symmetrized Z, with its log det;
//   6. the rescale to the fixed determinant det Sigma = det(sigma^2 I).
// Writes a_cov = scale Z and the lower factor sqrt(scale) L (L L^T = Z), both
// (D, D) row-major. The plain version, which repeats this arithmetic with
// torch ops, is covo_mpc_tpu_torch/ops/covariance.py::optimize_sigma_ns; the
// iteration counts and the quintic-lift coefficients are its own, passed in.
//
// What bounds it on an H100: operations. 104 dependent (D x D) products, 2 D^3
// flops each (436 MFLOP at D = 128, 6.5 us at the fp32 peak), against 192 KB
// of input and output. The products form one dependent chain and the Cholesky
// is D dependent pivots, so the work cannot spread over the card's SMs without
// a grid-wide barrier per product.
//
// What the design does about it: one block of 512 threads on one SM runs the
// whole chain, with no launch per product. Each product is shared by the
// block: every thread owns an 8 x 4 tile of the result (512 threads, up to
// 128 registers each; 1024 threads with 4 x 4 tiles spilled at their
// 64-register cap), and the operands are staged through shared memory in
// slabs of 32 along k. The matrices live in a
// global workspace the wrapper allocates (7 D x D buffers, 448 KB at D = 128,
// resident in the 50 MB L2). Every multiply-add is an fp32 FMA on the CUDA
// cores: no TF32 and no tensor cores (truncated products NaN the lambda_min
// refinement, DESIGN.md §3b). Norms and inner products are fp32 block
// reductions. The Cholesky runs right-looking on the symmetrized Z held in
// shared memory, one __syncthreads per pivot. One SM's fp32 rate (~0.5 TFLOP/s)
// caps this design at ~0.9 ms; a multi-SM cluster or 3xTF32 wgmma design is
// later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxD = 128;
constexpr int kRows = 8, kCols = 4;       // each thread: an 8 x 4 tile of a product
constexpr int kColTiles = kMaxD / kCols;  // 32: one warp spans a row of tiles
constexpr int kSlab = 32;                 // k-depth of one staged slab
constexpr int kAStride = kMaxD + 4;       // A slab, k-major; keeps float4 rows aligned
constexpr int kSlabFloats = kSlab * (kAStride + kMaxD);

struct Params {
  int D, squarings, rough_lift, rough_polish, main_lift, main_polish;
  float sigma, lift_a, lift_b, lift_c;
};

// Shared-memory views: the two operand slabs of a product, and the warps'
// partial sums of a reduction.
struct Ctx {
  int D;
  float* As;   // (kSlab, kAStride): A[:, k0:k0+32] transposed
  float* Bs;   // (kSlab, kMaxD): B[k0:k0+32, :]
  float* red;  // (32,)
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block, returned to every thread. Each warp reduces the
// warps' partial sums itself, in one order, so all threads agree bit for bit.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the previous call's readers are done with red
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < kThreads / 32 ? red[lane] : 0.0f);
}

// sum_e a[e] b[e] over the n entries of two matrices.
__device__ float dot_all(const float* a, const float* b, int n, float* red) {
  float s = 0.0f;
  for (int e = threadIdx.x; e < n; e += kThreads) s = fmaf(a[e], b[e], s);
  return block_sum(s, red);
}

// C = A @ B, (D, D) row-major, D <= 128 and D % 4 == 0. C must not alias A or
// B. Ends with a barrier, so C is visible to the whole block. A tile's rows
// past D compute on stale slab entries and are not stored. Not inlined: its
// 13 call sites inlined pushed the kernel past 128 registers and it spilled.
__device__ __noinline__ void matmul(const float* A, const float* B, float* C,
                                   const Ctx& c) {
  const int D = c.D;
  const int row = (threadIdx.x / kColTiles) * kRows;
  const int col = (threadIdx.x % kColTiles) * kCols;
  const bool active = row < D && col < D;
  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int q = 0; q < kCols; ++q) acc[r][q] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += kSlab) {
    const int kn = min(kSlab, D - k0);
    // neighbouring threads read neighbouring k of one row of A (coalesced);
    // a fixed trip count lets every load of a slab issue before its stores
#pragma unroll
    for (int r = 0; r < kSlab * kMaxD / kThreads; ++r) {
      const int e = threadIdx.x + r * kThreads;
      if (e < D * kn) {
        const int i = e / kn, kk = e - i * kn;
        c.As[kk * kAStride + i] = A[i * D + k0 + kk];
      }
    }
#pragma unroll
    for (int r = 0; r < kSlab * kMaxD / kThreads; ++r) {
      const int e = threadIdx.x + r * kThreads;
      if (e < kn * D) {
        const int kk = e / D, j = e - kk * D;
        c.Bs[kk * kMaxD + j] = B[(k0 + kk) * D + j];
      }
    }
    __syncthreads();
    if (active) {
      for (int kk = 0; kk < kn; ++kk) {
        // a warp shares one row tile (a broadcast) and reads 32 column tiles
        const float4 a0 = *reinterpret_cast<const float4*>(c.As + kk * kAStride + row);
        const float4 a1 = *reinterpret_cast<const float4*>(c.As + kk * kAStride + row + 4);
        const float4 b = *reinterpret_cast<const float4*>(c.Bs + kk * kMaxD + col);
        const float ar[kRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r][0] = fmaf(ar[r], b.x, acc[r][0]);
          acc[r][1] = fmaf(ar[r], b.y, acc[r][1]);
          acc[r][2] = fmaf(ar[r], b.z, acc[r][2]);
          acc[r][3] = fmaf(ar[r], b.w, acc[r][3]);
        }
      }
    }
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (row + r < D) {
        *reinterpret_cast<float4*>(C + (row + r) * D + col) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
  }
  __syncthreads();
}

// dst = src / ||src||_F (src as it is when the norm is 0); dst may be src.
__device__ void unit(const float* src, float* dst, const Ctx& c) {
  const int n = c.D * c.D;
  const float nrm = sqrtf(dot_all(src, src, n, c.red));
  const float d = nrm > 0.0f ? nrm : 1.0f;
  for (int e = threadIdx.x; e < n; e += kThreads) dst[e] = src[e] / d;
  __syncthreads();
}

// lambda_max of the symmetric PSD B: power iteration by repeated squaring,
// normalized every 3 squarings (squarings rounded up to whole blocks of 3),
// then the Rayleigh quotient <M, B M> / <M, M>. w0 and w1 are scratch.
__device__ float extreme_eig(const float* B, float* w0, float* w1,
                             int squarings, const Ctx& c) {
  const int blocks = (squarings + 2) / 3;
  float* M = w0;
  float* T = w1;
  unit(B, M, c);
  for (int b = 0; b < blocks; ++b) {
    for (int s = 0; s < 3; ++s) {
      matmul(M, M, T, c);
      float* t = M; M = T; T = t;
    }
    unit(M, M, c);
  }
  matmul(B, M, T, c);
  const int n = c.D * c.D;
  const float num = dot_all(M, T, n, c.red);
  const float den = dot_all(M, M, n, c.red);
  return num / (den + 1e-30f);
}

// Y = (S + shift I) / div and Z = I: the start of a coupled NS root.
__device__ void ns_start(const float* S, float shift, float div, float* Y,
                         float* Z, const Ctx& c) {
  const int D = c.D;
  for (int e = threadIdx.x; e < D * D; e += kThreads) {
    const bool diag = e / D == e % D;
    Y[e] = (S[e] + (diag ? shift : 0.0f)) / div;
    Z[e] = diag ? 1.0f : 0.0f;
  }
  __syncthreads();
}

// The buffers holding a coupled iteration's (Y, Z).
struct Pair {
  float* Y;
  float* Z;
};

// The coupled iteration (Y, Z) -> (Ahat^{1/2}, Ahat^{-1/2}) from (Ahat, I):
// `lift` quintic steps Q = a I + b X + c X^2 (X = Z Y), then `polish` cubic
// steps T = (3 I - Z Y) / 2; each step Y <- Y Q, Z <- Q Z. Returns the
// buffers that hold the results; Y2, Z2, X, Q are scratch.
__device__ Pair ns_sqrt(float* Y, float* Z, float* Y2, float* Z2, float* X,
                        float* Q, int lift, int polish, const Params& p,
                        const Ctx& c) {
  const int D = c.D;
  for (int it = 0; it < lift + polish; ++it) {
    const bool quintic = it < lift;
    matmul(Z, Y, X, c);
    if (quintic) matmul(X, X, Q, c);
    for (int e = threadIdx.x; e < D * D; e += kThreads) {
      const bool diag = e / D == e % D;
      Q[e] = quintic ? ((diag ? p.lift_a : 0.0f) + p.lift_b * X[e]) + p.lift_c * Q[e]
                     : 0.5f * ((diag ? 3.0f : 0.0f) - X[e]);
    }
    __syncthreads();
    matmul(Y, Q, Y2, c);
    matmul(Q, Z, Z2, c);
    float* t = Y; Y = Y2; Y2 = t;
    t = Z; Z = Z2; Z2 = t;
  }
  return Pair{Y, Z};
}

__global__ void __launch_bounds__(kThreads, 1)
sigma_ns_kernel(const float* __restrict__ R, float* a_cov, float* factor,
                float* ws, Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float red[32];
  const Ctx c{p.D, smem, smem + kSlab * kAStride, red};
  const int D = p.D, n = D * D;
  float* S = ws;  // the workspace's 7 matrices: S, then six work buffers
  auto buf = [ws, n](int b) { return ws + b * n; };

  // 1. symmetrize; the certified bound lambda_max(R) <= ||R||_F
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int i = e / D, j = e % D;
    S[e] = (R[i * D + j] + R[j * D + i]) / 2.0f;
  }
  __syncthreads();
  const float bound = sqrtf(dot_all(S, S, n, red)) + 1e-30f;

  // 2. rough lambda_min = bound - lambda_max(bound I - R)
  float* Bm = buf(1);
  for (int e = threadIdx.x; e < n; e += kThreads) {
    Bm[e] = (e / D == e % D ? bound : 0.0f) - S[e];
  }
  __syncthreads();
  const float lam_min_rough = bound - extreme_eig(Bm, buf(2), buf(3), p.squarings, c);
  const float spread = bound - lam_min_rough;

  // 3. lambda_min refined through the inverse of the shifted A1
  const float delta1 = 1e-2f + 5e-3f * spread;
  const float off1 = -lam_min_rough + delta1;
  const float s1 = (bound + off1) * 1.05f;
  ns_start(S, off1, s1, buf(1), buf(2), c);
  const Pair rough = ns_sqrt(buf(1), buf(2), buf(3), buf(4), buf(5), buf(6),
                             p.rough_lift, p.rough_polish, p, c);
  matmul(rough.Z, rough.Z, buf(5), c);
  const float lam_min =
      s1 / extreme_eig(buf(5), buf(6), rough.Y, p.squarings, c) - off1;

  // 4. the reference shift and Z ~ (A / s)^{-1/2}
  const float offset = -lam_min + 1e-2f;
  const float s = (bound + offset) * 1.05f + 1e-30f;
  ns_start(S, offset, s, buf(1), buf(2), c);
  const float* Z = ns_sqrt(buf(1), buf(2), buf(3), buf(4), buf(5), buf(6),
                           p.main_lift, p.main_polish, p, c).Z;

  // 5. right-looking Cholesky of sym(Z) in shared memory (the slabs are
  // dead). Step j reads column j and writes only rows and columns > j, so
  // column j, below and on the diagonal, still holds step j's values after
  // the loop: L[i][j] = W[i][j] / sqrt(W[j][j]).
  float* W = smem;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int i = e / D, j = e % D;
    W[e] = (Z[i * D + j] + Z[j * D + i]) / 2.0f;
  }
  __syncthreads();
  float log_piv = 0.0f;  // sum of log pivots = log det Z, the same in every thread
  for (int j = 0; j < D; ++j) {
    const float piv = W[j * D + j];
    log_piv += logf(piv);
    const float inv = 1.0f / piv;
    const int m = D - 1 - j;
    for (int e = threadIdx.x; e < m * m; e += kThreads) {
      const int i = j + 1 + e / m, k = j + 1 + e % m;
      W[i * D + k] = fmaf(-W[i * D + j], W[k * D + j] * inv, W[i * D + k]);
    }
    __syncthreads();
  }

  // 6. log det A = D log s - 2 log det Z; rescale to det a_cov = sigma^(2D)
  const float log_det_A = D * logf(s) - 2.0f * log_piv;
  const float log_det_a_cov = D * (logf(p.sigma) * 2.0f);
  const float log_const = (log_det_a_cov * 2.0f + log_det_A) / D;
  const float scale = expf(0.5f * log_const) / sqrtf(s);
  const float root = sqrtf(scale);
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int i = e / D, j = e % D;
    a_cov[e] = scale * ((Z[i * D + j] + Z[j * D + i]) / 2.0f);
    factor[e] = j <= i ? root * (W[e] / sqrtf(W[j * D + j])) : 0.0f;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError(). R, a_cov and factor are
// (D, D) row-major float32, ws a (7, D, D) float32 workspace; D <= 128 and a
// multiple of 4. sigma is the sampling sigma, lift_a/b/c the quintic-lift
// coefficients, the rest the iteration counts of the plain version.
extern "C" int sigma_ns(const float* R, float* a_cov, float* factor, float* ws,
                        int D, float sigma, float lift_a, float lift_b,
                        float lift_c, int squarings, int rough_lift,
                        int rough_polish, int main_lift, int main_polish,
                        cudaStream_t stream) {
  if (D <= 0 || D > kMaxD || D % kCols != 0 || squarings < 0 ||
      rough_lift < 0 || rough_polish < 0 || main_lift < 0 || main_polish < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int floats = kSlabFloats > D * D ? kSlabFloats : D * D;
  const size_t smem = sizeof(float) * floats;
  cudaError_t err = cudaFuncSetAttribute(
      sigma_ns_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{D, squarings, rough_lift, rough_polish, main_lift, main_polish,
                 sigma, lift_a, lift_b, lift_c};
  sigma_ns_kernel<<<1, kThreads, smem, stream>>>(R, a_cov, factor, ws, p);
  return static_cast<int>(cudaGetLastError());
}
