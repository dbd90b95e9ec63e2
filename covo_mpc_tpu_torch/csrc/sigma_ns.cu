// The fused Newton–Schulz Sigma-designer (K8), on one thread-block cluster.
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
// flops each (436 MFLOP at D = 128: 6.53 us at the fp32 peak), against 192 KB
// of input and output. The products form one dependent chain and the Cholesky
// is D dependent pivots.
//
// What the design does about it. One SM's fp32 rate (~0.5 TFLOP/s) caps a
// single block at ~0.9 ms, and one SM cannot hold the 7 working matrices
// (448 KB at D = 128) in its 227 KB of shared memory, so a single block has to
// restage both operands of every product from L2. Here one cluster of
// kCluster CTAs runs the chain, and the matrices never leave shared memory:
// CTA r owns rows [r w, r w + w) of each of the 7 matrices, w = ceil(D /
// kCluster) rounded up to a multiple of 4 (16 at D = 128; the last CTAs of a
// ragged D own fewer rows or none). A product C = A B computes C's rows where
// A's rows are. Each CTA first copies all of B into its own shared memory
// over distributed shared memory (DSMEM), 16-byte loads, every peer's rows
// requested before any arrives and CTA r starting at peer r + 1, so that the
// CTAs read different peers at a time. Paying the DSMEM latency once a
// product, not once a peer, is what makes this faster than a double buffer
// that overlaps each peer's copy with the FMAs on the last (PERF.md §6: the
// two designs side by side through tools/sigma_ns_variants.py). Then each thread
// sums a kRows x 2 tile of C over k = 0..D-1 in increasing order with fmaf,
// from 0: every product element is the same sum of the same terms in the same
// order as in the single-block design, so equal operands give equal bits. One
// cluster barrier follows each product (one per pair of independent products)
// and each elementwise step whose output a peer reads next: the buffers rotate
// between products, and C never aliases A or B. Norms and inner products:
// each CTA sums its own rows and publishes the partial in its shared memory;
// after a cluster barrier every CTA adds all kCluster partials in rank order,
// so every CTA holds the same scalars bit for bit and runs the same iteration.
// Every multiply-add is an fp32 FMA on the CUDA cores: no TF32 and no tensor
// cores, because truncated products NaN the lambda_min refinement
// (ops/covariance.py). The Cholesky stays in one CTA (D dependent pivots):
// CTA 0 gathers Z over DSMEM into a (D, D + 1) array, so that a column spans
// all 32 banks, and symmetrizes it; the other CTAs wait at a cluster barrier
// until it has read their rows (the shared memory of a CTA that has exited
// is undefined). The elimination keeps the lower triangle in registers, each
// thread holding every kThreads-th entry of a precomputed (i, k) order, so
// that a pivot's updates spread evenly over the threads and no index is
// divided in the pivot loop; each pivot column is published to shared memory
// as it becomes final. The upper triangle keeps sym(Z) for a_cov.
//
// ptxas (sm_90a, CUDA 12.9): 200 registers a thread, 48 bytes of static
// shared memory, no spills, no stack; 141,440 bytes of dynamic shared memory
// a CTA at kCluster = 8 (sigma_ns_info reports them at run time).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // CTAs of the cluster: 8, the portable limit
constexpr int kThreads = 256;
constexpr int kMaxD = 128;
constexpr int kSlabRows = kMaxD / kCluster;  // rows of a matrix one CTA holds at most
constexpr int kSlab = kSlabRows * kMaxD;     // floats of one such slab
constexpr int kNumBuf = 7;                   // S, then six work buffers
constexpr int kCols = 2;                     // a thread's tile of a product: kRows x 2
constexpr int kColGroups = kMaxD / kCols;
constexpr int kRows = kSlabRows * kColGroups / kThreads;
constexpr int kStage = kSlab / 4 / kThreads;  // float4 of a peer's slab per thread
constexpr int kWStride = kMaxD + 1;           // row stride of CTA 0's gathered Z
// the local copy of B, and in CTA 0 at the end the gathered Z and its diagonal
constexpr int kCopyFloats = kMaxD * kWStride + kMaxD;
constexpr int kIdxBits = 7;  // a Cholesky index packs (i << kIdxBits) | k
constexpr int kTri = kMaxD * (kMaxD + 1) / 2;   // entries of a lower triangle
constexpr int kSlots = (kTri + kThreads - 1) / kThreads;  // a thread's share
constexpr int kTabFloats = kTri / 2;            // kTri 16-bit indices
constexpr int kSmemFloats = kNumBuf * kSlab + kCopyFloats + kTabFloats + 2 * kMaxD;
static_assert(kRows >= 1 && kRows * kThreads == kSlabRows * kColGroups,
              "a product's tiles must cover a slab exactly");
static_assert(kStage >= 1 && kStage * 4 * kThreads == kSlab,
              "a slab must split into whole float4 per thread");
static_assert(kSlabRows % 4 == 0, "slabs hold whole groups of 4 rows");
static_assert(kMaxD == 1 << kIdxBits && kMaxD * kMaxD <= kCopyFloats,
              "indices and the copy of B fit");

struct Params {
  int D, squarings, rough_lift, rough_polish, main_lift, main_polish;
  float sigma, lift_a, lift_b, lift_c;
};

// This CTA's view of the cluster: its rank, the slab width w, its own first
// row and row count, the number of CTAs that own rows, the local copy of B
// and the reduction scratch. Identical in every CTA except rank, row0 and
// rows.
struct Ctx {
  int rank, D, w, row0, rows, peers;
  float* Bl;     // (D, D): all of a product's B
  float* red;    // (kThreads / 32,): the warps' partial sums
  float* pub;    // (2,): this CTA's published partial, alternating slots
  int slot;
  float lift_a, lift_b, lift_c;
};

enum Epilogue { kStore, kQuintic, kCubic };

// A barrier of the whole cluster: every CTA's shared-memory writes before it
// are visible to every CTA after it (barrier.cluster arrive.release and
// wait.acquire).
__device__ __forceinline__ void cluster_barrier() { cg::this_cluster().sync(); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of every thread's v over the cluster. Each CTA adds its warps' sums in
// order and publishes the result; after a cluster barrier every thread adds
// the kCluster published sums in rank order, so all agree bit for bit. Two
// publishing slots alternate: a slot is written again only after a later
// reduction's barrier, which every reader of its last value has passed.
__device__ float cluster_sum(float v, Ctx& c) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) c.red[threadIdx.x >> 5] = v;
  __syncthreads();
  float* pub = c.pub + c.slot;
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int i = 0; i < kThreads / 32; ++i) s += c.red[i];
    *pub = s;
  }
  cluster_barrier();
  cg::cluster_group cluster = cg::this_cluster();
  float total = 0.0f;
  for (int q = 0; q < kCluster; ++q) total += *cluster.map_shared_rank(pub, q);
  c.slot ^= 1;
  return total;
}

// This thread's part of sum_e a[e] b[e] over the CTA's rows of two matrices.
__device__ float dot_rows(const float* a, const float* b, const Ctx& c) {
  float s = 0.0f;
  for (int e = threadIdx.x; e < c.rows * c.D; e += kThreads) s = fmaf(a[e], b[e], s);
  return s;
}

// Rows of the matrix that CTA q owns.
__device__ __forceinline__ int rows_of(const Ctx& c, int q) {
  return max(0, min(c.w, c.D - q * c.w));
}

// This CTA's rows of C = A @ B (each a slab at the same offset in every CTA),
// D <= 128 and D % 4 == 0. C must not alias A or B. kQuintic stores
// a I + b X + c (A B) (X the slab of X), kCubic (3 I - A B) / 2. With `sync`
// it ends with a cluster barrier, after which C is visible to every CTA;
// without, the caller's next product must neither read C nor write what a
// peer still reads. A tile's rows past the CTA's compute on stale slab
// entries and are not stored. Not inlined: one copy of the FMA loop serves
// the 15 call sites.
__device__ __noinline__ void matmul(const float* A, const float* B, float* C,
                                    Ctx c, int epilogue, const float* X,
                                    bool sync) {
  cg::cluster_group cluster = cg::this_cluster();
  const int D = c.D;
  const int row = (threadIdx.x / kColGroups) * kRows;
  const int col = (threadIdx.x % kColGroups) * kCols;
  const bool active = row < c.rows && col < D;

  // Every peer's rows of B are requested over distributed shared memory
  // before any arrives, CTA r starting at peer r + 1 so that the CTAs read
  // different peers at a time; then, once this CTA's last product is done
  // with the copy, they are stored into it.
  float4 st[kCluster][kStage];
#pragma unroll
  for (int n = 0; n < kCluster; ++n) {
    const int q = (c.rank + 1 + n) % kCluster;
    const float4* src = reinterpret_cast<const float4*>(
        cluster.map_shared_rank(const_cast<float*>(B), q));
    const int n4 = rows_of(c, q) * D / 4;
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int f = threadIdx.x + s * kThreads;
      if (f < n4) st[n][s] = src[f];
    }
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < kCluster; ++n) {
    const int q = (c.rank + 1 + n) % kCluster;
    float4* dst = reinterpret_cast<float4*>(c.Bl + q * c.w * D);
    const int n4 = rows_of(c, q) * D / 4;
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int f = threadIdx.x + s * kThreads;
      if (f < n4) dst[f] = st[n][s];
    }
  }
  __syncthreads();

  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int q = 0; q < kCols; ++q) acc[r][q] = 0.0f;
  if (active) {
    const float* Ar = A + row * D;
    const float* Bc = c.Bl + col;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 4) {
      float a[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(Ar + r * D + kk);
        a[r][0] = v.x; a[r][1] = v.y; a[r][2] = v.z; a[r][3] = v.w;
      }
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const float2 b = *reinterpret_cast<const float2*>(Bc + (kk + k4) * D);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r][0] = fmaf(a[r][k4], b.x, acc[r][0]);
          acc[r][1] = fmaf(a[r][k4], b.y, acc[r][1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = row + r;
      if (i < c.rows) {
        float v[kCols];
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const bool diag = c.row0 + i == col + q;
          v[q] = acc[r][q];
          if (epilogue == kQuintic) {
            v[q] = ((diag ? c.lift_a : 0.0f) + c.lift_b * X[i * D + col + q]) + c.lift_c * v[q];
          } else if (epilogue == kCubic) {
            v[q] = 0.5f * ((diag ? 3.0f : 0.0f) - v[q]);
          }
        }
        *reinterpret_cast<float2*>(C + i * D + col) = make_float2(v[0], v[1]);
      }
    }
  }
  if (sync) cluster_barrier();
}

// dst = src / ||src||_F (src as it is when the norm is 0); dst may be src.
// Ends with a cluster barrier.
__device__ void unit(const float* src, float* dst, Ctx& c) {
  const float nrm = sqrtf(cluster_sum(dot_rows(src, src, c), c));
  const float d = nrm > 0.0f ? nrm : 1.0f;
  for (int e = threadIdx.x; e < c.rows * c.D; e += kThreads) dst[e] = src[e] / d;
  cluster_barrier();
}

// lambda_max of the symmetric PSD B: power iteration by repeated squaring,
// normalized every 3 squarings (squarings rounded up to whole blocks of 3),
// then the Rayleigh quotient <M, B M> / <M, M>. w0 and w1 are scratch.
__device__ float extreme_eig(const float* B, float* w0, float* w1, int squarings,
                             Ctx& c) {
  const int blocks = (squarings + 2) / 3;
  float* M = w0;
  float* T = w1;
  unit(B, M, c);
  for (int b = 0; b < blocks; ++b) {
    for (int s = 0; s < 3; ++s) {
      matmul(M, M, T, c, kStore, nullptr, true);
      float* t = M; M = T; T = t;
    }
    unit(M, M, c);
  }
  matmul(B, M, T, c, kStore, nullptr, true);
  const float num = cluster_sum(dot_rows(M, T, c), c);
  const float den = cluster_sum(dot_rows(M, M, c), c);
  return num / (den + 1e-30f);
}

// Y = (S + shift I) / div and Z = I: the start of a coupled NS root.
__device__ void ns_start(const float* S, float shift, float div, float* Y,
                         float* Z, const Ctx& c) {
  const int D = c.D;
  for (int e = threadIdx.x; e < c.rows * D; e += kThreads) {
    const bool diag = c.row0 + e / D == e % D;
    Y[e] = (S[e] + (diag ? shift : 0.0f)) / div;
    Z[e] = diag ? 1.0f : 0.0f;
  }
  cluster_barrier();
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
                        float* Q, int lift, int polish, Ctx& c) {
  for (int it = 0; it < lift + polish; ++it) {
    if (it < lift) {
      matmul(Z, Y, X, c, kStore, nullptr, true);
      matmul(X, X, Q, c, kQuintic, X, true);
    } else {
      matmul(Z, Y, Q, c, kCubic, nullptr, true);
    }
    matmul(Y, Q, Y2, c, kStore, nullptr, false);  // independent of the next
    matmul(Q, Z, Z2, c, kStore, nullptr, true);
    float* t = Y; Y = Y2; Y2 = t;
    t = Z; Z = Z2; Z2 = t;
  }
  return Pair{Y, Z};
}

__global__ void __launch_bounds__(kThreads, 1)
sigma_ns_kernel(const float* __restrict__ R, float* __restrict__ a_cov,
                float* __restrict__ factor, Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float red[kThreads / 32];
  __shared__ float pub[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int D = p.D;
  const int w = ((D + kCluster - 1) / kCluster + 3) & ~3;
  const int row0 = rank * w;
  Ctx c{rank, D, w, row0, max(0, min(w, D - row0)), (D + w - 1) / w,
        smem + kNumBuf * kSlab, red, pub, 0, p.lift_a, p.lift_b, p.lift_c};
  auto buf = [smem](int b) { return smem + b * kSlab; };
  float* S = buf(0);  // then six work buffers, buf(1)..buf(6)
  const int n = c.rows * D;

  // 1. symmetrize this CTA's rows; the certified bound lambda_max(R) <= ||R||_F
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int i = row0 + e / D, j = e % D;
    S[e] = (R[i * D + j] + R[j * D + i]) / 2.0f;
  }
  const float bound = sqrtf(cluster_sum(dot_rows(S, S, c), c)) + 1e-30f;

  // 2. rough lambda_min = bound - lambda_max(bound I - R)
  float* Bm = buf(1);
  for (int e = threadIdx.x; e < n; e += kThreads) {
    Bm[e] = (row0 + e / D == e % D ? bound : 0.0f) - S[e];
  }
  const float lam_min_rough = bound - extreme_eig(Bm, buf(2), buf(3), p.squarings, c);
  const float spread = bound - lam_min_rough;

  // 3. lambda_min refined through the inverse of the shifted A1
  const float delta1 = 1e-2f + 5e-3f * spread;
  const float off1 = -lam_min_rough + delta1;
  const float s1 = (bound + off1) * 1.05f;
  ns_start(S, off1, s1, buf(1), buf(2), c);
  const Pair rough = ns_sqrt(buf(1), buf(2), buf(3), buf(4), buf(5), buf(6),
                             p.rough_lift, p.rough_polish, c);
  matmul(rough.Z, rough.Z, buf(5), c, kStore, nullptr, true);
  const float lam_min =
      s1 / extreme_eig(buf(5), buf(6), rough.Y, p.squarings, c) - off1;

  // 4. the reference shift and Z ~ (A / s)^{-1/2}
  const float offset = -lam_min + 1e-2f;
  const float s = (bound + offset) * 1.05f + 1e-30f;
  ns_start(S, offset, s, buf(1), buf(2), c);
  const float* Z = ns_sqrt(buf(1), buf(2), buf(3), buf(4), buf(5), buf(6),
                           p.main_lift, p.main_polish, c).Z;

  // 5. CTA 0 gathers Z into W, (D, kWStride), in place of the copy of B; the
  // others wait until it has
  float* W = c.Bl;
  float* diag = W + kMaxD * kWStride;  // sym(Z)'s diagonal, for a_cov
  if (rank == 0) {
    for (int q = 0; q < c.peers; ++q) {
      const float4* src = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(const_cast<float*>(Z), q));
      for (int f = threadIdx.x; f < rows_of(c, q) * D / 4; f += kThreads) {
        const float4 v = src[f];
        float* dst = W + (q * w + 4 * f / D) * kWStride + 4 * f % D;
        dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
      }
    }
  }
  cluster.sync();
  if (rank != 0) return;
  for (int e = threadIdx.x; e < D * D; e += kThreads) {
    const int i = e / D, j = e % D;
    if (j < i) {
      const float v = (W[i * kWStride + j] + W[j * kWStride + i]) / 2.0f;
      W[i * kWStride + j] = v;
      W[j * kWStride + i] = v;
    } else if (j == i) {
      const float v = (W[i * kWStride + i] + W[i * kWStride + i]) / 2.0f;
      W[i * kWStride + i] = v;
      diag[i] = v;
    }
  }
  __syncthreads();
  // The lower triangle's (i, k), k <= i, by column k from the last: step j
  // of the elimination updates the first (D - 1 - j) (D - j) / 2, the
  // columns k > j. Thread t holds entries t, t + kThreads, ... of that order
  // in registers, with their packed (i, k).
  unsigned short* tab = reinterpret_cast<unsigned short*>(W + kCopyFloats);
  float* col = W + kCopyFloats + kTabFloats;  // (2, kMaxD): columns j, j + 1
  for (int k = threadIdx.x; k < D; k += kThreads) {
    unsigned short* t = tab + (D - 1 - k) * (D - k) / 2 - k;
    for (int i = k; i < D; ++i) t[i] = static_cast<unsigned short>(i << kIdxBits | k);
    col[k] = W[k * kWStride];  // column 0
  }
  __syncthreads();
  const int tri = D * (D + 1) / 2;
  float wv[kSlots];
  int wi[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int e = threadIdx.x + s * kThreads;
    wi[s] = e < tri ? tab[e] : 0;
    wv[s] = W[(wi[s] >> kIdxBits) * kWStride + (wi[s] & (kMaxD - 1))];
  }

  // Right-looking Cholesky of the lower triangle. Step j reads column j (in
  // col, published at the end of step j - 1) and updates the columns > j;
  // column j + 1, final after step j, is published into the other half of
  // col as it is computed. Column j, below and on the diagonal, keeps step
  // j's values: L[i][j] = W[i][j] / sqrt(W[j][j]), and W[j][j] is pivot j.
  for (int j = 0; j < D; ++j) {
    const float* cur = col + (j & 1) * kMaxD;
    float* nxt = col + ((j + 1) & 1) * kMaxD;
    const float inv = 1.0f / cur[j];
    const int n = (D - 1 - j) * (D - j) / 2;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (threadIdx.x + s * kThreads >= n) break;
      const int i = wi[s] >> kIdxBits, k = wi[s] & (kMaxD - 1);
      wv[s] = fmaf(-cur[i], cur[k] * inv, wv[s]);
      if (k == j + 1) nxt[i] = wv[s];
    }
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (threadIdx.x + s * kThreads < tri) {
      W[(wi[s] >> kIdxBits) * kWStride + (wi[s] & (kMaxD - 1))] = wv[s];
    }
  }
  __syncthreads();
  float log_piv = 0.0f;  // sum of log pivots = log det Z, the same in every thread
  for (int j = 0; j < D; ++j) log_piv += logf(W[j * kWStride + j]);

  // 6. log det A = D log s - 2 log det Z; rescale to det a_cov = sigma^(2D)
  const float log_det_A = D * logf(s) - 2.0f * log_piv;
  const float log_det_a_cov = D * (logf(p.sigma) * 2.0f);
  const float log_const = (log_det_a_cov * 2.0f + log_det_A) / D;
  const float scale = expf(0.5f * log_const) / sqrtf(s);
  const float root = sqrtf(scale);
  for (int e = threadIdx.x; e < D * D; e += kThreads) {
    const int r = e / D, q = e % D;
    a_cov[e] = scale * (r == q ? diag[r] : W[min(r, q) * kWStride + max(r, q)]);
    factor[e] = q <= r ? root * (W[r * kWStride + q] / sqrtf(W[q * kWStride + q])) : 0.0f;
  }
}

}  // namespace

// Launch one cluster on `stream`; returns the launch's error, else
// cudaGetLastError(). R, a_cov and factor are (D, D) row-major float32; D <=
// 128 and a multiple of 4. sigma is the sampling sigma, lift_a/b/c the
// quintic-lift coefficients, the rest the iteration counts of the plain
// version.
extern "C" int sigma_ns(const float* R, float* a_cov, float* factor, int D,
                        float sigma, float lift_a, float lift_b, float lift_c,
                        int squarings, int rough_lift, int rough_polish,
                        int main_lift, int main_polish, cudaStream_t stream) {
  if (D <= 0 || D > kMaxD || D % 4 != 0 || squarings < 0 || rough_lift < 0 ||
      rough_polish < 0 || main_lift < 0 || main_polish < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(sizeof(float) * kSmemFloats);
  cudaError_t err = cudaFuncSetAttribute(
      sigma_ns_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kCluster > 8) {
    err = cudaFuncSetAttribute(
        sigma_ns_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kCluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const Params p{D, squarings, rough_lift, rough_polish, main_lift, main_polish,
                 sigma, lift_a, lift_b, lift_c};
  err = cudaLaunchKernelEx(&cfg, sigma_ns_kernel, R, a_cov, factor, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's launch geometry and resources, into out[0..5]: CTAs of the
// cluster, threads of a CTA, dynamic and static shared memory of a CTA
// (bytes), registers of a thread, local memory of a thread (bytes: a stack
// frame or spills). Returns cudaFuncGetAttributes' error.
extern "C" int sigma_ns_info(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, sigma_ns_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = kCluster;
  out[1] = kThreads;
  out[2] = static_cast<int>(sizeof(float) * kSmemFloats);
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
