// Joint sample + rollout: CoVO's fused MVN draw and N x H rollout, for one
// scenario (K1) or for B scenarios in one launch (K7, joint).
//
// Replaces covo_mpc_tpu/ops/rollout_pallas.py::make_pallas_rollout_joint_sampling
// (_rollout_kernel with sample="prng_joint", every disturbance mode and
// reward) and ::make_pallas_rollout_batched_sampling with joint=True (the
// same kernel with batched=True over a (B, lane-tiles) grid). Per scenario b
// and sample n: z ~ N(0, I_D) (or z[(b D + d) N + n] when a z pointer is
// given, the "input_z" mode of the Pallas kernel), a = clip(mean_b + F_b z,
// +-1) with F_b the Sigma-designer's full (D, D) factor of scenario b (not
// assumed triangular), then H steps of pre-step reward (penyaw or
// realworld), termination freeze (|pos| > 3 or time up; rollover optional),
// bodyrate step and discounted cost. Outputs costs (B, N) and the clipped
// actions (B, D, N), sample-last; x0, the packs and the targets are
// scenario-strided (quad::scenario_tables), the means (B, D), the factors
// (B, D, D) row-major. D = 4H <= kMaxD = 128.
//
// What bounds it on an H100: operations. The correlate is 2 N D^2 fp32
// operations per scenario (268 MFLOP at N = 8192, D = 128), beside the
// draws (5 per normal) and the H rollout steps (~190 each): 4.8 us at B = 1
// and 77 us at B = 16 at the 67 TFLOP/s fp32 peak, against 4 MB of actions
// a scenario written (1.3 us at 3.35 TB/s).
//
// The design, a block of S = `block` samples (64 or 128) of one scenario
// (blockIdx.y) on T threads (kThreads64 / kThreads128), in three phases:
// A. Draw (or load) the block's z into shared memory, d-major and
//    sample-minor. The D/4 x S Philox calls are spread over all T threads,
//    consecutive threads on consecutive samples. The counter is (j, n, 0,
//    slot), slot = b + the episode offset (rng::scenario_slot; K7 only, 0
//    in K1): one Philox4x32-10 call (philox.cuh) gives 4 uniforms -> 2
//    Box-Muller pairs -> z rows 4j..4j+3 of sample n of scenario b, so the
//    draws do not depend on S, T or B, scenario 0 at offset 0 draws what K1
//    draws, and scenario b at offset o what scenario o + b draws at 0.
//    The key is the 64-bit device word `seed` points to, read by the
//    threads that draw: a CUDA graph that replays the launch reads the word
//    each solve writes (ops/sampling.py's seed stream), so every replay
//    draws afresh, and one key value gives the same normals however the
//    word was written.
//    The given-z mode loads the (D, S) tile coalesced along samples. Past N
//    the tile holds zeros.
// B. The correlate A = F Z_tile, (D x D) (D x S), as a register-tiled SGEMM:
//    each thread owns kTR rows x 8 samples (8 x 8 at S = 64, T = 128). F
//    streams through shared memory in stages of kKC columns (row-major, as
//    the wrapper passes it), double-buffered with cp.async; the first stage
//    loads while phase A draws. Each step of 4 columns d reads a row's 4 F
//    values and a column's 2 x 4 samples as 16-byte loads, each F value
//    feeding 8 FMAs and each z value kTR. A quarter warp shares one row
//    group, so the F loads are broadcasts and the z loads 128 contiguous
//    bytes: no bank conflicts and no padding. Rows past D (D = 36: tiles of
//    8 rows) compute on stale shared memory and are never stored.
// C. The tiles' clip(mean + acc) go into shared memory over z, the block
//    writes the (D, S) action tile with coalesced 16-byte stores (4-byte
//    ones when N is not a multiple of 4), masked at N, and threads 0..S-1
//    each run their sample's rollout on a[4] read from shared memory with
//    quad::rollout_step<kReward> (shared with K4-K7; out of line, see
//    rollout_cost), every disturbance mode (a launch argument) and reward
//    (a template) through this body.
// Against the earlier design (one sample a thread, F and the block's z in
// 128 KB of shared memory) this takes the three causes of its time in turn:
// S = 64 samples a block (not 128) and 48 KB of shared memory (not 128)
// give 128 blocks at N = 8192 (not 64) and four blocks an SM (not one); the
// correlate loads one 16-byte operand per 16 FMAs (not 4 loads per 4); the
// draw and the correlate run on all T threads, not one per sample.
//
// Why fp32 FMAs in this order: each action a[r][n] is one fmaf chain,
// acc = fmaf(F[r][d], z[d][n], acc) from 0.0f over d = 0..D-1 in increasing
// order, then clip1(mean[r] + acc), exactly the earlier kernel's chain: no
// split over d, no TF32, no reassociation. So every action keeps its bits
// for any S, T or stage width, every cost too (rollout_cost), and the
// closed loops keep their digits.
//
// Resources (ptxas, sm_90a, CUDA 12.9): 122 registers a thread in every
// instantiation, no spills, an 80-byte stack frame (rollout_cost's call);
// 49,152 bytes of dynamic shared memory a block at S = 64, D = 128 (81,920
// at S = 128), so four blocks an SM (two at S = 128).
// joint_sample_rollout_info reports them at run time.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "quad_core.cuh"

namespace {

constexpr int kMaxD = 128;  // the largest D = 4H a block takes (H <= 32)
// threads of a block of 64 samples and of one of 128 samples
constexpr int kThreads64 = 128;
constexpr int kThreads128 = 256;
// columns of F one stage of the correlate holds (kMaxD: F whole, one stage)
constexpr int kKC = 16;
constexpr int kTC = 8;  // samples of a thread's tile: two groups of 4

// A block of kS samples on kT threads: kSG sample groups x kRG row groups,
// each thread a tile of kTR rows x kTC samples covering kMaxD rows at once.
template <int kS, int kT>
struct Geometry {
  static constexpr int kSG = kS / kTC;
  static constexpr int kRG = kT / kSG;
  static constexpr int kTR = kMaxD / kRG;
  static_assert(kSG % 8 == 0 && kSG * kRG == kT && kRG * kTR == kMaxD,
                "a quarter warp shares a row group; the tiles cover kMaxD rows");
  // rows of a stage: D rounded up to whole tiles
  __host__ __device__ static int rows(int D) { return (D + kTR - 1) / kTR * kTR; }
  __host__ __device__ static int stages(int D) { return D > kKC ? 2 : 1; }
  // the F stages, then the (D, S) tile of z and, after the correlate, of a
  __host__ __device__ static size_t smem_floats(int D) {
    return static_cast<size_t>(stages(D)) * rows(D) * kKC +
           static_cast<size_t>(D) * kS;
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Columns [d0, d0 + kKC) of F (D, D) into the stage Fb (rows of kKC), by
// 16-byte cp.async.
template <int kT>
__device__ __forceinline__ void load_stage(float* Fb, const float* F, int D,
                                           int d0, int tid) {
  const int q4 = min(kKC, D - d0) / 4;
  for (int i = tid; i < D * q4; i += kT) {
    const int r = i / q4, q = i - r * q4;
    cp_async16(Fb + r * kKC + 4 * q, F + static_cast<size_t>(r) * D + d0 + 4 * q);
  }
}

// The block's (D, S) action tile a_s into out (scenario-offset actions),
// masked at N.
template <int kS, int kT>
__device__ __forceinline__ void store_actions(float* out, const float* a_s,
                                              int D, int N, int n0, int tid) {
  if ((N & 3) == 0) {
    for (int i = tid; i < D * (kS / 4); i += kT) {
      const int d = i / (kS / 4), s = 4 * (i % (kS / 4));
      if (n0 + s < N) {
        *reinterpret_cast<float4*>(out + static_cast<size_t>(d) * N + n0 + s) =
            *reinterpret_cast<const float4*>(a_s + d * kS + s);
      }
    }
  } else {
    for (int i = tid; i < D * kS; i += kT) {
      const int n = n0 + i % kS;
      if (n < N) out[static_cast<size_t>(i / kS) * N + n] = a_s[i];
    }
  }
}

// One sample's H-step rollout cost under its actions a[(4h + k) stride],
// the step quad::rollout_step. Kept out of line on purpose: inlined into
// the kernel, ptxas shared two of the step's products with the quaternion
// normalization and fused them differently from the one-sample-a-thread
// kernel before, so costs moved in their last bits (up to 3e-6 in a third of
// the realworld samples); compiled on its own it contracts them as that
// kernel did, and every cost keeps its bits (tools/joint_rollout_variants.py).
template <int kReward>
__device__ __noinline__ float rollout_cost(const quad::Tables& t,
                                           int check_rollover, int mode,
                                           const float* a, int stride, int H) {
  const quad::RolloutShared sh = quad::load_shared(t, check_rollover, mode);
  quad::Carry c = quad::start(t.x0);
  for (int h = 0; h < H; ++h) {
    const float* ah = a + 4 * h * stride;
    const float a4[4] = {ah[0], ah[stride], ah[2 * stride], ah[3 * stride]};
    quad::rollout_step<kReward>(c, sh, h, a4);
  }
  return c.cost;
}

template <int kS, int kT, int kReward>
__global__ void __launch_bounds__(kT) joint_sample_rollout_kernel(
    const float* __restrict__ x0, const float* __restrict__ scal,
    const int* __restrict__ ints, const float* __restrict__ ptar,
    const float* __restrict__ vtar, const float* __restrict__ dist,
    const float* __restrict__ mean, const float* __restrict__ factor,
    const float* __restrict__ z, const uint64_t* __restrict__ seed_p,
    const int* __restrict__ offset_p, float* __restrict__ costs,
    float* __restrict__ actions, int N, int H, int check_rollover, int mode) {
  using G = Geometry<kS, kT>;
  constexpr int kSG = G::kSG, kTR = G::kTR;
  extern __shared__ __align__(16) float smem[];
  const int D = 4 * H;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kS;
  const int b = blockIdx.y;
  const size_t off = static_cast<size_t>(b) * D * N;  // scenario b of z and actions
  const float* F = factor + static_cast<size_t>(b) * D * D;
  const float* mu = mean + static_cast<size_t>(b) * D;
  const int stage = G::rows(D) * kKC;  // floats of one F stage
  float* F_s = smem;
  float* z_s = smem + G::stages(D) * stage;  // z_s[d * kS + s], later a
  const int nchunks = (D + kKC - 1) / kKC;
  // the thread's tile: rows r0 .. r0 + kTR - 1, samples 4 sg + 4 kSG q + 0..3
  const int sg = tid % kSG;
  const int r0 = (tid / kSG) * kTR;

  // phase A: F's first stage loads while the block draws (or loads) z
  load_stage<kT>(F_s, F, D, 0, tid);
  cp_async_commit();
  if (z != nullptr) {
    for (int i = tid; i < D * kS; i += kT) {
      const int n = n0 + i % kS;
      z_s[i] = n < N ? z[off + static_cast<size_t>(i / kS) * N + n] : 0.0f;
    }
  } else {
    const uint64_t seed = *seed_p;
    const uint32_t slot = rng::scenario_slot(b, offset_p);
    for (int i = tid; i < (D / 4) * kS; i += kT) {
      const int j = i / kS, s = i % kS;
      float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (n0 + s < N) {
        r = rng::normals4(make_uint4(static_cast<uint32_t>(j),
                                     static_cast<uint32_t>(n0 + s), 0u, slot),
                          seed);
      }
      float* zj = z_s + 4 * j * kS + s;
      zj[0] = r.x;
      zj[kS] = r.y;
      zj[2 * kS] = r.z;
      zj[3 * kS] = r.w;
    }
  }

  // phase B: acc = F z over the stages, each a chain over d in order
  float acc[kTR][kTC];
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
#pragma unroll
    for (int j = 0; j < kTC; ++j) acc[i][j] = 0.0f;
  }
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      load_stage<kT>(F_s + ((c + 1) & 1) * stage, F, D, (c + 1) * kKC, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage c and (first time) z are in place
    if (r0 < D) {
      const float* Fc = F_s + (c & 1) * stage + r0 * kKC;
      const int d0 = c * kKC;
      const int w = min(kKC, D - d0);
      for (int dl = 0; dl < w; dl += 4) {
        float zr[4][kTC];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float* zk = z_s + (d0 + dl + k) * kS + 4 * sg;
#pragma unroll
          for (int q = 0; q < kTC / 4; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(zk + 4 * kSG * q);
            zr[k][4 * q] = v.x;
            zr[k][4 * q + 1] = v.y;
            zr[k][4 * q + 2] = v.z;
            zr[k][4 * q + 3] = v.w;
          }
        }
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          const float4 f = *reinterpret_cast<const float4*>(Fc + i * kKC + dl);
#pragma unroll
          for (int j = 0; j < kTC; ++j) {
            acc[i][j] = fmaf(f.x, zr[0][j], acc[i][j]);
            acc[i][j] = fmaf(f.y, zr[1][j], acc[i][j]);
            acc[i][j] = fmaf(f.z, zr[2][j], acc[i][j]);
            acc[i][j] = fmaf(f.w, zr[3][j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();  // every read of this stage (and, last, of z) is done
  }

  // phase C: a = clip(mean + acc) over z, the action tile out, the rollout
  if (r0 < D) {
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const int r = r0 + i;
      if (r < D) {
        const float m = mu[r];
#pragma unroll
        for (int q = 0; q < kTC / 4; ++q) {
          *reinterpret_cast<float4*>(z_s + r * kS + 4 * sg + 4 * kSG * q) =
              make_float4(quad::clip1(m + acc[i][4 * q]),
                          quad::clip1(m + acc[i][4 * q + 1]),
                          quad::clip1(m + acc[i][4 * q + 2]),
                          quad::clip1(m + acc[i][4 * q + 3]));
        }
      }
    }
  }
  __syncthreads();
  store_actions<kS, kT>(actions + off, z_s, D, N, n0, tid);

  const int n = n0 + tid;
  if (tid >= kS || n >= N) return;
  const quad::Tables t =
      quad::scenario_tables(b, H, x0, scal, ints, ptar, vtar, dist);
  costs[static_cast<size_t>(b) * N + n] =
      rollout_cost<kReward>(t, check_rollover, mode, z_s + tid, kS, H);
}

template <int kS, int kT>
int launch_tile(const float* x0, const float* scal, const int* ints,
                const float* ptar, const float* vtar, const float* dist,
                const float* mean, const float* factor, const float* z,
                const uint64_t* seed, const int* offset, float* costs,
                float* actions, int B, int N, int H, int check_rollover,
                int mode, int reward, cudaStream_t stream) {
  const size_t smem = sizeof(float) * Geometry<kS, kT>::smem_floats(4 * H);
  const auto kernel = reward == quad::kRealworld
                          ? joint_sample_rollout_kernel<kS, kT, quad::kRealworld>
                          : joint_sample_rollout_kernel<kS, kT, quad::kPenyaw>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kS - 1) / kS, B);
  kernel<<<grid, kT, smem, stream>>>(x0, scal, ints, ptar, vtar, dist, mean,
                                     factor, z, seed, offset, costs, actions, N, H,
                                     check_rollover, mode);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int launch(const float* x0, const float* scal, const int* ints,
           const float* ptar, const float* vtar, const float* dist,
           const float* mean, const float* factor, const float* z,
           const uint64_t* seed, const int* offset, float* costs,
           float* actions, int B, int N, int H, int check_rollover, int mode,
           int reward, int block, cudaStream_t stream) {
  // F's stages are 16-byte copies and the action tile 16-byte stores
  if (B <= 0 || B > quad::kMaxScenarios || N <= 0 || H <= 0 ||
      4 * H > kMaxD || (block != 64 && block != 128) ||
      mode < quad::kShared || mode > quad::kMixed ||
      reward < quad::kPenyaw || reward > quad::kRealworld ||
      !aligned16(factor) || !aligned16(actions) ||
      (z == nullptr && seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto run = block == 64 ? launch_tile<64, kThreads64>
                               : launch_tile<128, kThreads128>;
  return run(x0, scal, ints, ptar, vtar, dist, mean, factor, z, seed, offset,
             costs, actions, B, N, H, check_rollover, mode, reward, stream);
}

template <int kS, int kT>
int info(int H, int* out) {
  const size_t smem = sizeof(float) * Geometry<kS, kT>::smem_floats(4 * H);
  out[0] = kT;
  out[1] = static_cast<int>(smem);
  const decltype(&joint_sample_rollout_kernel<kS, kT, quad::kPenyaw>) kernels[] = {
      joint_sample_rollout_kernel<kS, kT, quad::kPenyaw>,
      joint_sample_rollout_kernel<kS, kT, quad::kRealworld>};
  for (int k = 0; k < 2; ++k) {
    cudaError_t err = cudaFuncSetAttribute(
        kernels[k], cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2 + 3 * k],
                                                        kernels[k], kT, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernels[k]);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[3 + 3 * k] = attr.numRegs;
    out[4 + 3 * k] = static_cast<int>(attr.localSizeBytes);
  }
  return 0;
}

}  // namespace

// K1: one scenario. Launch on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue (nothing launched) for a block other than 64 or
// 128, H > 32, a factor or actions pointer not 16-byte aligned, or neither
// z nor seed given. z may be null: the kernel then draws in-kernel, keyed by
// the device word `seed` points to (null when z is given).
extern "C" int joint_sample_rollout(
    const float* x0, const float* scal, const int* ints, const float* ptar,
    const float* vtar, const float* dist, const float* mean,
    const float* factor, const float* z, const uint64_t* seed, float* costs,
    float* actions, int N, int H, int check_rollover, int mode, int reward,
    int block, cudaStream_t stream) {
  return launch(x0, scal, ints, ptar, vtar, dist, mean, factor, z, seed,
                nullptr, costs, actions, 1, N, H, check_rollover, mode, reward,
                block, stream);
}

// K7, joint: B scenarios, every table scenario-strided; mean (B, D), factor
// (B, D, D), z (B, D, N) or null, costs (B, N), actions (B, D, N). offset,
// when not null, points to the device word o of the episodes' offset:
// scenario b draws as slot o + b (rng::scenario_slot).
extern "C" int joint_sample_rollout_batched(
    const float* x0, const float* scal, const int* ints, const float* ptar,
    const float* vtar, const float* dist, const float* mean,
    const float* factor, const float* z, const uint64_t* seed,
    const int* offset, float* costs, float* actions, int B, int N, int H,
    int check_rollover, int mode, int reward, int block, cudaStream_t stream) {
  return launch(x0, scal, ints, ptar, vtar, dist, mean, factor, z, seed,
                offset, costs, actions, B, N, H, check_rollover, mode, reward,
                block, stream);
}

// The launch geometry and resources of a block of `block` samples at
// horizon H, into out[0..7]: threads, dynamic shared memory (bytes), then
// for the penyaw and the realworld instantiation each: blocks an SM can
// hold, registers of a thread, local memory of a thread (bytes: a stack
// frame or spills).
extern "C" int joint_sample_rollout_info(int block, int H, int* out) {
  if (H <= 0 || 4 * H > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  if (block == 64) return info<64, kThreads64>(H, out);
  if (block == 128) return info<128, kThreads128>(H, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
