// Joint sample + rollout: CoVO's fused MVN draw and N x H rollout, for one
// scenario (K1) or for B scenarios in one launch (K7, joint).
//
// Replaces covo_mpc_tpu/ops/rollout_pallas.py::make_pallas_rollout_joint_sampling
// (_rollout_kernel with sample="prng_joint", every disturbance mode and
// reward) and ::make_pallas_rollout_batched_sampling with joint=True (the
// same kernel with batched=True over a (B, lane-tiles) grid). Per scenario b
// and sample n: z ~ N(0, I_D) (or z[(b D + d) N + n] when a z pointer is
// given, the "input_z" mode of the Pallas kernel), a = clip(mean_b + F_b z,
// +-1) with F_b the Sigma-designer's full (D, D) factor of scenario b, then
// H steps of pre-step reward (penyaw or realworld), termination freeze
// (|pos| > 3 or time up; rollover optional), bodyrate step and discounted
// cost. Outputs costs
// (B, N) and the clipped actions (B, D, N), sample-last; x0, the packs and
// the targets are scenario-strided (quad::scenario_tables), the means
// (B, D), the factors (B, D, D).
//
// What bounds it on an H100: the correlate is D^2 fp32 FMAs per sample
// (134 MFMA per scenario at N=8192, D=128, ~4 us at the 67 TFLOP/s fp32
// peak) and the action write is 4 MB per scenario (~1.3 us at 3.35 TB/s);
// the rollout is ~5k flops per sample. One scenario is latency-bound, not
// throughput-bound: F (64 KB) and the block's z (64 KB at 128 threads) sit
// in 128 KB of dynamic shared memory, so one block of 4 warps runs per SM,
// and N=8192 fills only 64 blocks of the 132 SMs. B scenarios are B x 64
// blocks, one scenario per block, so from B = 3 on the card is full and the
// launch runs in waves of 132 blocks. A later PR should split a sample's
// correlate over a warp or run it on tensor cores (wgmma).
//
// What the design does about it: one thread per sample, the scenario in
// blockIdx.y, so results depend neither on the block size nor on B. Each
// block stages its own scenario's F. z is staged d-major in shared memory
// (thread-minor: conflict-free), F rows are read as shared-memory
// broadcasts, and the four rows of step h are accumulated together in one
// pass over d, so each z load feeds four FMA chains. Each row sums over d in
// order 0..D-1 for every sample. The actions of step h are formed right
// before the step and written once (coalesced across the warp); they are
// never read back. The draw is Philox4x32-10 (philox.cuh) keyed by the
// 64-bit seed, with counter (j, n, 0, b): one call gives 4 uniforms -> 2
// Box-Muller pairs -> z rows 4j..4j+3 of sample n of scenario b, so
// scenario 0 draws what K1 draws. The step after the action formation is
// quad::rollout_step, shared with K4-K7.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "quad_core.cuh"

namespace {

template <int kReward>
__global__ void joint_sample_rollout_kernel(
    const float* __restrict__ x0, const float* __restrict__ scal,
    const int* __restrict__ ints, const float* __restrict__ ptar,
    const float* __restrict__ vtar, const float* __restrict__ dist,
    const float* __restrict__ mean, const float* __restrict__ factor,
    const float* __restrict__ z, uint64_t seed, float* __restrict__ costs,
    float* __restrict__ actions, int N, int H, int check_rollover, int mode) {
  extern __shared__ float smem[];
  const int D = 4 * H;
  const int B = blockDim.x;
  const int tid = threadIdx.x;
  const int n = blockIdx.x * B + tid;
  const int b = blockIdx.y;
  const size_t off = (size_t)b * D * N;  // scenario b of z and actions
  const float* F = factor + (size_t)b * D * D;
  const float* mu = mean + (size_t)b * D;
  float* F_s = smem;           // (D, D) row-major
  float* z_s = smem + D * D;   // z_s[d * B + tid]

  for (int i = tid; i < D * D; i += B) F_s[i] = F[i];
  if (n < N) {
    if (z != nullptr) {
      for (int d = 0; d < D; ++d) z_s[d * B + tid] = z[off + (size_t)d * N + n];
    } else {
      for (int j = 0; j < D / 4; ++j) {
        const float4 r = rng::normals4(
            make_uint4(static_cast<uint32_t>(j), static_cast<uint32_t>(n), 0u,
                       static_cast<uint32_t>(b)),
            seed);
        z_s[(4 * j + 0) * B + tid] = r.x;
        z_s[(4 * j + 1) * B + tid] = r.y;
        z_s[(4 * j + 2) * B + tid] = r.z;
        z_s[(4 * j + 3) * B + tid] = r.w;
      }
    }
  }
  __syncthreads();
  if (n >= N) return;

  const quad::Tables t =
      quad::scenario_tables(b, H, x0, scal, ints, ptar, vtar, dist);
  const quad::RolloutShared sh = quad::load_shared(t, check_rollover, mode);
  quad::Carry c = quad::start(t.x0);
  for (int h = 0; h < H; ++h) {
    // a_h = clip(mean_h + F[4h:4h+4] z): four rows, one pass over d
    const float* F0 = F_s + (4 * h) * D;
    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float zd = z_s[d * B + tid];
      acc0 = fmaf(F0[d], zd, acc0);
      acc1 = fmaf(F0[D + d], zd, acc1);
      acc2 = fmaf(F0[2 * D + d], zd, acc2);
      acc3 = fmaf(F0[3 * D + d], zd, acc3);
    }
    const float a[4] = {quad::clip1(mu[4 * h] + acc0),
                        quad::clip1(mu[4 * h + 1] + acc1),
                        quad::clip1(mu[4 * h + 2] + acc2),
                        quad::clip1(mu[4 * h + 3] + acc3)};
    for (int k = 0; k < 4; ++k) actions[off + (size_t)(4 * h + k) * N + n] = a[k];
    quad::rollout_step<kReward>(c, sh, h, a);
  }
  costs[(size_t)b * N + n] = c.cost;
}

int launch(const float* x0, const float* scal, const int* ints,
           const float* ptar, const float* vtar, const float* dist,
           const float* mean, const float* factor, const float* z,
           uint64_t seed, float* costs, float* actions, int B, int N, int H,
           int check_rollover, int mode, int reward, int block,
           cudaStream_t stream) {
  if (B <= 0 || B > quad::kMaxScenarios || N <= 0 || H <= 0 || block <= 0 ||
      block > 1024 || mode < quad::kShared || mode > quad::kMixed ||
      reward < quad::kPenyaw || reward > quad::kRealworld) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int D = 4 * H;
  const size_t smem = sizeof(float) * (static_cast<size_t>(D) * D +
                                       static_cast<size_t>(D) * block);
  const auto kernel = reward == quad::kRealworld
                          ? joint_sample_rollout_kernel<quad::kRealworld>
                          : joint_sample_rollout_kernel<quad::kPenyaw>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + block - 1) / block, B);
  kernel<<<grid, block, smem, stream>>>(x0, scal, ints, ptar, vtar, dist, mean,
                                        factor, z, seed, costs, actions, N, H,
                                        check_rollover, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1: one scenario. Launch on `stream`; returns cudaGetLastError(). z may
// be null (draw in-kernel from `seed`).
extern "C" int joint_sample_rollout(
    const float* x0, const float* scal, const int* ints, const float* ptar,
    const float* vtar, const float* dist, const float* mean,
    const float* factor, const float* z, uint64_t seed, float* costs,
    float* actions, int N, int H, int check_rollover, int mode, int reward,
    int block, cudaStream_t stream) {
  return launch(x0, scal, ints, ptar, vtar, dist, mean, factor, z, seed,
                costs, actions, 1, N, H, check_rollover, mode, reward, block,
                stream);
}

// K7, joint: B scenarios, every table scenario-strided; mean (B, D), factor
// (B, D, D), z (B, D, N) or null, costs (B, N), actions (B, D, N).
extern "C" int joint_sample_rollout_batched(
    const float* x0, const float* scal, const int* ints, const float* ptar,
    const float* vtar, const float* dist, const float* mean,
    const float* factor, const float* z, uint64_t seed, float* costs,
    float* actions, int B, int N, int H, int check_rollover, int mode, int reward,
    int block, cudaStream_t stream) {
  return launch(x0, scal, ints, ptar, vtar, dist, mean, factor, z, seed,
                costs, actions, B, N, H, check_rollover, mode, reward, block,
                stream);
}
