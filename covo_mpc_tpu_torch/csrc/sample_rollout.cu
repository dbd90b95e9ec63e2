// Per-step sample + rollout: MPPI's fused MVN draw and N x H rollout, for
// one scenario (K5) or for B scenarios in one launch (K7, per-step).
//
// Replaces covo_mpc_tpu/ops/rollout_pallas.py::make_pallas_rollout_sampling
// (_rollout_kernel with sample="prng" or "input_z", every disturbance mode
// and reward, and "krng") and ::make_pallas_rollout_batched_sampling with
// joint=False (the same kernel with batched=True over a (B, lane-tiles)
// grid). Per scenario b, sample n and step h: z_h ~ N(0, I_4)
// (or z[((b H + h) 4 + k) N + n] when a z pointer is given, the "input_z"
// mode), then a_h = clip(mean_h + L_h z_h, +-1) with L_h the step's
// lower-triangular 4x4 Cholesky factor, read row-major (chol[16 (b H + h) +
// 4i + j]), written once to actions[((b H + h) 4 + k) N + n] and fed to
// quad::rollout_step. Outputs costs (B, N) and the clipped actions
// (B, 4H, N), sample-last; x0, the packs and the targets are scenario-
// strided (quad::scenario_tables), the means (B, H, 4).
//
// Disturbance: the mode of quad::rollout_step; "shared" takes the force of
// steps >= 1 from the scalar pack. "krng" (krng != 0, "shared" mode of the
// single-scenario K5 only) draws it here: every thread
// derives the same three standard normals from Philox keyed by
// disturb_seed, counter (0, 0, 1, b) (word 2 set: disjoint from the action
// stream even for equal seeds), and scales them by scal[kDraw0], the
// effective noise scale; the TPU kernel's per-solve shared draw. draw_out
// (3,), when given, receives the normals (thread 0 of block 0): a test
// feeds them back to the plain version.
//
// What bounds it on an H100: the action write, 4 MB per scenario at
// N=8192, H=32 (~1.3 us at 3.35 TB/s), and per sample 32 Philox calls (~10
// integer multiply rounds each), 64 log/sqrt/sincos for Box-Muller, 10 FMAs
// of the correlate and ~5k flops of rollout per step chain. Like K4, one
// scenario at N=8192 is 64 blocks of 128 threads on 132 SMs, bound by the
// latency of one thread's 32 dependent steps; B scenarios are B x 64
// blocks.
//
// What the design does about it: one thread per sample, the scenario in
// blockIdx.y, the draw counter (h, n, 0, b) keyed by the 64-bit seed, so
// results depend neither on the block size nor on B (scenario 0 draws what
// K5 draws); mean and L (20H floats, 2.5 KB per scenario at H=32) are
// broadcast loads that stay in L1, so no shared memory pins the occupancy
// (unlike K1's 128 KB).
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "quad_core.cuh"

namespace {

template <int kReward>
__global__ void sample_rollout_kernel(
    const float* __restrict__ x0, const float* __restrict__ scal,
    const int* __restrict__ ints, const float* __restrict__ ptar,
    const float* __restrict__ vtar, const float* __restrict__ dist,
    const float* __restrict__ mean, const float* __restrict__ chol,
    const float* __restrict__ z, uint64_t seed, uint64_t disturb_seed,
    int krng, float* __restrict__ draw_out, float* __restrict__ costs,
    float* __restrict__ actions, int N, int H, int check_rollover, int mode) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int b = blockIdx.y;
  const quad::Tables t =
      quad::scenario_tables(b, H, x0, scal, ints, ptar, vtar, dist);
  const size_t off = (size_t)b * 4 * H * N;  // scenario b of z and actions
  quad::RolloutShared sh = quad::load_shared(t, check_rollover, mode);
  if (krng) {
    const float4 d = rng::normals4(
        make_uint4(0u, 0u, 1u, static_cast<uint32_t>(b)), disturb_seed);
    const float eff = t.scal[quad::kDraw0];
    sh.fx = eff * d.x;
    sh.fy = eff * d.y;
    sh.fz = eff * d.z;
    if (draw_out != nullptr && n == 0 && b == 0) {
      draw_out[0] = d.x;
      draw_out[1] = d.y;
      draw_out[2] = d.z;
    }
  }

  quad::Carry c = quad::start(t.x0);
  for (int h = 0; h < H; ++h) {
    float4 zh;
    if (z != nullptr) {
      const float* z_h = z + off + (size_t)(4 * h) * N + n;
      zh = make_float4(z_h[0], z_h[N], z_h[2 * (size_t)N], z_h[3 * (size_t)N]);
    } else {
      zh = rng::normals4(
          make_uint4(static_cast<uint32_t>(h), static_cast<uint32_t>(n), 0u,
                     static_cast<uint32_t>(b)),
          seed);
    }
    const float* m = mean + 4 * (b * H + h);
    const float* L = chol + 16 * (b * H + h);
    const float a[4] = {
        quad::clip1(m[0] + L[0] * zh.x),
        quad::clip1(m[1] + L[4] * zh.x + L[5] * zh.y),
        quad::clip1(m[2] + L[8] * zh.x + L[9] * zh.y + L[10] * zh.z),
        quad::clip1(m[3] + L[12] * zh.x + L[13] * zh.y + L[14] * zh.z +
                    L[15] * zh.w)};
    for (int k = 0; k < 4; ++k) actions[off + (size_t)(4 * h + k) * N + n] = a[k];
    quad::rollout_step<kReward>(c, sh, h, a);
  }
  costs[(size_t)b * N + n] = c.cost;
}

int launch(const float* x0, const float* scal, const int* ints,
           const float* ptar, const float* vtar, const float* dist,
           const float* mean, const float* chol, const float* z, uint64_t seed,
           uint64_t disturb_seed, int krng, float* draw_out, float* costs,
           float* actions, int B, int N, int H, int check_rollover, int mode,
           int reward, int block, cudaStream_t stream) {
  if (B <= 0 || B > quad::kMaxScenarios || N <= 0 || H <= 0 || block <= 0 ||
      block > 1024 || mode < quad::kShared || mode > quad::kMixed ||
      reward < quad::kPenyaw || reward > quad::kRealworld ||
      (krng && mode != quad::kShared)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = reward == quad::kRealworld
                          ? sample_rollout_kernel<quad::kRealworld>
                          : sample_rollout_kernel<quad::kPenyaw>;
  const dim3 grid((N + block - 1) / block, B);
  kernel<<<grid, block, 0, stream>>>(x0, scal, ints, ptar, vtar, dist, mean,
                                     chol, z, seed, disturb_seed, krng,
                                     draw_out, costs, actions, N, H,
                                     check_rollover, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5: one scenario. Launch on `stream`; returns cudaGetLastError(). z may
// be null (draw in-kernel from `seed`); draw_out may be null.
extern "C" int sample_rollout(
    const float* x0, const float* scal, const int* ints, const float* ptar,
    const float* vtar, const float* dist, const float* mean, const float* chol,
    const float* z, uint64_t seed, uint64_t disturb_seed, int krng,
    float* draw_out, float* costs, float* actions, int N, int H,
    int check_rollover, int mode, int reward, int block, cudaStream_t stream) {
  return launch(x0, scal, ints, ptar, vtar, dist, mean, chol, z, seed,
                disturb_seed, krng, draw_out, costs, actions, 1, N, H,
                check_rollover, mode, reward, block, stream);
}

// K7, per-step: B scenarios, every table scenario-strided; mean (B, H, 4),
// chol (B, H, 4, 4), z (B, H, 4, N) or null, costs (B, N), actions
// (B, 4H, N).
extern "C" int sample_rollout_batched(
    const float* x0, const float* scal, const int* ints, const float* ptar,
    const float* vtar, const float* dist, const float* mean, const float* chol,
    const float* z, uint64_t seed, float* costs, float* actions, int B, int N,
    int H, int check_rollover, int mode, int reward, int block,
    cudaStream_t stream) {
  return launch(x0, scal, ints, ptar, vtar, dist, mean, chol, z, seed, 0, 0,
                nullptr, costs, actions, B, N, H, check_rollover, mode, reward,
                block, stream);
}
