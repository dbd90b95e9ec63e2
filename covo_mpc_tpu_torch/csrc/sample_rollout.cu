// Per-step sample + rollout: MPPI's fused MVN draw and N x H rollout (K5).
//
// Replaces covo_mpc_tpu/ops/rollout_pallas.py::make_pallas_rollout_sampling
// (_rollout_kernel with sample="prng" or "input_z", disturbance mode
// "shared" or "krng"). Per sample n and step h: z_h ~ N(0, I_4) (or
// z[(4h + k) * N + n] when a z pointer is given, the "input_z" mode), then
// a_h = clip(mean_h + L_h z_h, +-1) with L_h the step's lower-triangular
// 4x4 Cholesky factor, read row-major (chol[16h + 4i + j]), written once to
// actions[(4h + k) * N + n] and fed to quad::rollout_step. Outputs costs
// (N,) and the clipped actions (4H, N), sample-last.
//
// Disturbance: "shared" takes the force of steps >= 1 from the scalar pack.
// "krng" (krng != 0) draws it here: every thread derives the same three
// standard normals from Philox keyed by disturb_seed, counter (0, 0, 1, 0)
// (word 2 set: disjoint from the action stream even for equal seeds), and
// scales them by scal[kDraw0], the effective noise scale; the TPU kernel's
// per-solve shared draw. draw_out (3,), when given, receives the normals
// (thread 0 of block 0): a test feeds them back to the plain version.
//
// What bounds it on an H100: the action write, 4 MB at N=8192, H=32
// (~1.3 us at 3.35 TB/s), and per sample 32 Philox calls (~10 integer
// multiply rounds each), 64 log/sqrt/sincos for Box-Muller, 10 FMAs of the
// correlate and ~5k flops of rollout per step chain. Like K4, at N=8192 it
// is 64 blocks of 128 threads on 132 SMs, bound by the latency of one
// thread's 32 dependent steps.
//
// What the design does about it: one thread per sample, the draw counter
// (h, n) keyed by the 64-bit seed, so results do not depend on the block
// size; mean and L (20H floats, 2.5 KB at H=32) are broadcast loads that
// stay in L1, so no shared memory pins the occupancy (unlike K1's 128 KB).
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "quad_core.cuh"

namespace {

__global__ void sample_rollout_kernel(
    const float* __restrict__ x0, const float* __restrict__ scal,
    const int* __restrict__ ints, const float* __restrict__ ptar,
    const float* __restrict__ vtar, const float* __restrict__ mean,
    const float* __restrict__ chol, const float* __restrict__ z,
    uint64_t seed, uint64_t disturb_seed, int krng,
    float* __restrict__ draw_out, float* __restrict__ costs,
    float* __restrict__ actions, int N, int H, int check_rollover) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  quad::RolloutShared sh =
      quad::load_shared(x0, scal, ints, ptar, vtar, check_rollover);
  if (krng) {
    const float4 d = rng::normals4(make_uint4(0u, 0u, 1u, 0u), disturb_seed);
    const float eff = scal[quad::kDraw0];
    sh.fx = eff * d.x;
    sh.fy = eff * d.y;
    sh.fz = eff * d.z;
    if (draw_out != nullptr && n == 0) {
      draw_out[0] = d.x;
      draw_out[1] = d.y;
      draw_out[2] = d.z;
    }
  }

  quad::Carry c = quad::start(x0);
  for (int h = 0; h < H; ++h) {
    float4 zh;
    if (z != nullptr) {
      const float* z_h = z + (size_t)(4 * h) * N + n;
      zh = make_float4(z_h[0], z_h[N], z_h[2 * (size_t)N], z_h[3 * (size_t)N]);
    } else {
      zh = rng::normals4(
          make_uint4(static_cast<uint32_t>(h), static_cast<uint32_t>(n), 0u, 0u),
          seed);
    }
    const float* m = mean + 4 * h;
    const float* L = chol + 16 * h;
    const float a[4] = {
        quad::clip1(m[0] + L[0] * zh.x),
        quad::clip1(m[1] + L[4] * zh.x + L[5] * zh.y),
        quad::clip1(m[2] + L[8] * zh.x + L[9] * zh.y + L[10] * zh.z),
        quad::clip1(m[3] + L[12] * zh.x + L[13] * zh.y + L[14] * zh.z +
                    L[15] * zh.w)};
    for (int k = 0; k < 4; ++k) actions[(size_t)(4 * h + k) * N + n] = a[k];
    quad::rollout_step(c, sh, h, a);
  }
  costs[n] = c.cost;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError(). z may be null (draw
// in-kernel from `seed`); draw_out may be null.
extern "C" int sample_rollout(
    const float* x0, const float* scal, const int* ints, const float* ptar,
    const float* vtar, const float* mean, const float* chol, const float* z,
    uint64_t seed, uint64_t disturb_seed, int krng, float* draw_out,
    float* costs, float* actions, int N, int H, int check_rollover, int block,
    cudaStream_t stream) {
  if (N <= 0 || H <= 0 || block <= 0 || block > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (N + block - 1) / block;
  sample_rollout_kernel<<<grid, block, 0, stream>>>(
      x0, scal, ints, ptar, vtar, mean, chol, z, seed, disturb_seed, krng,
      draw_out, costs, actions, N, H, check_rollover);
  return static_cast<int>(cudaGetLastError());
}
