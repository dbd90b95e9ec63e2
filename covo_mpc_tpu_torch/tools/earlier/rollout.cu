// The earlier design of csrc/rollout.cu (one thread a sample runs every
// step, the reward and the state chain in one instruction stream, the
// disturbance mode a runtime branch), kept as it was so that chip_smoke.py
// and tools/rollout_variants.py time it beside the kernels that replaced
// it, in one run, and hold their costs against it bit for bit. Not part of
// the kernel library.
//
// Rollout costs of given actions: N samples x H steps, for one scenario
// (K4) or for B scenarios in one launch (K6).
//
// Replaces covo_mpc_tpu/ops/rollout_pallas.py::make_pallas_rollout
// (_rollout_kernel with sample="", every disturbance mode and reward) and
// ::make_pallas_rollout_batched (the same kernel with batched=True over a
// (B, lane-tiles) grid). Per scenario b and sample n: H steps of
// quad::rollout_step (pre-step penyaw or realworld reward, termination
// freeze, bodyrate step, discounted cost) under the actions
// actions[((b H + h) 4 + k) N + n], the sample-last (B, H, 4, N) layout.
// Costs only, as the TPU kernels: no pose collection. The wrappers
// (ops/rollout_cuda.py::RolloutCosts, ::RolloutCostsBatched) permute
// (N, H, 4) actions to (H, 4, N) before the launch, as the JAX wrappers
// transpose outside their kernels.
//
// What bounds it on an H100: one read of the actions, 4 MB per scenario at
// N=8192, H=32 (~1.3 us at 3.35 TB/s), and ~5k fp32 flops per sample (~41
// MFLOP per scenario, under 1 us at the 67 TFLOP/s fp32 peak). One scenario
// at N=8192 is 64 blocks of 128 threads for 132 SMs: latency-bound, by the
// 32 dependent steps of one thread, not by bytes or flops. B scenarios are
// B x 64 blocks, which fill the card from B = 3 on.
//
// What the design does about it: one thread per sample keeps the 13-component
// state in registers and reads each action once; a warp's loads of one
// (h, k) row are 32 neighbouring floats (coalesced). The scenario is
// blockIdx.y, so a block reads one scenario's x0, targets and scalar pack:
// the same address for every thread (broadcast loads). The ragged tail
// block is masked, and no result depends on the block size or on B.
#include <cuda_runtime.h>

#include "quad_core.cuh"

namespace {

template <int kReward>
__global__ void rollout_kernel(
    const float* __restrict__ x0, const float* __restrict__ scal,
    const int* __restrict__ ints, const float* __restrict__ ptar,
    const float* __restrict__ vtar, const float* __restrict__ dist,
    const float* __restrict__ actions, float* __restrict__ costs, int N, int H,
    int check_rollover, int mode) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int b = blockIdx.y;
  const quad::Tables t =
      quad::scenario_tables(b, H, x0, scal, ints, ptar, vtar, dist);
  const float* acts = actions + (size_t)b * 4 * H * N;
  const quad::RolloutShared sh = quad::load_shared(t, check_rollover, mode);
  quad::Carry c = quad::start(t.x0);
  for (int h = 0; h < H; ++h) {
    const float* a_h = acts + (size_t)(4 * h) * N + n;
    const float a[4] = {a_h[0], a_h[N], a_h[2 * (size_t)N],
                        a_h[3 * (size_t)N]};
    quad::rollout_step<kReward>(c, sh, h, a);
  }
  costs[(size_t)b * N + n] = c.cost;
}

int launch(const float* x0, const float* scal, const int* ints,
           const float* ptar, const float* vtar, const float* dist,
           const float* actions, float* costs, int B, int N, int H,
           int check_rollover, int mode, int reward, int block,
           cudaStream_t stream) {
  if (B <= 0 || B > quad::kMaxScenarios || N <= 0 || H <= 0 || block <= 0 ||
      block > 1024 || mode < quad::kShared || mode > quad::kMixed ||
      reward < quad::kPenyaw || reward > quad::kRealworld) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = reward == quad::kRealworld
                          ? rollout_kernel<quad::kRealworld>
                          : rollout_kernel<quad::kPenyaw>;
  const dim3 grid((N + block - 1) / block, B);
  kernel<<<grid, block, 0, stream>>>(x0, scal, ints, ptar, vtar, dist, actions,
                                     costs, N, H, check_rollover, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4: one scenario, in disturbance mode `mode` (quad::Mode). Launch on
// `stream`; returns cudaGetLastError().
extern "C" int rollout_costs(const float* x0, const float* scal,
                             const int* ints, const float* ptar,
                             const float* vtar, const float* dist,
                             const float* actions, float* costs, int N, int H,
                             int check_rollover, int mode, int reward,
                             int block, cudaStream_t stream) {
  return launch(x0, scal, ints, ptar, vtar, dist, actions, costs, 1, N, H,
                check_rollover, mode, reward, block, stream);
}

// K6: B scenarios, every table scenario-strided (quad::scenario_tables), the
// actions (B, H, 4, N), the costs (B, N).
extern "C" int rollout_costs_batched(const float* x0, const float* scal,
                                     const int* ints, const float* ptar,
                                     const float* vtar, const float* dist,
                                     const float* actions, float* costs, int B,
                                     int N, int H, int check_rollover,
                                     int mode, int reward, int block,
                                     cudaStream_t stream) {
  return launch(x0, scal, ints, ptar, vtar, dist, actions, costs, B, N, H,
                check_rollover, mode, reward, block, stream);
}
