// The earlier design of csrc/primal.cu (one thread runs every step, its
// loads and side chains in line), kept as it was so that chip_smoke.py
// and tools/primal_chain_variants.py time it beside the kernel that
// replaced it, in one run, and hold the new kernel's bits against it.
// Not part of the kernel library.
//
// Primal: the Hessian's nominal rollout, one trajectory of H steps.
//
// Replaces covo_mpc_tpu/ops/rollout_pallas.py::make_pallas_primal
// (_primal_kernel): from x0, H sequential 13-dim bodyrate steps under the
// raw nominal actions (clipped inside the step, as step_env does) and an
// (H, 3) disturbance table; writes the PRE-step state of every step, (H, 13).
//
// What bounds it on an H100: nothing but latency. The work is H dependent
// steps of ~100 flops on one trajectory (about 3k flops at H=32) and 2 KB of
// output; the launch itself costs more than the arithmetic.
//
// What the design does about it: one thread runs the chain with the whole
// state in registers (a batch of one gives nothing to spread across
// threads), and the physics comes from quad_core.cuh, the definition the
// joint sample + rollout kernel uses too.
#include <cuda_runtime.h>

#include "quad_core.cuh"

namespace {

__global__ void primal_kernel(const float* __restrict__ x0,
                              const float* __restrict__ scal,
                              const float* __restrict__ a,
                              const float* __restrict__ dist,
                              float* __restrict__ states, int H) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  quad::State s = quad::load_state(x0);
  for (int h = 0; h < H; ++h) {
    float* out = states + 13 * h;
    out[0] = s.px; out[1] = s.py; out[2] = s.pz;
    out[3] = s.qx; out[4] = s.qy; out[5] = s.qz; out[6] = s.qw;
    out[7] = s.vx; out[8] = s.vy; out[9] = s.vz;
    out[10] = s.wx; out[11] = s.wy; out[12] = s.wz;
    const float act[4] = {a[4 * h], a[4 * h + 1], a[4 * h + 2], a[4 * h + 3]};
    quad::dyn_step(s, act, dist[3 * h], dist[3 * h + 1], dist[3 * h + 2],
                   scal);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError(). scal holds the first ten
// entries of the scalar pack (quad::Scal, m .. discount).
extern "C" int primal(const float* x0, const float* scal, const float* a,
                      const float* dist, float* states, int H,
                      cudaStream_t stream) {
  if (H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  primal_kernel<<<1, 32, 0, stream>>>(x0, scal, a, dist, states, H);
  return static_cast<int>(cudaGetLastError());
}
