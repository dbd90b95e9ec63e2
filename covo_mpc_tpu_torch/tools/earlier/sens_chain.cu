// The earlier design of csrc/sens_chain.cu (one block of D threads, a
// column a thread, all of J staged before the chain), kept as it was so
// that chip_smoke.py and tools/primal_chain_variants.py time it beside the
// kernel that replaced it, in one run, and hold the new kernel's bits
// against it. Not part of the kernel library.
//
// Sensitivity chain: the Hessian's forward first-order sensitivities.
//
// Replaces covo_mpc_tpu/ops/hessian_pallas.py::make_tail_pullback
// (_chain_kernel): T_h = [S1_h; E_h] and S1_{h+1} = J_h T_h, for h < H, with
// J_h the (sd, sd + 4) step Jacobian and E_h the h-th (4, D) identity block.
// Writes T (H, sd + 4, D). The pullback sum_h T_h^T M_h T_h stays outside,
// in two fp32 einsums, as it did in JAX.
//
// What bounds it on an H100: latency of H dependent steps. Each step is an
// (sd x (sd+4)) mat-vec per column, 221 FMAs at sd = 13: ~0.9 MFLOP in all
// at H = 32, D = 128, and the T write is 278 KB. Nothing here fills the card.
//
// What the design does about it: one block of D threads, thread x owns
// column x of T, so each step is a register-resident mat-vec with no
// synchronisation between steps. All J_h (28 KB at H = 32, sd = 13) are
// staged once in shared memory and read as broadcasts; T is written
// coalesced across the block. The chain runs in true fp32 (the Pallas
// kernel ran it at the TPU's default bf16 matmul precision). sd is a
// template parameter so S1 stays in registers; the C entry point takes it
// at run time (13 for the core state, 16 for the drag/mixed state).
#include <cuda_runtime.h>

namespace {

constexpr int kDA = 4;

template <int SD>
__global__ void sens_chain_kernel(const float* __restrict__ J,
                                  float* __restrict__ T, int H) {
  constexpr int Z = SD + kDA;
  extern __shared__ float J_s[];  // (H, SD, Z)
  const int D = blockDim.x;
  const int x = threadIdx.x;
  for (int i = x; i < H * SD * Z; i += D) J_s[i] = J[i];
  __syncthreads();

  float S1[SD];
#pragma unroll
  for (int k = 0; k < SD; ++k) S1[k] = 0.0f;
  for (int h = 0; h < H; ++h) {
    float t[Z];
#pragma unroll
    for (int k = 0; k < SD; ++k) t[k] = S1[k];
#pragma unroll
    for (int j = 0; j < kDA; ++j) t[SD + j] = (x == kDA * h + j) ? 1.0f : 0.0f;
    float* Th = T + static_cast<size_t>(h) * Z * D;
#pragma unroll
    for (int u = 0; u < Z; ++u) Th[u * D + x] = t[u];
    const float* Jh = J_s + h * SD * Z;
#pragma unroll
    for (int k = 0; k < SD; ++k) {
      float acc = 0.0f;
#pragma unroll
      for (int u = 0; u < Z; ++u) acc = fmaf(Jh[k * Z + u], t[u], acc);
      S1[k] = acc;
    }
  }
}

template <int SD>
cudaError_t launch(const float* J, float* T, int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * H * SD * (SD + kDA);
  cudaError_t err = cudaFuncSetAttribute(
      sens_chain_kernel<SD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  sens_chain_kernel<SD><<<1, kDA * H, smem, stream>>>(J, T, H);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError(). J is (H, sd, sd + dA),
// T (H, sd + dA, H * dA); dA must be 4 and sd 13 or 16.
extern "C" int sens_chain(const float* J, float* T, int H, int sd, int dA,
                          cudaStream_t stream) {
  if (dA != kDA || H <= 0 || kDA * H > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (sd == 13) return static_cast<int>(launch<13>(J, T, H, stream));
  if (sd == 16) return static_cast<int>(launch<16>(J, T, H, stream));
  return static_cast<int>(cudaErrorInvalidValue);
}
