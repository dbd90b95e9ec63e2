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
// single-scenario K5 only) draws it here: three standard normals from
// Philox keyed by the device word disturb_seed points to, counter (0, 0, 1,
// slot) (word 2 set: disjoint from the action stream even for equal seeds),
// scaled by scal[kDraw0], the
// effective noise scale; the TPU kernel's per-solve shared draw. draw_out
// (3,), when given, receives the normals (block 0 of scenario 0): a test
// feeds them back to the plain version.
//
// What bounds it on an H100: bytes, by chip_smoke.py's k5_bound: the action
// write, 4 MB per scenario at N = 8192, H = 32 (1.3 us at 3.35 TB/s),
// against per sample 32 Philox calls, 64 Box-Muller pairs, 24 operations of
// correlate and ~190 of rollout a step. Neither is in reach. At B = 1 a
// sample's 32 dependent rollout steps are one chain of latencies on a card
// that 64 or 128 blocks under-fill; the rollout of given actions alone (K4,
// rollout.cu, 0.028 ms) is that floor's yardstick. At B >= 2 the SMs are
// full and issue-bound: the rollout needs every warp an SM can hold to hide
// its chains (K6 alone 0.073 ms at B = 16), and the draws' instructions
// come on top.
//
// The design: two kernels, the launch picks one by the grid; their results
// are the same bit for bit, and `block` is S, the samples a block, in both.
// - The tile kernel, when the grid has no more blocks than the card has SMs
//   (K5 at N = 8192, S = 64: 128 blocks): a block of S samples of one
//   scenario (blockIdx.y) on kTileThreads = 512 threads, in two phases.
//   A. Draw with every thread. The block stages the scenario's factors and
//      means (20H floats) in shared memory; its H x S Philox calls are
//      spread over all 512 threads (8 a sample at S = 64), consecutive
//      threads on consecutive samples. The counter is (h, n, 0, slot),
//      slot = b + the episode offset (rng::scenario_slot; K7 only, 0 in K5),
//      keyed by the device word `seed` points to, in both kernels: the
//      normals depend neither on S nor B, scenario 0 at offset 0 draws what
//      K5 draws, and scenario b at offset o what scenario o + b draws at
//      offset 0. Both keys
//      are read on the device, so a CUDA graph that replays the launch
//      reads the words each solve writes (ops/sampling.py's seed stream).
//      a_h = clip1(mean_h + L_h z_h) is one
//      expression in both kernels, operand for operand, so the same fmaf
//      chains form and every action keeps its bits. The actions go into a
//      (4H, S) tile in shared memory; the given-z mode loads its tile of z
//      coalesced along samples instead of drawing.
//   B. Threads 0..S-1 each run their sample's H steps on the tile
//      (rollout_cost, out of line, its tables copied into registers), while
//      the other threads write the tile to `actions` in 16-byte stores
//      (4-byte ones when N is not a multiple of 4), masked at N.
//   So the draw leaves the sample's dependent chain, and the chain is the
//   rollout's alone, as in K4.
// - The step kernel, otherwise (K7 at B >= 2): one thread a sample; the
//   block stages its scenario's factors and means in shared memory, and
//   each step issues the next step's draw before its own rollout step, then
//   stores its actions in coalesced 4-byte stores. On a full card the
//   other warps hide the draws: the tile kernel loses there, its (4H, S)
//   tile (35 KB at S = 64) holding a fraction of the rollouts an SM holds
//   one thread a sample (tools/sample_rollout_variants.py).
// Both compile the rollout step so that every cost equals the earlier
// one-sample-a-thread kernel's bit for bit: inlined into the step kernel as
// there, out of line in the tile kernel with its tables in registers (read
// through the reference, or inlined, ptxas fuses the step's products
// otherwise and costs move in their last bits).
//
// Resources (ptxas, sm_90a, CUDA 12.9): sample_rollout_info reports, for
// each kernel at a block size, the threads, the dynamic shared memory ((4H S
// + 20H + 4) floats in the tile kernel, 20H in the step kernel), the blocks
// an SM holds, and the registers and local memory of a thread of each
// reward's instantiation.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "quad_core.cuh"

namespace {

constexpr int kTileThreads = 512;  // threads a block of the tile kernel

// Floats of a tile kernel block's dynamic shared memory: the (4H, kS) action
// tile, the scenario's factors (16H) and means (4H), the krng force.
template <int kS>
__host__ __device__ constexpr size_t tile_smem_floats(int H) {
  return static_cast<size_t>(4 * H) * kS + 20 * H + 4;
}

// Floats of a step kernel block's dynamic shared memory: the factors, means.
__host__ __device__ constexpr size_t step_smem_floats(int H) {
  return static_cast<size_t>(20) * H;
}

// The (4H, kS) tile a_s into out (scenario-offset actions), masked at N, by
// threads i0, i0 + stride, ...
template <int kS>
__device__ __forceinline__ void store_tile(float* out, const float* a_s, int H,
                                           int N, int n0, int i0, int stride) {
  const int D = 4 * H;
  if ((N & 3) == 0) {
    for (int i = i0; i < D * (kS / 4); i += stride) {
      const int d = i / (kS / 4), q = 4 * (i % (kS / 4));
      if (n0 + q < N) {
        *reinterpret_cast<float4*>(out + static_cast<size_t>(d) * N + n0 + q) =
            *reinterpret_cast<const float4*>(a_s + d * kS + q);
      }
    }
  } else {
    for (int i = i0; i < D * kS; i += stride) {
      const int n = n0 + i % kS;
      if (n < N) out[static_cast<size_t>(i / kS) * N + n] = a_s[i];
    }
  }
}

// One sample's H-step rollout cost under its actions a[(4h + k) stride],
// the step quad::rollout_step. Kept out of line, and the tables copied into
// registers for the loop: so compiled, ptxas fuses the step's products as
// in the step kernel, and every cost keeps its bits.
template <int kReward>
__device__ __noinline__ float rollout_cost(const quad::RolloutShared& shared,
                                           const float* x0, const float* a,
                                           int stride, int H) {
  const quad::RolloutShared sh = shared;
  quad::Carry c = quad::start(x0);
  for (int h = 0; h < H; ++h) {
    const float* ah = a + 4 * h * stride;
    const float a4[4] = {ah[0], ah[stride], ah[2 * stride], ah[3 * stride]};
    quad::rollout_step<kReward>(c, sh, h, a4);
  }
  return c.cost;
}

template <int kS, int kReward>
__global__ void __launch_bounds__(kTileThreads) sample_rollout_tile_kernel(
    const float* __restrict__ x0, const float* __restrict__ scal,
    const int* __restrict__ ints, const float* __restrict__ ptar,
    const float* __restrict__ vtar, const float* __restrict__ dist,
    const float* __restrict__ mean, const float* __restrict__ chol,
    const float* __restrict__ z, const uint64_t* __restrict__ seed_p,
    const int* __restrict__ offset_p,
    const uint64_t* __restrict__ disturb_seed_p, int krng,
    float* __restrict__ draw_out, float* __restrict__ costs,
    float* __restrict__ actions, int N, int H, int check_rollover, int mode) {
  constexpr int kT = kTileThreads;
  static_assert(kT % kS == 0 && kT > kS && kS % 32 == 0,
                "whole warps of whole sample rows, and threads to store");
  constexpr int kR = kT / kS;  // threads a sample's draws are spread over
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kS;
  const int b = blockIdx.y;
  const size_t off = static_cast<size_t>(b) * 4 * H * N;  // scenario b of z and actions
  const uint32_t slot = rng::scenario_slot(b, offset_p);
  float* a_s = smem;              // a_s[(4h + k) kS + s]
  float* L_s = a_s + 4 * H * kS;  // L_h row-major at L_s[16h]
  float* m_s = L_s + 16 * H;      // mean_h at m_s[4h]
  float* f_s = m_s + 4 * H;       // the krng force

  // phase A: the scenario's factors and means, the krng draw, then the tile
  const float* Lb = chol + static_cast<size_t>(16) * b * H;
  const float* mb = mean + static_cast<size_t>(4) * b * H;
  for (int i = tid; i < 16 * H; i += kT) L_s[i] = Lb[i];
  for (int i = tid; i < 4 * H; i += kT) m_s[i] = mb[i];
  if (krng && tid == 0) {
    const float4 d = rng::normals4(
        make_uint4(0u, 0u, 1u, slot), *disturb_seed_p);
    const float eff = scal[quad::kNScal * b + quad::kDraw0];
    f_s[0] = eff * d.x;
    f_s[1] = eff * d.y;
    f_s[2] = eff * d.z;
    if (draw_out != nullptr && blockIdx.x == 0 && b == 0) {
      draw_out[0] = d.x;
      draw_out[1] = d.y;
      draw_out[2] = d.z;
    }
  }
  __syncthreads();

  const int s = tid % kS;
  const int n = n0 + s;
  if (n < N) {
    const uint64_t seed = z != nullptr ? 0 : *seed_p;
    // this thread's steps: tid / kS, + kR, + 2 kR, ...
    for (int h = tid / kS; h < H; h += kR) {
      float4 zh;
      if (z != nullptr) {
        const float* z_h = z + off + static_cast<size_t>(4 * h) * N + n;
        zh = make_float4(z_h[0], z_h[N], z_h[2 * static_cast<size_t>(N)],
                         z_h[3 * static_cast<size_t>(N)]);
      } else {
        zh = rng::normals4(
            make_uint4(static_cast<uint32_t>(h), static_cast<uint32_t>(n), 0u, slot),
            seed);
      }
      const float* m = m_s + 4 * h;
      const float* L = L_s + 16 * h;
      float* a = a_s + 4 * h * kS + s;
      a[0] = quad::clip1(m[0] + L[0] * zh.x);
      a[kS] = quad::clip1(m[1] + L[4] * zh.x + L[5] * zh.y);
      a[2 * kS] = quad::clip1(m[2] + L[8] * zh.x + L[9] * zh.y + L[10] * zh.z);
      a[3 * kS] = quad::clip1(m[3] + L[12] * zh.x + L[13] * zh.y + L[14] * zh.z +
                              L[15] * zh.w);
    }
  }
  __syncthreads();

  // phase B: threads 0..kS-1 roll out, the others store the tile
  if (tid >= kS) {
    store_tile<kS>(actions + off, a_s, H, N, n0, tid - kS, kT - kS);
    return;
  }
  if (n >= N) return;
  const quad::Tables t =
      quad::scenario_tables(b, H, x0, scal, ints, ptar, vtar, dist);
  quad::RolloutShared sh = quad::load_shared(t, check_rollover, mode);
  if (krng) {
    sh.fx = f_s[0];
    sh.fy = f_s[1];
    sh.fz = f_s[2];
  }
  costs[static_cast<size_t>(b) * N + n] =
      rollout_cost<kReward>(sh, t.x0, a_s + tid, kS, H);
}

template <int kReward>
__global__ void sample_rollout_step_kernel(
    const float* __restrict__ x0, const float* __restrict__ scal,
    const int* __restrict__ ints, const float* __restrict__ ptar,
    const float* __restrict__ vtar, const float* __restrict__ dist,
    const float* __restrict__ mean, const float* __restrict__ chol,
    const float* __restrict__ z, const uint64_t* __restrict__ seed_p,
    const int* __restrict__ offset_p,
    const uint64_t* __restrict__ disturb_seed_p, int krng,
    float* __restrict__ draw_out, float* __restrict__ costs,
    float* __restrict__ actions, int N, int H, int check_rollover, int mode) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const uint32_t slot = rng::scenario_slot(b, offset_p);
  float* L_s = smem;           // L_h row-major at L_s[16h]
  float* m_s = smem + 16 * H;  // mean_h at m_s[4h]
  {
    const float* Lb = chol + static_cast<size_t>(16) * b * H;
    const float* mb = mean + static_cast<size_t>(4) * b * H;
    for (int i = threadIdx.x; i < 16 * H; i += blockDim.x) L_s[i] = Lb[i];
    for (int i = threadIdx.x; i < 4 * H; i += blockDim.x) m_s[i] = mb[i];
  }
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const quad::Tables t =
      quad::scenario_tables(b, H, x0, scal, ints, ptar, vtar, dist);
  const size_t off = (size_t)b * 4 * H * N;  // scenario b of z and actions
  quad::RolloutShared sh = quad::load_shared(t, check_rollover, mode);
  if (krng) {
    const float4 d = rng::normals4(
        make_uint4(0u, 0u, 1u, slot), *disturb_seed_p);
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
  const uint64_t seed = z != nullptr ? 0 : *seed_p;
  auto draw = [&](int h) {
    if (z != nullptr) {
      const float* z_h = z + off + (size_t)(4 * h) * N + n;
      return make_float4(z_h[0], z_h[N], z_h[2 * (size_t)N], z_h[3 * (size_t)N]);
    }
    return rng::normals4(
        make_uint4(static_cast<uint32_t>(h), static_cast<uint32_t>(n), 0u, slot),
        seed);
  };
  // step h + 1's draw is issued before step h's rollout, off its chain
  float4 znext = draw(0);
  for (int h = 0; h < H; ++h) {
    const float4 zh = znext;
    if (h + 1 < H) znext = draw(h + 1);
    const float* m = m_s + 4 * h;
    const float* L = L_s + 16 * h;
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

// Launch `kernel` on `grid` x `threads` with `smem` bytes of dynamic shared
// memory; returns cudaGetLastError(), or the error of a refused shared
// memory size (nothing launched).
template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, dim3 grid, int threads, size_t smem,
                  cudaStream_t stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // nothing launched: leave no error behind
    return static_cast<int>(err);
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int launch(const float* x0, const float* scal, const int* ints,
           const float* ptar, const float* vtar, const float* dist,
           const float* mean, const float* chol, const float* z,
           const uint64_t* seed, const int* offset, const uint64_t* disturb_seed,
           int krng, float* draw_out, float* costs,
           float* actions, int B, int N, int H, int check_rollover, int mode,
           int reward, int block, cudaStream_t stream) {
  // the tile kernel writes its tile in 16-byte stores
  if (B <= 0 || B > quad::kMaxScenarios || N <= 0 || H <= 0 ||
      (block != 32 && block != 64 && block != 128) || mode < quad::kShared ||
      mode > quad::kMixed || reward < quad::kPenyaw ||
      reward > quad::kRealworld || (krng && mode != quad::kShared) ||
      !aligned16(actions) || (z == nullptr && seed == nullptr) ||
      (krng && disturb_seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + block - 1) / block, B);
  const bool rw = reward == quad::kRealworld;
  auto run = [&](auto kernel, int threads, size_t floats) {
    return launch_kernel(kernel, grid, threads, sizeof(float) * floats, stream,
                         x0, scal, ints, ptar, vtar, dist, mean, chol, z, seed,
                         offset, disturb_seed, krng, draw_out, costs, actions, N, H,
                         check_rollover, mode);
  };
  // the tile kernel when the grid has no more blocks than the card has SMs
  if (static_cast<long long>(grid.x) * B > sms) {
    return run(rw ? sample_rollout_step_kernel<quad::kRealworld>
                  : sample_rollout_step_kernel<quad::kPenyaw>,
               block, step_smem_floats(H));
  }
  if (block == 32) {
    return run(rw ? sample_rollout_tile_kernel<32, quad::kRealworld>
                  : sample_rollout_tile_kernel<32, quad::kPenyaw>,
               kTileThreads, tile_smem_floats<32>(H));
  }
  if (block == 64) {
    return run(rw ? sample_rollout_tile_kernel<64, quad::kRealworld>
                  : sample_rollout_tile_kernel<64, quad::kPenyaw>,
               kTileThreads, tile_smem_floats<64>(H));
  }
  return run(rw ? sample_rollout_tile_kernel<128, quad::kRealworld>
                : sample_rollout_tile_kernel<128, quad::kPenyaw>,
             kTileThreads, tile_smem_floats<128>(H));
}

// The resources of a kernel's two reward instantiations at `threads`
// threads and `smem` bytes of dynamic shared memory a block, into out[0..7].
template <typename Kernel>
int resources(const Kernel (&kernels)[2], int threads, size_t smem, int* out) {
  out[0] = threads;
  out[1] = static_cast<int>(smem);
  for (int k = 0; k < 2; ++k) {
    cudaError_t err = cudaFuncSetAttribute(
        kernels[k], cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2 + 3 * k],
                                                        kernels[k], threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernels[k]);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[3 + 3 * k] = attr.numRegs;
    out[4 + 3 * k] = static_cast<int>(attr.localSizeBytes);
  }
  return 0;
}

template <int kS>
int info(int H, int tile, int* out) {
  if (tile) {
    const decltype(&sample_rollout_tile_kernel<kS, quad::kPenyaw>) kernels[] = {
        sample_rollout_tile_kernel<kS, quad::kPenyaw>,
        sample_rollout_tile_kernel<kS, quad::kRealworld>};
    return resources(kernels, kTileThreads, sizeof(float) * tile_smem_floats<kS>(H),
                     out);
  }
  const decltype(&sample_rollout_step_kernel<quad::kPenyaw>) kernels[] = {
      sample_rollout_step_kernel<quad::kPenyaw>,
      sample_rollout_step_kernel<quad::kRealworld>};
  return resources(kernels, kS, sizeof(float) * step_smem_floats(H), out);
}

}  // namespace

// K5: one scenario. Launch on `stream`; returns cudaGetLastError(), or an
// error with nothing launched for a block other than 32, 64 or 128 samples,
// an actions pointer not 16-byte aligned, or a tile larger than a block's
// shared memory, or a key missing. z may be null: the kernel then draws
// in-kernel, keyed by the device word `seed` points to (null when z is
// given); disturb_seed points to the krng draw's key (null without krng);
// draw_out may be null.
extern "C" int sample_rollout(
    const float* x0, const float* scal, const int* ints, const float* ptar,
    const float* vtar, const float* dist, const float* mean, const float* chol,
    const float* z, const uint64_t* seed, const uint64_t* disturb_seed,
    int krng, float* draw_out, float* costs, float* actions, int N, int H,
    int check_rollover, int mode, int reward, int block, cudaStream_t stream) {
  return launch(x0, scal, ints, ptar, vtar, dist, mean, chol, z, seed, nullptr,
                disturb_seed, krng, draw_out, costs, actions, 1, N, H,
                check_rollover, mode, reward, block, stream);
}

// K7, per-step: B scenarios, every table scenario-strided; mean (B, H, 4),
// chol (B, H, 4, 4), z (B, H, 4, N) or null, costs (B, N), actions
// (B, 4H, N). offset, when not null, points to the device word o of the
// episodes' offset: scenario b draws as slot o + b (what scenario o + b
// draws at offset 0), so one captured launch serves every chunk of a
// batched protocol.
extern "C" int sample_rollout_batched(
    const float* x0, const float* scal, const int* ints, const float* ptar,
    const float* vtar, const float* dist, const float* mean, const float* chol,
    const float* z, const uint64_t* seed, const int* offset, float* costs,
    float* actions, int B, int N, int H, int check_rollover, int mode,
    int reward, int block, cudaStream_t stream) {
  return launch(x0, scal, ints, ptar, vtar, dist, mean, chol, z, seed, offset,
                nullptr, 0, nullptr, costs, actions, B, N, H, check_rollover,
                mode, reward, block, stream);
}

// The launch geometry and resources of a block of `block` samples at
// horizon H in the tile kernel (tile != 0) or the step kernel, into
// out[0..7]: threads, dynamic shared memory (bytes), then for the penyaw and
// the realworld instantiation each: blocks an SM can hold, registers of a
// thread, local memory of a thread (bytes: a stack frame or spills).
extern "C" int sample_rollout_info(int block, int H, int tile, int* out) {
  if (H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (block == 32) return info<32>(H, tile, out);
  if (block == 64) return info<64>(H, tile, out);
  if (block == 128) return info<128>(H, tile, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
