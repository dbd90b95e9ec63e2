// Sensitivity chain: the Hessian's forward first-order sensitivities.
//
// Replaces covo_mpc_tpu/ops/hessian_pallas.py::make_tail_pullback
// (_chain_kernel): T_h = [S1_h; E_h] and S1_{h+1} = J_h T_h, for h < H, with
// J_h the (sd, sd + 4) step Jacobian and E_h the h-th (4, D) identity block.
// Writes T (H, sd + 4, D). The pullback sum_h T_h^T M_h T_h stays outside,
// in two fp32 einsums, as it did in JAX.
//
// What bounds it on an H100: the H dependent steps of the chain on the SM
// that runs the first columns. The work (221 FMAs a column a step at
// sd = 13, ~0.9 MFLOP at H = 32, D = 128) and the 278 KB of T come nowhere
// near the card's rates. One warp issues a step's instructions one after
// another, each after the stall the compiler set for it, so a step costs
// about the sum of those stalls over the instructions one thread runs in it
// (`tools/primal_chain_variants.py` reads both from the SASS); the latency
// of one row's 17 dependent FMAs is the floor under that.
//
// What the design does about it:
// - Columns of T are independent; only the steps are sequential. A block is
//   one warp of two columns, 16 lanes a column and one row of S1 a lane, so
//   a thread runs 17 FMAs a step and ceil(D / 2) blocks spread over the SMs.
//   Each lane puts its row of S1 in shared memory and reads the column's
//   whole S1 back as four 16-byte loads.
// - Column x of T is zero in its S1 rows up to step x / 4, and its E rows
//   are zero before that step. So a block starts its chain at its columns'
//   step, with S1 = 0 there, and writes the zero prefix of T as plain stores.
// - J_h is staged in shared memory with each row padded to 20 floats, so a
//   lane reads its row as five 16-byte vector loads in place of 17 scalar
//   ones. The copies go out by cp.async kAhead steps ahead of the chain,
//   one commit group a step in a ring of kRing slots, so the chain starts
//   once its first J_h is in.
// - Each S1[k] keeps the fmaf over u = 0..sd+3 in that order, as the
//   one-block kernel before it did, so T is the same bit for bit for finite
//   J. The chain runs in true fp32 (the Pallas kernel ran it at the TPU's
//   default bf16 matmul precision). sd is a template parameter; the C entry
//   point takes it at run time (13 for the core state, 16 for the drag/mixed
//   state).
#include <cuda_runtime.h>

namespace {

constexpr int kDA = 4;
constexpr int kRowLanes = 16;  // lanes a column, one row of S1 each (sd <= 16)
constexpr int kCols = 32 / kRowLanes;  // columns of T a block (one warp)
constexpr int kRing = 8;  // slots of staged J: step s in slot s % kRing
constexpr int kAhead = 2;  // steps of J in flight ahead of the chain
static_assert(kAhead < kRing && (kRing & (kRing - 1)) == 0, "a power-of-two ring");

template <int SD>
struct Geometry {
  static_assert(SD <= kRowLanes, "one row of S1 a lane");
  static constexpr int Z = SD + kDA;
  static constexpr int ZP = (Z + 3) / 4 * 4;  // a staged row: whole float4s
  static constexpr int kSlot = kRowLanes * ZP;  // floats of one staged J_h
  static constexpr int kCopies = (SD * Z + 31) / 32;  // J_h's floats a lane copies
};

// One float from global memory to the shared-memory address dst.
__device__ __forceinline__ void copy_async(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// This lane's share of J_s (flat index lane + 32 i, landing at float
// off[i] of the slot; -1 past the end) into slot s % kRing of the ring at
// shared address J_base, by cp.async, as one commit group. Past the last
// mat-vec (step H - 2) it copies that step's J again, into a slot no step
// reads, so the copies need no branch.
template <int SD>
__device__ __forceinline__ void stage(unsigned J_base, const float* J, int s, int H, int lane,
                                      const int (&off)[Geometry<SD>::kCopies]) {
  using G = Geometry<SD>;
  const unsigned slot = J_base + 4u * static_cast<unsigned>((s & (kRing - 1)) * G::kSlot);
  const float* src = J + static_cast<size_t>(min(s, max(H - 2, 0))) * SD * G::Z + lane;
#pragma unroll
  for (int i = 0; i < G::kCopies; ++i) {
    if (off[i] >= 0) copy_async(slot + 4u * off[i], src + 32 * i);
  }
  commit_group();
}

// N floats from 16-byte aligned shared memory into registers, as float4 loads.
template <int N>
__device__ __forceinline__ void load_vec(float (&dst)[N], const float* src) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(src)[q];
    dst[4 * q] = v.x;
    dst[4 * q + 1] = v.y;
    dst[4 * q + 2] = v.z;
    dst[4 * q + 3] = v.w;
  }
}

template <int SD>
__global__ void __launch_bounds__(32) sens_chain_kernel(const float* __restrict__ J,
                                                        float* __restrict__ T, int H) {
  using G = Geometry<SD>;
  constexpr int Z = G::Z;
  constexpr int ZP = G::ZP;
  __shared__ __align__(16) float J_s[kRing * G::kSlot];
  __shared__ __align__(16) float S_s[2][kCols][kRowLanes];  // S1 by step parity
  const unsigned J_base = static_cast<unsigned>(__cvta_generic_to_shared(J_s));
  const int D = kDA * H;  // even: the blocks cover the columns exactly
  const int lane = threadIdx.x;
  const int r = lane % kRowLanes;  // this lane's row of S1 (and of T_h)
  const int col = lane / kRowLanes;
  const int c0 = blockIdx.x * kCols;  // the block's first column
  const int x = c0 + col;  // this lane's column
  // the block's columns are zero in T_h for h < h0, and S1_h0 is zero
  const int h0 = c0 / kDA;

  // where this lane's share of J_h (flat index lane + 32 i) lands in a slot
  int off[G::kCopies];
#pragma unroll
  for (int i = 0; i < G::kCopies; ++i) {
    const int e = lane + 32 * i;
    off[i] = e < SD * Z ? (e / Z) * ZP + e % Z : -1;
  }
#pragma unroll
  for (int j = 0; j < kAhead; ++j) stage<SD>(J_base, J, h0 + j, H, lane, off);

  // the zero prefix: rows (h, u) with h < h0 at the block's columns
  for (int i = lane; i < h0 * Z * kCols; i += 32) {
    T[static_cast<size_t>(i / kCols) * D + c0 + i % kCols] = 0.0f;
  }

  float S1[SD];  // the column's S1_h, in every lane of the column
#pragma unroll
  for (int k = 0; k < SD; ++k) S1[k] = 0.0f;
  float own = 0.0f;  // S1_h[r]
  // T_h at column x: row r by this lane, and row kRowLanes + r where T has one
  float* Th = T + (static_cast<size_t>(h0) * Z + r) * D + x;
  const bool second = kRowLanes + r < Z;
  const auto store_T = [&](int h) {
    Th[0] = r < SD ? own : (x == kDA * h + r - SD ? 1.0f : 0.0f);
    if (second) Th[kRowLanes * D] = x == kDA * h + kRowLanes + r - SD ? 1.0f : 0.0f;
    Th += static_cast<size_t>(Z) * D;
  };
#pragma unroll 1
  for (int h = h0; h + 1 < H; ++h) {
    store_T(h);
    float t[Z];
#pragma unroll
    for (int k = 0; k < SD; ++k) t[k] = S1[k];
#pragma unroll
    for (int j = 0; j < kDA; ++j) t[SD + j] = (x == kDA * h + j) ? 1.0f : 0.0f;
    // the slot J_{h + kAhead} takes was last read kRing - kAhead steps ago
    stage<SD>(J_base, J, h + kAhead, H, lane, off);
    wait_groups<kAhead>();  // J_h is in
    __syncwarp();
    float row[ZP];
    load_vec<ZP>(row, J_s + (h & (kRing - 1)) * G::kSlot + r * ZP);
    float acc = 0.0f;
#pragma unroll
    for (int u = 0; u < Z; ++u) acc = fmaf(row[u], t[u], acc);
    // the column's S1_{h+1}: every lane's row through shared memory (rows
    // past sd come from the slot's padding and are never read)
    own = acc;
    S_s[h & 1][col][r] = acc;
    __syncwarp();
    float next[kRowLanes];
    load_vec<kRowLanes>(next, S_s[h & 1][col]);
#pragma unroll
    for (int k = 0; k < SD; ++k) S1[k] = next[k];
  }
  store_T(H - 1);
  asm volatile("cp.async.wait_all;\n" ::);  // no copy outlives the block
}

template <int SD>
cudaError_t launch(const float* J, float* T, int H, cudaStream_t stream) {
  const int blocks = (kDA * H + kCols - 1) / kCols;
  sens_chain_kernel<SD><<<blocks, 32, 0, stream>>>(J, T, H);
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
