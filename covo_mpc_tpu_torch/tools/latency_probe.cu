// Dependent-issue latencies of the SM's instruction classes, in cycles.
//
// One warp runs, for each class, a chain of kChain instructions in which
// each one reads the result of the one before, between two reads of the
// SM's cycle counter; the difference over kChain is that class's latency.
// covo_mpc_tpu_torch/tools/sass_chain.py weights the critical path of a
// kernel's step loop with these numbers. Built and launched by that tool
// (nvcc into its own shared library, ctypes); not a kernel of the port.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChain = 512;
constexpr int kRing = 64;  // pointer-chase ring: entries, one 128-byte line apart

__device__ __forceinline__ long long now() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

// out: ffma, imad, mufu.rsq, mufu.rcp, lds, shfl, ldg (L2 hit), in cycles,
// and the SM clock over the probe in MHz (cycles over %globaltimer's ns)
__global__ void latency_probe_kernel(float y, float z, int iy, int iz, int src,
                                     unsigned long long* ring, float* sink,
                                     double* out) {
  __shared__ unsigned chase[kRing];
  const int lane = threadIdx.x;
  if (lane == 0) {
    for (int i = 0; i < kRing; ++i) {
      chase[i] = static_cast<unsigned>(__cvta_generic_to_shared(&chase[(i + 1) % kRing]));
      ring[16 * i] = reinterpret_cast<unsigned long long>(&ring[16 * ((i + 1) % kRing)]);
    }
  }
  __threadfence();
  __syncwarp();
  float acc = 0.0f;
  long long t0, t1;
  unsigned long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0)::"memory");
  const long long c0 = now();

  float f = y + lane;
  t0 = now();
  asm volatile("" : "+f"(f) : "l"(t0));
#pragma unroll
  for (int i = 0; i < kChain; ++i) f = fmaf(f, y, z);
  asm volatile("" : "+f"(f));
  t1 = now();
  acc += f;
  if (lane == 0) out[0] = static_cast<double>(t1 - t0) / kChain;

  int n = iy + lane;
  t0 = now();
  asm volatile("" : "+r"(n) : "l"(t0));
#pragma unroll
  for (int i = 0; i < kChain; ++i) n = n * iy + iz;
  asm volatile("" : "+r"(n));
  t1 = now();
  acc += n;
  if (lane == 0) out[1] = static_cast<double>(t1 - t0) / kChain;

  f = 2.0f + y;
  t0 = now();
#pragma unroll
  for (int i = 0; i < kChain; ++i) asm volatile("rsqrt.approx.ftz.f32 %0, %0;" : "+f"(f));
  t1 = now();
  acc += f;
  if (lane == 0) out[2] = static_cast<double>(t1 - t0) / kChain;

  // rcp(rcp(x)) may fold: an FFMA between, its latency taken off
  f = 2.0f + y;
  t0 = now();
#pragma unroll
  for (int i = 0; i < kChain; ++i) {
    asm volatile("rcp.approx.ftz.f32 %0, %0;" : "+f"(f));
    f = fmaf(f, y, z);
  }
  asm volatile("" : "+f"(f));
  t1 = now();
  acc += f;
  if (lane == 0) out[3] = static_cast<double>(t1 - t0) / kChain - out[0];

  unsigned p = static_cast<unsigned>(__cvta_generic_to_shared(&chase[0]));
  __syncwarp();
  t0 = now();
#pragma unroll
  for (int i = 0; i < kChain; ++i) asm volatile("ld.shared.u32 %0, [%0];" : "+r"(p));
  t1 = now();
  acc += p;
  if (lane == 0) out[4] = static_cast<double>(t1 - t0) / kChain;

  // a rotation, so the value stays different in every lane and no two
  // shuffles fold into one
  unsigned u = __float_as_uint(y) + lane;
  t0 = now();
#pragma unroll
  for (int i = 0; i < kChain; ++i) {
    asm volatile("shfl.sync.idx.b32 %0, %0, %1, 0x1f, 0xffffffff;"
                 : "+r"(u) : "r"((lane + src + i) & 31));
  }
  t1 = now();
  acc += __uint_as_float(u);
  if (lane == 0) out[5] = static_cast<double>(t1 - t0) / kChain;

  unsigned long long q = reinterpret_cast<unsigned long long>(ring);
  for (int i = 0; i < kRing; ++i) {  // one pass to bring the ring into L2
    asm volatile("ld.global.cg.u64 %0, [%0];" : "+l"(q));
  }
  t0 = now();
#pragma unroll 16
  for (int i = 0; i < kChain; ++i) asm volatile("ld.global.cg.u64 %0, [%0];" : "+l"(q));
  t1 = now();
  acc += static_cast<float>(q & 1);
  if (lane == 0) out[6] = static_cast<double>(t1 - t0) / kChain;

  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1)::"memory");
  const long long c1 = now();
  if (lane == 0) out[7] = 1e3 * static_cast<double>(c1 - c0) / static_cast<double>(g1 - g0);
  sink[lane] = acc;
}

__global__ void empty_kernel() {}

}  // namespace

// Launch an empty one-warp kernel on `stream`: the launch floor.
extern "C" int empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}

// Launch one warp on `stream`; out (8 doubles) as latency_probe_kernel's.
// ring is 16 * 64 u64 of scratch, sink 32 floats.
extern "C" int latency_probe(unsigned long long* ring, float* sink, double* out,
                             cudaStream_t stream) {
  latency_probe_kernel<<<1, 32, 0, stream>>>(1.0000001f, 1e-7f, 3, 1, 5, ring, sink, out);
  return static_cast<int>(cudaGetLastError());
}
