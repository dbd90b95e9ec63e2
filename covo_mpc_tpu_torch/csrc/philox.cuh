// Counter-based normals for the sampling kernels (K1, K5, K7).
//
// Stands in for the TPU's hardware PRNG (pltpu.prng_random_bits and the
// Box-Muller helpers _normals4 / _normals_joint / _normals3_scalar in
// covo_mpc_tpu/ops/rollout_pallas.py). A draw is a pure function of a
// 64-bit key and a 128-bit counter, so a sample's normals do not depend on
// the block or grid a kernel is launched with.
#pragma once

#include <cstdint>

namespace rng {

// Philox4x32-10 (Salmon et al., SC'11): 10 rounds, key (k0, k1).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Box-Muller on two 32-bit words: u1 in (0, 1] keeps the log finite.
__device__ __forceinline__ float2 box_muller(uint32_t a, uint32_t b) {
  constexpr float kInv24 = 1.0f / 16777216.0f;
  const float u1 = (static_cast<float>(a >> 8) + 1.0f) * kInv24;
  const float u2 = static_cast<float>(b >> 8) * kInv24;
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincosf(6.283185307179586f * u2, &s, &c);
  return make_float2(r * c, r * s);
}

// Four standard normals from one Philox call on counter c, keyed by seed.
__device__ __forceinline__ float4 normals4(uint4 c, uint64_t seed) {
  const uint4 r = philox4x32_10(c, static_cast<uint32_t>(seed),
                                static_cast<uint32_t>(seed >> 32));
  const float2 p = box_muller(r.x, r.y);
  const float2 q = box_muller(r.z, r.w);
  return make_float4(p.x, p.y, q.x, q.y);
}

// The counter word of scenario b of a launch: b, plus the episode offset o
// that the device word `offset` holds when it is given. Scenario b at
// offset o then draws what scenario o + b draws at offset 0, so a chunk of
// episodes [o, o + B) of a batched protocol draws as they do in one launch
// from episode 0, and one captured launch serves every chunk (the word is
// read on the device at each launch).
__device__ __forceinline__ uint32_t scenario_slot(int b, const int* offset) {
  return static_cast<uint32_t>(b + (offset != nullptr ? *offset : 0));
}

}  // namespace rng
