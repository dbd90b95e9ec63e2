// Component-form quadrotor physics and rewards, shared by the CUDA kernels.
//
// Counterpart of covo_mpc_tpu/models/scalar_core.py (bodyrate_step,
// penyaw_reward, realworld_reward), of the action -> (thrust, omega_tar) map
// of covo_mpc_tpu/ops/rollout_pallas.py::_dyn_step, and of the per-step body
// of its _rollout_kernel (rollout_step below). The array-form twins
// in covo_mpc_tpu_torch/models/{dynamics,rewards}.py are the plain versions
// these are checked against. Reference semantics: quadjax
// dynamics/free.py:75-112 (ODE) and dynamics/utils.py:267-313 (rewards).
//
// Unlike the Pallas kernels, which carried a polynomial atan2 because Mosaic
// has no atan2 lowering, the yaw here uses atan2f.
#pragma once

#include <cstdint>

namespace quad {

// indices of the scalar pack (ops/rollout_cuda.py::_pack_kernel_inputs)
enum Scal {
  kM = 0, kG, kDt, kAlpha, kAScale, kMaxThrust, kMo0, kMo1, kMo2, kDiscount,
  kDScale, kDp0, kDp1, kDp2, kDraw0, kDraw1, kDraw2, kNScal
};
// indices of the int pack: [t0, max_steps, disturb_period]
enum Ints { kT0 = 0, kMaxSteps, kPeriod, kNInt };

// the 13-component dynamic core state (pos, quat (x, y, z, w), vel, omega)
struct State {
  float px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz;
};

__device__ __forceinline__ State load_state(const float* x) {
  return State{x[0], x[1], x[2], x[3], x[4], x[5], x[6],
               x[7], x[8], x[9], x[10], x[11], x[12]};
}

__device__ __forceinline__ void quat_normalize(float& qx, float& qy,
                                               float& qz, float& qw) {
  const float n = sqrtf(qx * qx + qy * qy + qz * qz + qw * qw);
  qx = qx / n; qy = qy / n; qz = qz / n; qw = qw / n;
}

// One Euler step of the first-order bodyrate ODE. thrust and omega_tar are
// physical controls with action_scale applied. Position integrates the
// PRE-update velocity.
__device__ __forceinline__ void bodyrate_step(
    State& s, float thrust, float wtx, float wty, float wtz,
    float fdx, float fdy, float fdz, float m, float g, float dt, float alpha) {
  float qx = s.qx, qy = s.qy, qz = s.qz, qw = s.qw;
  quat_normalize(qx, qy, qz, qw);
  // body z-axis in world frame (third column of R(q))
  const float bzx = 2.0f * (qx * qz + qw * qy);
  const float bzy = 2.0f * (qy * qz - qw * qx);
  const float bzz = qw * qw - qx * qx - qy * qy + qz * qz;

  s.px = s.px + s.vx * dt;
  s.py = s.py + s.vy * dt;
  s.pz = s.pz + s.vz * dt;
  s.vx = s.vx + (bzx * thrust + fdx) / m * dt;
  s.vy = s.vy + (bzy * thrust + fdy) / m * dt;
  s.vz = s.vz + (-g + (bzz * thrust + fdz) / m) * dt;

  const float wx = s.wx, wy = s.wy, wz = s.wz;
  const float qdx = 0.5f * (qw * wx + (qy * wz - qz * wy));
  const float qdy = 0.5f * (qw * wy + (qz * wx - qx * wz));
  const float qdz = 0.5f * (qw * wz + (qx * wy - qy * wx));
  const float qdw = 0.5f * (-(qx * wx + qy * wy + qz * wz));
  qx = qx + dt * qdx;
  qy = qy + dt * qdy;
  qz = qz + dt * qdz;
  qw = qw + dt * qdw;
  quat_normalize(qx, qy, qz, qw);
  s.qx = qx; s.qy = qy; s.qz = qz; s.qw = qw;

  s.wx = alpha * wx + (1.0f - alpha) * wtx;
  s.wy = alpha * wy + (1.0f - alpha) * wty;
  s.wz = alpha * wz + (1.0f - alpha) * wtz;
}

__device__ __forceinline__ float clip1(float a) {
  return fminf(fmaxf(a, -1.0f), 1.0f);
}

// Normalized action in [-1, 1]^4 (clipped here, as step_env does) ->
// thrust and omega_tar, then one bodyrate step. scal is the scalar pack.
__device__ __forceinline__ void dyn_step(State& s, const float a[4],
                                         float fdx, float fdy, float fdz,
                                         const float* scal) {
  const float ascale = scal[kAScale];
  const float thrust = (clip1(a[0]) + 1.0f) * 0.5f * scal[kMaxThrust] * ascale;
  const float wtx = clip1(a[1]) * scal[kMo0] * ascale;
  const float wty = clip1(a[2]) * scal[kMo1] * ascale;
  const float wtz = clip1(a[3]) * scal[kMo2] * ascale;
  bodyrate_step(s, thrust, wtx, wty, wtz, fdx, fdy, fdz, scal[kM], scal[kG],
                scal[kDt], scal[kAlpha]);
}

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

// Multi-scale log barrier on the position error.
__device__ __forceinline__ float log_pos_penalty(float e) {
  const float l = logf(e + 1.0f);
  return e * 0.4f + clip01(l * 4.0f) * 0.4f + clip01(l * 8.0f) * 0.2f +
         clip01(l * 16.0f) * 0.1f + clip01(l * 32.0f) * 0.1f;
}

// The MPPI / CoVO cost model:
// 1.3 - 0.05 |v_err| - log_pos(|p_err|) - 0.2 |yaw|.
__device__ __forceinline__ float penyaw_reward(const State& s, float ptx,
                                               float pty, float ptz, float vtx,
                                               float vty, float vtz) {
  const float ex = ptx - s.px, ey = pty - s.py, ez = ptz - s.pz;
  const float evx = vtx - s.vx, evy = vty - s.vy, evz = vtz - s.vz;
  const float err_pos = sqrtf(ex * ex + ey * ey + ez * ez);
  const float err_vel = sqrtf(evx * evx + evy * evy + evz * evz);
  const float yaw = atan2f(2.0f * (s.qw * s.qz + s.qx * s.qy),
                           1.0f - 2.0f * (s.qy * s.qy + s.qz * s.qz));
  return 1.3f - 0.05f * err_vel - log_pos_penalty(err_pos) - fabsf(yaw) * 0.2f;
}

// The quadratic real-world cost of tracking_slow:
// -(5 mean(p_err^2) + 3 (1 - q_w^2)) 0.02, in scalar_core.realworld_reward's
// order. It reads no velocity target.
__device__ __forceinline__ float realworld_reward(const State& s, float ptx,
                                                  float pty, float ptz) {
  const float ex = ptx - s.px, ey = pty - s.py, ez = ptz - s.pz;
  const float pos_err = (ex * ex + ey * ey + ez * ez) / 3.0f;
  const float quat_err = 1.0f - s.qw * s.qw;
  return -(5.0f * pos_err + 3.0f * quat_err) * 0.02f;
}

// The reward of a rollout launch (ops/rollout_cuda.py::REWARDS; JAX's
// reward_name), a launch argument uniform across the grid as the mode is.
// Each kernel is instantiated once per reward and the launch picks one: a
// runtime branch on the reward inside the step changed how ptxas contracted
// penyaw's arithmetic, and so the penyaw costs in their last bits and every
// closed loop's digits; the penyaw instantiation compiles as the step did
// before the realworld branch existed.
enum Reward { kPenyaw = 0, kRealworld = 1 };

template <int kReward>
__device__ __forceinline__ float step_reward(const State& s, const float* pt,
                                             const float* vt) {
  if constexpr (kReward == kRealworld) {
    return realworld_reward(s, pt[0], pt[1], pt[2]);
  } else {
    return penyaw_reward(s, pt[0], pt[1], pt[2], vt[0], vt[1], vt[2]);
  }
}

// One scenario's rollout operands: x0 (16), the scalar and int packs, the
// (3H) position and velocity targets and the (3H) disturbance table.
struct Tables {
  const float* x0;
  const float* scal;
  const int* ints;
  const float* ptar;
  const float* vtar;
  const float* dist;
};

// Scenario b of a launch's scenario-strided tables: x0 (B, 16), scal
// (B, kNScal), ints (B, kNInt), ptar, vtar and dist (B, 3H). The batched
// launches (K6, K7) run scenario blockIdx.y; a single-scenario launch (K1,
// K4, K5) is the grid's only scenario, b = 0.
__device__ __forceinline__ Tables scenario_tables(int b, int H,
                                                  const float* x0,
                                                  const float* scal,
                                                  const int* ints,
                                                  const float* ptar,
                                                  const float* vtar,
                                                  const float* dist) {
  return Tables{x0 + 16 * b, scal + kNScal * b, ints + kNInt * b,
                ptar + 3 * H * b, vtar + 3 * H * b, dist + 3 * H * b};
}

// Largest scenario count of one launch (the grid's y dimension).
constexpr int kMaxScenarios = 65535;

// The disturbance modes (ops/rollout_cuda.py::MODES; JAX's _disturb_mode),
// a launch argument uniform across the grid:
// - kShared (gaussian / none): step 0 integrates with x0's own force, every
//   later step with the one shared force, the scalar pack's draw lanes;
// - kTable (sin / periodic): step h integrates with dist[3h .. 3h + 2];
// - kDrag, kMixed: the force rides each sample's carry from x0[13:16]; each
//   step integrates with it and replaces it with the model's output from
//   the PRE-step velocity: drag -|scale| v_rel |v_rel| / 1.5^2 with v_rel =
//   v - disturb_params[:3] / 2; mixed (drag + dist[3h..] (the sin value) +
//   periodic) / 3, the periodic term the draw lanes when (t0 + h) is a
//   multiple of disturb_period, else the carried force.
enum Mode { kShared = 0, kTable = 1, kDrag = 2, kMixed = 3 };

// What every sample of one rollout launch shares.
struct RolloutShared {
  const float* scal;  // the scalar pack (Scal)
  const float* ptar;  // (H * 3,) position targets
  const float* vtar;  // (H * 3,) velocity targets
  const float* dist;  // (H * 3,) force table (kTable) or sin values (kMixed)
  float f0x, f0y, f0z;
  // the draw lanes: the shared force (kShared) or the periodic draw (kMixed)
  float fx, fy, fz;
  float discount;
  float abs_ds, windx, windy, windz;  // |disturb_scale|, disturb_params[:3]
  int t0, max_steps, period, mode;
  bool check_rollover;
};

// The draw lanes come from scal[kDraw0..2]; a kernel that draws the shared
// force itself ("krng") overwrites fx, fy, fz.
__device__ __forceinline__ RolloutShared load_shared(const Tables& t,
                                                     int check_rollover,
                                                     int mode) {
  return RolloutShared{t.scal, t.ptar, t.vtar, t.dist,
                       t.x0[13], t.x0[14], t.x0[15],
                       t.scal[kDraw0], t.scal[kDraw1], t.scal[kDraw2],
                       t.scal[kDiscount], fabsf(t.scal[kDScale]),
                       t.scal[kDp0], t.scal[kDp1], t.scal[kDp2],
                       t.ints[kT0], t.ints[kMaxSteps], t.ints[kPeriod], mode,
                       check_rollover != 0};
}

// One sample's rollout carry: state, cost so far, the reward frozen at
// termination, the discount of the next step, whether it terminated, and
// the force of the next step (kDrag, kMixed).
struct Carry {
  State s;
  float cost, r_prev, disc;
  bool d_prev;
  float fx, fy, fz;
};

__device__ __forceinline__ Carry start(const float* x0) {
  return Carry{load_state(x0), 0.0f, 0.0f, 1.0f, false, x0[13], x0[14], x0[15]};
}

// Step h of one sample under the action a (clipped inside dyn_step): the
// reward (penyaw or realworld, kReward) on the PRE-step state, frozen once
// the sample terminated (the freeze reads d_prev), the discounted cost,
// termination (|pos| > 3, the time limit, the rollover check when on), the
// force of the step (and, under kDrag / kMixed, the next one's from the
// pre-step velocity), then the bodyrate step. The single step body of K1 and
// K4-K7.
template <int kReward>
__device__ __forceinline__ void rollout_step(Carry& c, const RolloutShared& sh,
                                             int h, const float a[4]) {
  const float* pt = sh.ptar + 3 * h;
  const float* vt = sh.vtar + 3 * h;
  float r = step_reward<kReward>(c.s, pt, vt);
  r = c.d_prev ? c.r_prev : r;
  c.r_prev = r;
  c.cost = c.cost - c.disc * r;
  c.disc = c.disc * sh.discount;

  const State& s = c.s;
  bool d_now = fabsf(s.px) > 3.0f || fabsf(s.py) > 3.0f || fabsf(s.pz) > 3.0f;
  if (sh.check_rollover) {
    d_now = d_now || s.qw < 0.70710678f || fabsf(s.wx) > 100.0f ||
            fabsf(s.wy) > 100.0f || fabsf(s.wz) > 100.0f;
  }
  c.d_prev = c.d_prev || d_now || (sh.t0 + h) >= sh.max_steps;

  const float* dh = sh.dist + 3 * h;
  float fdx, fdy, fdz;
  if (sh.mode == kShared) {
    fdx = h == 0 ? sh.f0x : sh.fx;
    fdy = h == 0 ? sh.f0y : sh.fy;
    fdz = h == 0 ? sh.f0z : sh.fz;
  } else if (sh.mode == kTable) {
    fdx = dh[0];
    fdy = dh[1];
    fdz = dh[2];
  } else {
    fdx = c.fx;
    fdy = c.fy;
    fdz = c.fz;
    const float relx = s.vx - sh.windx * 0.5f;
    const float rely = s.vy - sh.windy * 0.5f;
    const float relz = s.vz - sh.windz * 0.5f;
    float nx = -sh.abs_ds * relx * fabsf(relx) / 2.25f;
    float ny = -sh.abs_ds * rely * fabsf(rely) / 2.25f;
    float nz = -sh.abs_ds * relz * fabsf(relz) / 2.25f;
    if (sh.mode == kMixed) {
      const bool redraw = (sh.t0 + h) % sh.period == 0;
      nx = (nx + dh[0] + (redraw ? sh.fx : fdx)) / 3.0f;
      ny = (ny + dh[1] + (redraw ? sh.fy : fdy)) / 3.0f;
      nz = (nz + dh[2] + (redraw ? sh.fz : fdz)) / 3.0f;
    }
    c.fx = nx;
    c.fy = ny;
    c.fz = nz;
  }
  dyn_step(c.s, a, fdx, fdy, fdz, sh.scal);
}

}  // namespace quad
