// flightcore — native flight-stack core (dodgelib/flightlib equivalent).
//
// The reference keeps its flight stack in C++ (dodgedrone_simulation/
// dodgelib: Pilot, VelocityReference, geometric controller;
// flightmare/flightlib/src/dynamics/quadrotor_dynamics.cpp: rigid-body +
// motor model, RK4) because the control loop runs host-side in real time on
// the vehicle.  The rebuild keeps the same split: the accelerator computes
// perception/policy, and this library is the host-native real-time half —
// velocity reference integration with timeout-to-zero
// (dodgelib/src/reference/velocity_reference.cpp:16-67), SE(3) geometric
// controller with tilt-prioritized attitude control
// (dodgelib/src/controller/geometric/controller_geo.cpp:21-132), motor
// allocation + first-order motor lag + RK4 rigid body
// (flightmare/flightlib/src/dynamics/quadrotor_dynamics.cpp:5-93,
// include/flightlib/common/integrator_rk4.hpp).
//
// The math intentionally matches evfly_tpu/sim/rigid_body.py operation for
// operation (same agilicious constants, same clipping, same integrator) so
// the sim-side numpy stack and this deployment-side native stack are
// mutually verifiable: tests/test_flightcore.py drives both through
// identical command sequences and asserts trajectory agreement at double
// precision.
//
// C ABI only (consumed via ctypes from evfly_tpu_torch/sim/native_quad.py);
// compile with -DFLIGHTCORE_TEST for a standalone self-test binary.  A copy
// of evfly_tpu/native/flightcore.cpp, built by
// evfly_tpu_torch/native/_build.py.

#include <cmath>
#include <cstring>

namespace {

constexpr double kG = 9.8066;

struct Vec3 {
  double x, y, z;
};

inline Vec3 operator+(Vec3 a, Vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline Vec3 operator-(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 operator*(double s, Vec3 a) { return {s * a.x, s * a.y, s * a.z}; }
inline Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline double norm(Vec3 a) { return std::sqrt(a.x * a.x + a.y * a.y + a.z * a.z); }
inline Vec3 clip3(Vec3 v, Vec3 lim) {
  auto c = [](double x, double l) { return x < -l ? -l : (x > l ? l : x); };
  return {c(v.x, lim.x), c(v.y, lim.y), c(v.z, lim.z)};
}

struct Quat {  // wxyz, matching flightlib QuadState
  double w, x, y, z;
};

inline Quat quat_mul(Quat a, Quat b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

inline Vec3 quat_rotate(Quat q, Vec3 v) {
  // v + 2 u x (u x v + w v), u = (x,y,z) — matches rigid_body.quat_rotate
  Vec3 u{q.x, q.y, q.z};
  Vec3 t = cross(u, cross(u, v) + q.w * v);
  return v + 2.0 * t;
}

inline Quat quat_inv(Quat q) { return {q.w, -q.x, -q.y, -q.z}; }

inline Quat normalize(Quat q) {
  double n = std::sqrt(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z);
  return {q.w / n, q.x / n, q.y / n, q.z / n};
}

// Agilicious constants (flightpy config.yaml:41, quadrotor_dynamics.cpp:5-52)
struct Params {
  double mass = 0.752;
  Vec3 J{0.0025, 0.0021, 0.0043};  // diagonal inertia
  double kappa = 0.016;
  // motor arms: t_BM columns per motor (x row, y row)
  double t_BM_x[4] = {0.075, -0.075, -0.075, 0.075};
  double t_BM_y[4] = {-0.10, 0.10, -0.10, 0.10};
  double motor_tau = 0.033;
  double motor_omega_max = 2000.0;
  double thrust_map_t1 = 1.562522e-6;
  Vec3 omega_max{6.0, 6.0, 2.0};

  double thrust_max() const { return thrust_map_t1 * motor_omega_max * motor_omega_max; }
};

// Shipped sim gains (dodgelib/params/geo.yaml)
struct Gains {
  Vec3 kp_acc{1.0, 1.2, 2.0};
  Vec3 kd_acc{3.0, 3.0, 5.0};
  double kp_att_xy = 10.0;
  double kp_att_z = 2.0;
  Vec3 kp_rate{20.0, 20.0, 2.0};
  Vec3 p_err_max{0.6, 0.6, 0.5};
  Vec3 v_err_max{0.5, 5.0, 5.0};
};

// allocation matrix B: motor thrusts -> [f_total, tau_xyz]
// (quadrotor_dynamics.cpp:43-46); rows: ones, t_BM_y, -t_BM_x, kappa*(-1,-1,1,1)
struct Allocation {
  double B[4][4];
  double Binv[4][4];

  explicit Allocation(const Params& p) {
    const double ks[4] = {-1.0, -1.0, 1.0, 1.0};
    for (int j = 0; j < 4; ++j) {
      B[0][j] = 1.0;
      B[1][j] = p.t_BM_y[j];
      B[2][j] = -p.t_BM_x[j];
      B[3][j] = p.kappa * ks[j];
    }
    // Gauss-Jordan inverse of the 4x4 (well-conditioned by construction)
    double a[4][8];
    for (int i = 0; i < 4; ++i) {
      for (int j = 0; j < 4; ++j) {
        a[i][j] = B[i][j];
        a[i][4 + j] = (i == j) ? 1.0 : 0.0;
      }
    }
    for (int col = 0; col < 4; ++col) {
      int piv = col;
      for (int r = col + 1; r < 4; ++r)
        if (std::fabs(a[r][col]) > std::fabs(a[piv][col])) piv = r;
      for (int j = 0; j < 8; ++j) {
        double tmp = a[col][j];
        a[col][j] = a[piv][j];
        a[piv][j] = tmp;
      }
      double d = a[col][col];
      for (int j = 0; j < 8; ++j) a[col][j] /= d;
      for (int r = 0; r < 4; ++r) {
        if (r == col) continue;
        double f = a[r][col];
        for (int j = 0; j < 8; ++j) a[r][j] -= f * a[col][j];
      }
    }
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) Binv[i][j] = a[i][4 + j];
  }
};

struct RigidState {
  Vec3 p, v, w;
  Quat q;
};

// state derivative (quadrotor_dynamics.cpp:62-87); thrusts held constant
RigidState dstate(const RigidState& s, const double th[4], const Params& prm,
                  const Allocation& alloc) {
  double wrench[4] = {0, 0, 0, 0};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) wrench[i] += alloc.B[i][j] * th[j];
  const double f_total = wrench[0];
  const Vec3 tau{wrench[1], wrench[2], wrench[3]};

  RigidState d;
  d.p = s.v;
  Vec3 acc_body{0.0, 0.0, f_total / prm.mass};
  d.v = quat_rotate(s.q, acc_body) + Vec3{0.0, 0.0, -kG};
  Quat wq{0.0, s.w.x, s.w.y, s.w.z};
  Quat dq = quat_mul(s.q, wq);
  d.q = {0.5 * dq.w, 0.5 * dq.x, 0.5 * dq.y, 0.5 * dq.z};
  Vec3 Jw{prm.J.x * s.w.x, prm.J.y * s.w.y, prm.J.z * s.w.z};
  Vec3 gyro = cross(s.w, Jw);
  d.w = {(tau.x - gyro.x) / prm.J.x, (tau.y - gyro.y) / prm.J.y,
         (tau.z - gyro.z) / prm.J.z};
  return d;
}

inline RigidState axpy(const RigidState& s, double a, const RigidState& d) {
  RigidState r;
  r.p = s.p + a * d.p;
  r.v = s.v + a * d.v;
  r.w = s.w + a * d.w;
  r.q = {s.q.w + a * d.q.w, s.q.x + a * d.q.x, s.q.y + a * d.q.y, s.q.z + a * d.q.z};
  return r;
}

RigidState rk4_step(const RigidState& s0, const double th[4], double dt,
                    const Params& prm, const Allocation& alloc) {
  RigidState k1 = dstate(s0, th, prm, alloc);
  RigidState k2 = dstate(axpy(s0, 0.5 * dt, k1), th, prm, alloc);
  RigidState k3 = dstate(axpy(s0, 0.5 * dt, k2), th, prm, alloc);
  RigidState k4 = dstate(axpy(s0, dt, k3), th, prm, alloc);
  RigidState out = s0;
  out = axpy(out, dt / 6.0, k1);
  out = axpy(out, dt / 3.0, k2);
  out = axpy(out, dt / 3.0, k3);
  out = axpy(out, dt / 6.0, k4);
  out.q = normalize(out.q);
  return out;
}

Quat rotmat_to_quat(const double R[3][3]) {
  // branch structure matches rigid_body.rotmat_to_quat (numpy reference)
  double t = R[0][0] + R[1][1] + R[2][2];
  Quat q;
  if (t > 0) {
    double s = 0.5 / std::sqrt(t + 1.0);
    q = {0.25 / s, (R[2][1] - R[1][2]) * s, (R[0][2] - R[2][0]) * s,
         (R[1][0] - R[0][1]) * s};
  } else {
    int i = 0;
    if (R[1][1] > R[i][i]) i = 1;
    if (R[2][2] > R[i][i]) i = 2;
    int j = (i + 1) % 3, k = (i + 2) % 3;
    double d = 1.0 + R[i][i] - R[j][j] - R[k][k];
    double s = 2.0 * std::sqrt(d > 1e-12 ? d : 1e-12);
    double qv[4] = {0, 0, 0, 0};
    qv[0] = (R[k][j] - R[j][k]) / s;
    qv[1 + i] = 0.25 * s;
    qv[1 + j] = (R[j][i] + R[i][j]) / s;
    qv[1 + k] = (R[k][i] + R[i][k]) / s;
    if (qv[0] < 0)
      for (double& e : qv) e = -e;
    q = {qv[0], qv[1], qv[2], qv[3]};
    q = normalize(q);
  }
  return q;
}

// tilt-prioritized attitude control, Fohn 2020 (controller_geo.cpp:115-131)
Vec3 tilt_prioritized_control(Quat q, Quat q_des, double kp_xy, double kp_z) {
  Quat qe = quat_mul(quat_inv(q), q_des);
  Vec3 tmp{qe.w * qe.x - qe.y * qe.z, qe.w * qe.y + qe.x * qe.z,
           qe.w > 0 ? qe.z : -qe.z};
  double denom = qe.w * qe.w + qe.z * qe.z;
  if (denom < 1e-9) denom = 1e-9;
  double f = 2.0 / std::sqrt(denom);
  return {f * kp_xy * tmp.x, f * kp_xy * tmp.y, f * kp_z * tmp.z};
}

struct GeoOut {
  double thrust_cmd;
  Vec3 torque;
};

// one controller evaluation (controller_geo.cpp:21-113, exact sim state)
GeoOut geo_command(const RigidState& s, Vec3 p_ref, Vec3 v_ref,
                   const Params& prm, const Gains& g) {
  Vec3 pos_err = clip3(p_ref - s.p, g.p_err_max);
  Vec3 vel_err = clip3(v_ref - s.v, g.v_err_max);
  Vec3 acc_cmd{g.kp_acc.x * pos_err.x + g.kd_acc.x * vel_err.x,
               g.kp_acc.y * pos_err.y + g.kd_acc.y * vel_err.y,
               g.kp_acc.z * pos_err.z + g.kd_acc.z * vel_err.z + kG};
  double thrust_cmd = norm(acc_cmd) * prm.mass;

  // attitude command: z_B along acc_cmd, yaw 0 (controller_geo.cpp:70-84)
  double an = norm(acc_cmd);
  if (an < 1e-9) an = 1e-9;
  Vec3 z_B = (1.0 / an) * acc_cmd;
  Vec3 y_c{0.0, 1.0, 0.0};
  Vec3 x_B = cross(y_c, z_B);
  double xn = norm(x_B);
  if (xn < 1e-9) xn = 1e-9;
  x_B = (1.0 / xn) * x_B;
  Vec3 y_B = cross(z_B, x_B);
  double R[3][3] = {{x_B.x, y_B.x, z_B.x}, {x_B.y, y_B.y, z_B.y}, {x_B.z, y_B.z, z_B.z}};
  Quat q_des = rotmat_to_quat(R);

  Vec3 omega_cmd = tilt_prioritized_control(s.q, q_des, g.kp_att_xy, g.kp_att_z);
  omega_cmd = clip3(omega_cmd, prm.omega_max);
  // bodyrate P -> angular acceleration -> torque (low-level controller)
  Vec3 alpha{g.kp_rate.x * (omega_cmd.x - s.w.x), g.kp_rate.y * (omega_cmd.y - s.w.y),
             g.kp_rate.z * (omega_cmd.z - s.w.z)};
  Vec3 Jw{prm.J.x * s.w.x, prm.J.y * s.w.y, prm.J.z * s.w.z};
  Vec3 gyro = cross(s.w, Jw);
  GeoOut out;
  out.thrust_cmd = thrust_cmd;
  out.torque = {prm.J.x * alpha.x + gyro.x, prm.J.y * alpha.y + gyro.y,
                prm.J.z * alpha.z + gyro.z};
  return out;
}

// Full stack, mirroring sim/rigid_body.RigidBodyQuad step-for-step.
struct FlightCore {
  Params prm;
  Gains gains;
  Allocation alloc;
  double cmd_timeout;

  RigidState s;
  double th[4];
  double t;
  Vec3 v_cmd;
  double cmd_time;
  Vec3 p_ref;  // velocity reference integrates its own setpoint
               // (velocity_reference.cpp:26-35)

  FlightCore(Vec3 start, double timeout)
      : alloc(prm), cmd_timeout(timeout) {
    reset(start);
  }

  void reset(Vec3 start) {
    s.p = start;
    s.v = {0, 0, 0};
    s.q = {1, 0, 0, 0};
    s.w = {0, 0, 0};
    double hover = prm.mass * kG / 4.0;
    for (double& x : th) x = hover;
    t = 0.0;
    v_cmd = {0, 0, 0};
    cmd_time = -1e300;
    p_ref = start;
  }

  void set_velocity_command(Vec3 v) {
    v_cmd = v;
    cmd_time = t;
  }

  void step(double dt) {
    Vec3 cmd = v_cmd;
    if (t - cmd_time > cmd_timeout) cmd = {0, 0, 0};  // timeout-to-zero
    // integrate reference, softly re-anchored to the estimate
    // (update_from_estimate path, velocity_reference.cpp:52-58)
    p_ref = p_ref + dt * cmd;
    Vec3 err = p_ref - s.p;
    err = clip3(err, Vec3{1.5, 1.5, 1.0});
    p_ref = s.p + err;

    GeoOut u = geo_command(s, p_ref, cmd, prm, gains);
    // allocation: [f, tau] -> motor thrusts, clamped (clampThrust)
    double wrench[4] = {u.thrust_cmd, u.torque.x, u.torque.y, u.torque.z};
    double mot_des[4];
    double tmax = prm.thrust_max();
    for (int i = 0; i < 4; ++i) {
      double m = 0.0;
      for (int j = 0; j < 4; ++j) m += alloc.Binv[i][j] * wrench[j];
      mot_des[i] = m < 0.0 ? 0.0 : (m > tmax ? tmax : m);
    }
    // first-order motor lag (motor_tau_inv_, quadrotor_dynamics.cpp:24)
    double alpha_m = 1.0 - std::exp(-dt / prm.motor_tau);
    for (int i = 0; i < 4; ++i) th[i] += alpha_m * (mot_des[i] - th[i]);

    s = rk4_step(s, th, dt, prm, alloc);
    t += dt;
  }

  // state layout: [t, p(3), v(3), q_wxyz(4), w(3)] = 14 doubles
  void get_state(double* out) const {
    out[0] = t;
    out[1] = s.p.x; out[2] = s.p.y; out[3] = s.p.z;
    out[4] = s.v.x; out[5] = s.v.y; out[6] = s.v.z;
    out[7] = s.q.w; out[8] = s.q.x; out[9] = s.q.y; out[10] = s.q.z;
    out[11] = s.w.x; out[12] = s.w.y; out[13] = s.w.z;
  }
};

}  // namespace

extern "C" {

void* flightcore_create(double sx, double sy, double sz, double cmd_timeout) {
  return new FlightCore(Vec3{sx, sy, sz}, cmd_timeout);
}

void flightcore_destroy(void* h) { delete static_cast<FlightCore*>(h); }

void flightcore_reset(void* h, double sx, double sy, double sz) {
  static_cast<FlightCore*>(h)->reset(Vec3{sx, sy, sz});
}

void flightcore_set_velocity_command(void* h, double vx, double vy, double vz) {
  static_cast<FlightCore*>(h)->set_velocity_command(Vec3{vx, vy, vz});
}

void flightcore_step(void* h, double dt, double* out14) {
  auto* fc = static_cast<FlightCore*>(h);
  fc->step(dt);
  fc->get_state(out14);
}

void flightcore_get_state(void* h, double* out14) {
  static_cast<FlightCore*>(h)->get_state(out14);
}

// Batched stepping: run n_steps at dt, applying a (possibly repeated)
// velocity command every cmd_every steps from cmds[3*n_cmds]; writes the
// state after every step into out[n_steps*14].  Lets the deployment loop
// amortize the ctypes boundary the way the device side amortizes dispatch.
void flightcore_run(void* h, double dt, const double* cmds, long long n_cmds,
                    long long cmd_every, long long n_steps, double* out) {
  auto* fc = static_cast<FlightCore*>(h);
  for (long long i = 0; i < n_steps; ++i) {
    if (cmd_every > 0 && i % cmd_every == 0) {
      long long ci = i / cmd_every;
      if (ci >= n_cmds) ci = n_cmds - 1;
      if (ci >= 0)
        fc->set_velocity_command(Vec3{cmds[3 * ci], cmds[3 * ci + 1], cmds[3 * ci + 2]});
    }
    fc->step(dt);
    fc->get_state(out + 14 * i);
  }
}

}  // extern "C"

#ifdef FLIGHTCORE_TEST
#include <cstdio>
#include <cstdlib>

static int failures = 0;
#define CHECK(cond, ...)                               \
  do {                                                 \
    if (!(cond)) {                                     \
      std::printf("FAIL %s:%d: ", __FILE__, __LINE__); \
      std::printf(__VA_ARGS__);                        \
      std::printf("\n");                               \
      ++failures;                                      \
    }                                                  \
  } while (0)

int main() {
  const double dt = 0.01;

  // 1. hover: zero command from rest -> stays at start (commands time out
  //    immediately; controller holds the anchored reference)
  {
    FlightCore fc(Vec3{0, 0, 2}, 0.5);
    double st[14];
    for (int i = 0; i < 200; ++i) fc.step(dt);
    fc.get_state(st);
    CHECK(std::fabs(st[1]) < 0.02 && std::fabs(st[2]) < 0.02 &&
              std::fabs(st[3] - 2.0) < 0.02,
          "hover drifted to (%.4f %.4f %.4f)", st[1], st[2], st[3]);
  }

  // 2. velocity tracking: command (4,0,0) held -> tracks within 0.25 m/s
  {
    FlightCore fc(Vec3{0, 0, 2}, 0.5);
    double st[14];
    for (int i = 0; i < 300; ++i) {
      fc.set_velocity_command(Vec3{4, 0, 0});
      fc.step(dt);
    }
    fc.get_state(st);
    // thresholds match tests/test_rigid_body.py::test_velocity_step_tracking
    CHECK(std::fabs(st[4] - 4.0) < 0.3, "vx=%.3f after 3 s of cmd 4", st[4]);
    CHECK(st[1] > 7.0, "x=%.3f after 3 s of cmd 4", st[1]);
    CHECK(std::fabs(st[3] - 2.0) < 0.25, "z drifted to %.3f", st[3]);
  }

  // 3. timeout-to-zero: stale command decays, vehicle stops
  {
    FlightCore fc(Vec3{0, 0, 2}, 0.5);
    double st[14];
    fc.set_velocity_command(Vec3{3, 0, 0});
    for (int i = 0; i < 400; ++i) fc.step(dt);  // cmd stale after 0.5 s
    fc.get_state(st);
    // matches tests/test_rigid_body.py::test_command_timeout_decays_to_hover
    CHECK(std::fabs(st[4]) < 0.25, "vx=%.3f long after timeout", st[4]);
  }

  // 4. batched run == per-step run
  {
    FlightCore a(Vec3{0, 0, 2}, 0.5), b(Vec3{0, 0, 2}, 0.5);
    const long long n = 120;
    double cmds[3 * 4] = {2, 0, 0, 2, 1, 0, 0, -1, 0, 0, 0, 0.5};
    double out[14 * n];
    flightcore_run(&a, dt, cmds, 4, 30, n, out);
    double st[14];
    for (long long i = 0; i < n; ++i) {
      long long ci = i / 30;
      if (i % 30 == 0) b.set_velocity_command(Vec3{cmds[3 * ci], cmds[3 * ci + 1], cmds[3 * ci + 2]});
      b.step(dt);
    }
    b.get_state(st);
    for (int k = 0; k < 14; ++k)
      CHECK(std::fabs(st[k] - out[14 * (n - 1) + k]) < 1e-12,
            "batched mismatch at field %d: %.15g vs %.15g", k, st[k],
            out[14 * (n - 1) + k]);
  }

  // 5. attitude stays sane under aggressive lateral commands
  {
    FlightCore fc(Vec3{0, 0, 2}, 0.5);
    double st[14];
    for (int i = 0; i < 500; ++i) {
      double vy = (i / 50) % 2 ? 3.0 : -3.0;
      fc.set_velocity_command(Vec3{4, vy, 0});
      fc.step(dt);
      fc.get_state(st);
      double qn = std::sqrt(st[7] * st[7] + st[8] * st[8] + st[9] * st[9] + st[10] * st[10]);
      CHECK(std::fabs(qn - 1.0) < 1e-9, "quat norm %.12f at step %d", qn, i);
      CHECK(std::isfinite(st[1]) && std::isfinite(st[4]), "non-finite state at %d", i);
      // command reversals bank hard (numpy twin reaches 79 deg in this
      // exact scenario — /tmp parity run) but must never flip over
      CHECK(st[7] > std::cos(0.5 * 120.0 * M_PI / 180.0), "flip-over: qw=%.3f at %d",
            st[7], i);
    }
  }

  if (failures) {
    std::printf("flightcore_test: %d FAILURES\n", failures);
    return 1;
  }
  std::printf("flightcore_test: all checks passed\n");
  return 0;
}
#endif  // FLIGHTCORE_TEST
