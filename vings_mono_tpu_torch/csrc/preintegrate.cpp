// Native IMU preintegration core (Forster combined model).
//
// C++ twin of vings_mono_tpu_torch/tracker/imu.py's
// Preintegration.integrate, the host-side role GTSAM's C++
// PreintegratedCombinedMeasurements plays in the original system. One call
// integrates a whole measurement batch. tracker/imu_native.py builds this
// with the host C++ compiler at first use into build/torch_kernels/ and
// binds it with ctypes; a failed build raises.
//
// State layout (all float64, row-major):
//   dR[9], dv[3], dp[3], dt[1],
//   J_Rbg[9], J_vbg[9], J_vba[9], J_pbg[9], J_pba[9],
//   cov[225]  (15x15, order [phi, v, p, bg, ba])
// total = 286 doubles.

#include <cmath>
#include <cstring>

namespace {

inline void mat3_mul(const double* A, const double* B, double* C) {
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            double s = 0;
            for (int k = 0; k < 3; ++k) s += A[i * 3 + k] * B[k * 3 + j];
            C[i * 3 + j] = s;
        }
}

inline void mat3_mulT_left(const double* A, const double* B, double* C) {
    // C = A^T * B
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            double s = 0;
            for (int k = 0; k < 3; ++k) s += A[k * 3 + i] * B[k * 3 + j];
            C[i * 3 + j] = s;
        }
}

inline void skew(const double* v, double* K) {
    K[0] = 0;     K[1] = -v[2]; K[2] = v[1];
    K[3] = v[2];  K[4] = 0;     K[5] = -v[0];
    K[6] = -v[1]; K[7] = v[0];  K[8] = 0;
}

inline void so3_exp(const double* phi, double* R) {
    double th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
    double K[9], KK[9];
    skew(phi, K);
    mat3_mul(K, K, KK);
    double a, b;
    if (th2 < 1e-16) {
        a = 1.0; b = 0.5;
    } else {
        double th = std::sqrt(th2);
        a = std::sin(th) / th;
        b = (1.0 - std::cos(th)) / th2;
    }
    for (int i = 0; i < 9; ++i) R[i] = a * K[i] + b * KK[i];
    R[0] += 1.0; R[4] += 1.0; R[8] += 1.0;
}

inline void right_jacobian(const double* phi, double* J) {
    double th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
    double K[9], KK[9];
    skew(phi, K);
    mat3_mul(K, K, KK);
    double a, b;
    if (th2 < 1e-16) {
        a = -0.5; b = 1.0 / 6.0;
    } else {
        double th = std::sqrt(th2);
        a = -(1.0 - std::cos(th)) / th2;
        b = (th - std::sin(th)) / (th2 * th);
    }
    for (int i = 0; i < 9; ++i) J[i] = a * K[i] + b * KK[i];
    J[0] += 1.0; J[4] += 1.0; J[8] += 1.0;
}

// cov' = A cov A^T + B Q B^T with block-sparse A (15x15) and B (15x12)
void propagate_cov(double* cov, const double* dRinc_T, const double* Jr,
                   const double* dRk, const double* a_hat, double dt,
                   const double* q /* 12 diag */) {
    double A[225];
    std::memset(A, 0, sizeof(A));
    for (int i = 0; i < 15; ++i) A[i * 15 + i] = 1.0;
    // A[0:3,0:3] = dRinc^T ; A[0:3,9:12] = -Jr*dt
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            A[i * 15 + j] = dRinc_T[i * 3 + j];
            A[i * 15 + (9 + j)] = -Jr[i * 3 + j] * dt;
        }
    double dRa[9];
    mat3_mul(dRk, a_hat, dRa);
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            A[(3 + i) * 15 + j] = -dRa[i * 3 + j] * dt;
            A[(3 + i) * 15 + (12 + j)] = -dRk[i * 3 + j] * dt;
            A[(6 + i) * 15 + j] = -0.5 * dRa[i * 3 + j] * dt * dt;
            A[(6 + i) * 15 + (12 + j)] = -0.5 * dRk[i * 3 + j] * dt * dt;
        }
    for (int i = 0; i < 3; ++i) A[(6 + i) * 15 + (3 + i)] = dt;

    double AC[225];
    for (int i = 0; i < 15; ++i)
        for (int j = 0; j < 15; ++j) {
            double s = 0;
            for (int k = 0; k < 15; ++k) s += A[i * 15 + k] * cov[k * 15 + j];
            AC[i * 15 + j] = s;
        }
    double out[225];
    for (int i = 0; i < 15; ++i)
        for (int j = 0; j < 15; ++j) {
            double s = 0;
            for (int k = 0; k < 15; ++k) s += AC[i * 15 + k] * A[j * 15 + k];
            out[i * 15 + j] = s;
        }
    // B Q B^T: B[0:3,0:3]=Jr*dt, B[3:6,3:6]=dRk*dt, B[6:9,3:6]=.5 dRk dt^2,
    // B[9:12,6:9]=I, B[12:15,9:12]=I; Q diagonal.
    // phi block: Jr diag(q0..2) Jr^T * dt^2
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            double s_phi = 0, s_v = 0, s_p = 0, s_vp = 0;
            for (int k = 0; k < 3; ++k) {
                s_phi += Jr[i * 3 + k] * q[k] * Jr[j * 3 + k];
                s_v += dRk[i * 3 + k] * q[3 + k] * dRk[j * 3 + k];
            }
            s_p = 0.25 * s_v * dt * dt * dt * dt;
            s_vp = 0.5 * s_v * dt * dt * dt;
            out[i * 15 + j] += s_phi * dt * dt;
            out[(3 + i) * 15 + (3 + j)] += s_v * dt * dt;
            out[(6 + i) * 15 + (6 + j)] += s_p;
            out[(3 + i) * 15 + (6 + j)] += s_vp;
            out[(6 + i) * 15 + (3 + j)] += s_vp;
        }
    for (int k = 0; k < 3; ++k) {
        out[(9 + k) * 15 + (9 + k)] += q[6 + k];
        out[(12 + k) * 15 + (12 + k)] += q[9 + k];
    }
    std::memcpy(cov, out, sizeof(out));
}

}  // namespace

extern "C" {

// state: 286 doubles as documented above. meas: (m, 7) rows
// [dt, acc(3), gyro(3)] already bias-INCLUSIVE raw values.
// bias: [bg(3), ba(3)]. noise: [gyr_n, acc_n, gyr_w, acc_w, int_n].
void preintegrate(double* state, const double* meas, long m,
                  const double* bias, const double* noise,
                  double int_noise) {
    double* dR = state;
    double* dv = state + 9;
    double* dp = state + 12;
    double* dtot = state + 15;
    double* J_Rbg = state + 16;
    double* J_vbg = state + 25;
    double* J_vba = state + 34;
    double* J_pbg = state + 43;
    double* J_pba = state + 52;
    double* cov = state + 61;

    for (long s = 0; s < m; ++s) {
        const double dt = meas[s * 7 + 0];
        if (dt <= 0) continue;
        double acc[3], gyr[3];
        for (int i = 0; i < 3; ++i) {
            acc[i] = meas[s * 7 + 1 + i] - bias[3 + i];
            gyr[i] = meas[s * 7 + 4 + i] - bias[i];
        }
        double w_dt[3] = {gyr[0] * dt, gyr[1] * dt, gyr[2] * dt};
        double dRinc[9], Jr[9], a_hat[9], dRk[9];
        std::memcpy(dRk, dR, sizeof(dRk));
        so3_exp(w_dt, dRinc);
        right_jacobian(w_dt, Jr);
        skew(acc, a_hat);

        // bias jacobians (order matters: use pre-update values)
        double dRa[9], dRaJ[9];
        mat3_mul(dRk, a_hat, dRa);
        mat3_mul(dRa, J_Rbg, dRaJ);
        for (int i = 0; i < 9; ++i) {
            J_pba[i] += J_vba[i] * dt - 0.5 * dRk[i] * dt * dt;
            J_pbg[i] += J_vbg[i] * dt - 0.5 * dRaJ[i] * dt * dt;
        }
        for (int i = 0; i < 9; ++i) {
            J_vba[i] += -dRk[i] * dt;
            J_vbg[i] += -dRaJ[i] * dt;
        }
        double newJR[9];
        mat3_mulT_left(dRinc, J_Rbg, newJR);
        for (int i = 0; i < 9; ++i) J_Rbg[i] = newJR[i] - Jr[i] * dt;

        // covariance
        double q[12];
        for (int k = 0; k < 3; ++k) {
            q[k] = noise[0] * noise[0] / dt;
            q[3 + k] = noise[1] * noise[1] / dt;
            q[6 + k] = noise[2] * noise[2] * dt;
            q[9 + k] = noise[3] * noise[3] * dt;
        }
        double dRinc_T[9];
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j)
                dRinc_T[i * 3 + j] = dRinc[j * 3 + i];
        propagate_cov(cov, dRinc_T, Jr, dRk, a_hat, dt, q);
        for (int k = 0; k < 3; ++k)
            cov[(6 + k) * 15 + (6 + k)] += int_noise * int_noise * dt;

        // state
        double dRacc[3] = {0, 0, 0};
        for (int i = 0; i < 3; ++i)
            for (int k = 0; k < 3; ++k)
                dRacc[i] += dRk[i * 3 + k] * acc[k];
        for (int i = 0; i < 3; ++i) {
            dp[i] += dv[i] * dt + 0.5 * dRacc[i] * dt * dt;
            dv[i] += dRacc[i] * dt;
        }
        double newR[9];
        mat3_mul(dRk, dRinc, newR);
        std::memcpy(dR, newR, sizeof(newR));
        *dtot += dt;
    }
}

}  // extern "C"
