// Device functions of one reach, shared by the whole-simulation kernels.
//
// The closures (ops/hydraulics.py, ops/sections.py), the rating curves of a
// boundary (ops/rating_curve.py), the lumped-storage row (ops/storage.py,
// ops/boundary.py), the boundary rows and the block reduction of the fused
// single-reach kernel (fused_newton.cu: kernels 1 and 3) and of the fused
// network kernel (fused_network.cu: kernels 5 and 6), with the packed layouts
// both read: geometry rows, the scalar parameter block of a reach's two
// boundaries (P_*), a boundary's storage block (SP_*) and the kind codes.
// The arithmetic mirrors the plain PyTorch versions expression for
// expression; built with --fmad=false it matches them to rounding.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr double G = 9.80665;

// rows of the packed geometry [13, N]
enum { G_ZBED, G_BMAIN, G_MMAIN, G_NMAIN, G_COMPOUND, G_HBANK, G_BFPL, G_BFPR, G_MFP,
       G_NLEFT, G_NRIGHT, G_BEDSLOPE, G_CURV, G_ROWS };

// slots of the packed scalar parameters
enum { P_THETA, P_DT, P_DX, P_TOL,
       P_US_BED_LEVEL, P_US_BED_SLOPE, P_US_INIT_DEPTH,
       P_DS_BED_LEVEL, P_DS_BED_SLOPE, P_DS_INIT_DEPTH,
       P_RC_LOW0, P_RC_LOW1, P_RC_LOW2, P_RC_HIGH0, P_RC_HIGH1, P_RC_HIGH2,
       P_RC_SHIFT, P_RC_PIVOT, P_RC_BUFFER, P_RC_FD, P_RC_COOLDOWN, P_GATE_INIT,
       // the upstream rating curve (polynomial or blended_poly; never gated)
       P_URC_LOW0, P_URC_LOW1, P_URC_LOW2, P_URC_HIGH0, P_URC_HIGH1, P_URC_HIGH2,
       P_URC_SHIFT, P_URC_PIVOT, P_URC_BUFFER, P_URC_FD, P_COUNT };

// slots of one boundary's storage block, [S, 2, SP_COUNT] (0: upstream, 1: downstream)
enum { SP_SURFACE_AREA, SP_MIN_STAGE, SP_Y_MIN, SP_Y_MAX, SP_BETA, SP_LRES, SP_KQ,
       SP_RC_LOW0, SP_RC_LOW1, SP_RC_LOW2, SP_RC_HIGH0, SP_RC_HIGH1, SP_RC_HIGH2,
       SP_RC_SHIFT, SP_RC_PIVOT, SP_RC_BUFFER, SP_RC_FD, SP_COUNT };
// bits of a boundary's storage flags; bits 4.. hold the storage rating's kind
enum { ST_ON = 1, ST_AREA_CURVE = 2, ST_RATING = 4, ST_LOSSES = 8, ST_RC_SHIFT = 4 };
constexpr int BISECT_ITERS = 80;          // ops/storage.py
constexpr double INTERP_EPS = 4.930380657631324e-32;  // spacing(eps), as jnp.interp guards dx

enum { BC_FLOW = 0, BC_STAGE = 1, BC_FIXED = 2, BC_NORMAL = 3, BC_RATING = 4 };
// rating kinds (ops/rating_curve.py): a boundary rating is one of the first
// three; a lumped storage or a junction takes every kind but gated_blend
enum { RC_POLY = 0, RC_BLEND = 1, RC_GATED = 2, RC_POLY_N = 3, RC_POWER = 4, RC_TABLE = 5 };
enum { QLAT_NONE = 0, QLAT_CONST = 1, QLAT_LEVELS = 2 };

// torch.clamp semantics: NaN propagates (fmax/fmin would drop it)
__device__ __forceinline__ double clamp_min(double x, double lo) { return x < lo ? lo : x; }
__device__ __forceinline__ double clamp01(double x) { return x < 0.0 ? 0.0 : (x > 1.0 ? 1.0 : x); }

// -- ops/hydraulics.py ------------------------------------------------------

__device__ __forceinline__ double cbrt_polished(double x) {
    if (x == 0.0) return 0.0;
    const double r = cbrt(x);
    const double r2 = r * r;
    const double r3 = r2 * r;
    return r - (r3 - x) / (3.0 * r2);
}
__device__ __forceinline__ double pow_2_3(double x) { const double c = cbrt_polished(x); return c * c; }
__device__ __forceinline__ double pow_m1_3(double x) { return 1.0 / cbrt_polished(x); }
__device__ __forceinline__ double pow_1_6(double x) { return sqrt(cbrt_polished(x)); }
__device__ __forceinline__ double pow_3_2(double x) { return x > 0.0 ? x * sqrt(x) : 0.0; }

__device__ __forceinline__ double conveyance(double A, double n, double R) { return A * pow_2_3(R) / n; }
__device__ __forceinline__ double hyd_dK_dA(double A, double n, double R, double dR_dA) {
    return (pow_2_3(R) + A * (2.0 / 3.0) * pow_m1_3(R) * dR_dA) / n;
}
__device__ __forceinline__ double friction_slope(double Q, double K) { return Q * fabs(Q) / (K * K); }
__device__ __forceinline__ double hyd_dSf_dA(double Q, double K, double dK) {
    return -2.0 * friction_slope(Q, K) * (dK / K);
}
__device__ __forceinline__ double hyd_dSf_dQ(double Q, double K) { return 2.0 * fabs(Q) / (K * K); }
__device__ __forceinline__ double froude(double T, double A, double Q) {
    const double V = Q / clamp_min(A, 1e-6);
    const double D = A / clamp_min(T, 1e-6);
    return V / sqrt(G * clamp_min(D, 1e-6));
}
__device__ __forceinline__ double dFr_dA(double T, double A, double Q) {
    const double V = Q / A;
    const double D = A / T;
    const double dV_dA = -Q / (A * A);
    const double dD_dA = 1.0 / T;
    const double gD = G * D;
    const double inv_sqrt = 1.0 / sqrt(gD);
    return -0.5 * V * (inv_sqrt / gD) * G * dD_dA + dV_dA * inv_sqrt;
}
__device__ __forceinline__ double dFr_dQ(double T, double A) {
    const double D = A / T;
    return (1.0 / A) / sqrt(G * D);
}
__device__ __forceinline__ double darcy_f(double n, double R) {
    const double C = pow_1_6(R) / n;
    return (8.0 * G) / (C * C);
}
__device__ __forceinline__ double curvature_slope(double h, double T, double A, double Q,
                                                  double n, double R, double rc) {
    const double Fr = froude(T, A, Q);
    const double f = darcy_f(n, R);
    const double sqrtf_ = sqrt(f);
    const double num = (2.86 * sqrtf_ + 2.07 * f) * h * h * Fr * Fr;
    const double den = (0.565 + sqrtf_) * rc * rc;
    return num / den;
}
__device__ __forceinline__ double hyd_dSc_dA(double h, double A, double Q, double n, double R,
                                             double rc, double dR_dA, double T) {
    const double Fr = froude(T, A, Q);
    const double f = darcy_f(n, R);
    const double dh_dA = 1.0 / T;
    const double dFr = dFr_dA(T, A, Q);
    const double df_dA = (-(8.0 / 3.0) * G) * n * n * (pow_m1_3(R) / R) * dR_dA;
    const double sqrtf_ = sqrt(f);
    const double num = (2.86 * sqrtf_ + 2.07 * f) * h * h * Fr * Fr;
    const double den = (0.565 + sqrtf_) * rc * rc;
    const double dnum_dA = (2.86 / (2.0 * sqrtf_) * df_dA + 2.07 * df_dA) * h * h * Fr * Fr
        + (2.86 * sqrtf_ + 2.07 * f) * (2.0 * h * dh_dA * Fr * Fr + h * h * 2.0 * Fr * dFr);
    const double dden_dA = (1.0 / (2.0 * sqrtf_) * df_dA) * rc * rc;
    return (dnum_dA * den - num * dden_dA) / (den * den);
}
__device__ __forceinline__ double hyd_dSc_dQ(double h, double T, double A, double Q, double n,
                                             double R, double rc) {
    const double Fr = froude(T, A, Q);
    const double f = darcy_f(n, R);
    const double dFr = dFr_dQ(T, A);
    const double sqrtf_ = sqrt(f);
    const double den = (0.565 + sqrtf_) * rc * rc;
    const double dnum_dQ = (2.86 * sqrtf_ + 2.07 * f) * h * h * 2.0 * Fr * dFr;
    return dnum_dQ / den;
}

// -- ops/sections.py --------------------------------------------------------

struct Geo {
    double z, b, m, n, hbank, bl, br, mfp, nl, nr, s0, curv;
    bool compound;
};

struct Sec { double A, P, R, T, K, n_eq, dA_dh, dR_dA, dK_dA; };
struct Slope { double Se, dSe_dA, dSe_dQ; };

__device__ __forceinline__ double safe_div(double num, double den) { return den > 0.0 ? num / den : 0.0; }

__device__ Sec section_state(const Geo& g, double depth_in) {
    const double depth = clamp_min(depth_in, 0.0);
    const bool wet = depth > 0.0;
    const bool ob = g.compound && (depth > g.hbank);
    const double hb = g.compound ? g.hbank : 1.0;
    const double d_fp = ob ? depth - hb : 0.0;

    const double sq_m = sqrt(1.0 + g.m * g.m);
    const double sq_fp = sqrt(1.0 + g.mfp * g.mfp);

    const double T_s = g.b + 2.0 * g.m * depth;
    const double A_s = (g.b + g.m * depth) * depth;
    const double P_s = g.b + 2.0 * depth * sq_m;

    const double T_bank = g.b + 2.0 * g.m * hb;
    const double A_mf = (g.b + T_bank) / 2.0 * hb;
    const double P_mf = g.b + 2.0 * hb * sq_m;

    const double A_l = (g.bl + 0.5 * g.mfp * d_fp) * d_fp;
    const double P_l = g.bl + d_fp * sq_fp;
    const double A_r = (g.br + 0.5 * g.mfp * d_fp) * d_fp;
    const double P_r = g.br + d_fp * sq_fp;
    const double width_at_bank = g.bl + T_bank + g.br;

    Sec s;
    double A = ob ? A_mf + A_l + A_r : A_s;
    double P = ob ? P_mf + P_l + P_r : P_s;
    double T = ob ? width_at_bank + 2.0 * g.mfp * d_fp : T_s;
    if (!wet) { A = 0.0; P = 0.0; T = 0.0; }
    const double R = safe_div(A, P);

    // Horton-Einstein subsections: below bankfull the whole section is "main"
    const double A_m = ob ? A_mf + T_bank * d_fp : A;
    const double P_m = ob ? P_mf : P;
    const double R_m = safe_div(A_m, P_m);
    const double A_l2 = ob ? A_l : 0.0, P_l2 = ob ? P_l : 0.0;
    const double R_l = safe_div(A_l2, P_l2);
    const double A_r2 = ob ? A_r : 0.0, P_r2 = ob ? P_r : 0.0;
    const double R_r = safe_div(A_r2, P_r2);
    const double K_l = P_l2 > 0.0 ? conveyance(A_l2, g.nl, R_l) : 0.0;
    const double K_m = P_m > 0.0 ? conveyance(A_m, g.n, R_m) : 0.0;
    const double K_r = P_r2 > 0.0 ? conveyance(A_r2, g.nr, R_r) : 0.0;

    const double ksum = pow_3_2(K_l) + pow_3_2(K_m) + pow_3_2(K_r);
    const double K_compound = ksum > 0.0 ? pow_2_3(ksum) : 0.0;
    const double K_simple = conveyance(A, g.n, R);
    s.K = g.compound ? K_compound : K_simple;

    const double n_eq_c = (A > 0.0 && R > 0.0 && K_compound > 0.0)
        ? A * pow_2_3(R) / (K_compound > 0.0 ? K_compound : 1.0) : g.n;
    s.n_eq = g.compound ? n_eq_c : g.n;

    const double dP_dh = ob ? 2.0 * sq_fp : 2.0 * sq_m;
    const bool ok = (P > 0.0) && (T > 0.0);
    const double dP_dA = dP_dh / (ok ? T : 1.0);
    s.dR_dA = ok ? (P - A * dP_dA) / (P * P) : 0.0;
    s.dK_dA = A > 0.0 ? hyd_dK_dA(A, s.n_eq, R, s.dR_dA) : 0.0;
    s.A = A; s.P = P; s.R = R; s.T = T; s.dA_dh = T;
    return s;
}

// -- ops/sections.py, the table path (irregular sections) ---------------------

// rows of the packed table geometry [TG_ROWS, N]; the seven tables stay in
// device memory, read through L2: the four that the geometry alone sets,
// [TS_COUNT, N, M] and shared by the members of an ensemble, and K, n_eq and
// dK/dA, three arrays [S, N, M] as the geometry holds them (a roughness
// ensemble rescales them per member)
enum { TG_ZBED, TG_DMAX, TG_BEDSLOPE, TG_CURV, TG_ROWS };
enum { TS_A, TS_P, TS_T, TS_DR, TS_COUNT };
static_assert(TG_ZBED == G_ZBED, "both layouts keep the bed level in row 0");

// One node's tables: its row at sample 0 of the first shared table (nm =
// N * M doubles between two shared tables) and of its member's K, n_eq and
// dK/dA; dgrid = depth_max / (M - 1) as the plain engine forms it, jmax = M - 2.
struct TabGeo {
    const double* ts;
    const double* k;
    const double* neq;
    const double* dk;
    size_t nm;
    double z, curv, dgrid, jmax;
};

// ops/sections.py::_table_section_state, operation for operation: the raw
// depth over the grid step (a division, as the plain engine does it, not a
// product with a packed reciprocal), the bracket floored and clamped to
// [0, M-2] in float64 before it becomes an index (fmax takes 0 for a NaN
// depth, whose values stay NaN through frac: no read out of range), frac may
// exceed 1 (linear extrapolation beyond the table), lo + frac * (hi - lo),
// and only A, P, T and K wet-masked.  Two rows of each of the seven tables
// are read, 14 doubles a node.
__device__ Sec section_state(const TabGeo& g, double depth) {
    const double x = depth / g.dgrid;
    const double jf = fmin(fmax(floor(x), 0.0), g.jmax);
    const int j = (int)jf;
    const double frac = x - jf;
    auto lerp = [&](const double* t) {
        const double lo = t[j];
        return lo + frac * (t[j + 1] - lo);
    };
    const bool wet = depth > 0.0;
    Sec s;
    s.A = wet ? lerp(g.ts + TS_A * g.nm) : 0.0;
    s.P = wet ? lerp(g.ts + TS_P * g.nm) : 0.0;
    s.T = wet ? lerp(g.ts + TS_T * g.nm) : 0.0;
    s.K = wet ? lerp(g.k) : 0.0;
    s.n_eq = lerp(g.neq);
    s.dK_dA = lerp(g.dk);
    s.dR_dA = lerp(g.ts + TS_DR * g.nm);
    s.R = safe_div(s.A, s.P);
    s.dA_dh = s.T;
    return s;
}

// Geometry GEO: Geo (trapezoid) or TabGeo (tables); it reads the curvature alone
template <class GEO>
__device__ Slope energy_slope(const GEO& g, const Sec& s, double h, double Q) {
    const bool Kpos = s.K > 0.0;
    const double Ksafe = Kpos ? s.K : 1.0;
    const double Sf = Kpos ? friction_slope(Q, Ksafe) : 0.0;
    const double dSf_dA = Kpos ? hyd_dSf_dA(Q, Ksafe, s.dK_dA) : 0.0;
    const double dSf_dQ = Kpos ? hyd_dSf_dQ(Q, Ksafe) : 0.0;

    const bool has_curv = g.curv != 0.0;
    const bool has_curv_d = fabs(g.curv) > 1e-12;
    const double rc = 1.0 / (has_curv ? g.curv : 1.0);
    const double Rsafe = s.R > 0.0 ? s.R : 1.0;

    const double Sc = has_curv ? curvature_slope(h, s.T, s.A, Q, s.n_eq, Rsafe, rc) : 0.0;
    const double dSc_dA = has_curv_d
        ? hyd_dSc_dA(h, s.A, Q, s.n_eq, Rsafe, rc, s.dR_dA, s.T) * s.dA_dh : 0.0;
    const double dSc_dQ = has_curv_d ? hyd_dSc_dQ(h, s.T, s.A, Q, s.n_eq, Rsafe, rc) : 0.0;

    Slope e;
    e.Se = Sf + Sc;
    e.dSe_dA = dSf_dA + dSc_dA;
    e.dSe_dQ = dSf_dQ + dSc_dQ;
    return e;
}

// -- ops/rating_curve.py ----------------------------------------------------

struct Rating {
    double low0, low1, low2, high0, high1, high2, shift, pivot, buffer, fd, cooldown;
    int kind;
};

__device__ __forceinline__ double quad(double c0, double c1, double c2, double x) {
    return (c0 * x + c1) * x + c2;
}

// Q(stage); gate_open is read by the gated kind only
__device__ __forceinline__ double rating_q(const Rating& r, double stage, double gate_open) {
    if (r.kind == RC_POLY) {
        const double x = stage + r.shift;
        return r.low0 * x * x + r.low1 * x + r.low2;
    }
    const double ds = stage - r.pivot;  // centered basis
    const double low = quad(r.low0, r.low1, r.low2, ds);
    const double high = quad(r.high0, r.high1, r.high2, ds);
    if (r.kind == RC_GATED) return gate_open > 0.5 ? high : low;
    double s = (stage - r.pivot) / clamp_min(r.buffer, 1e-30);
    s = clamp01(s);
    const double alpha = 3.0 * s * s - 2.0 * s * s * s;
    return low + alpha * (high - low);
}

__device__ __forceinline__ double rating_dq_dz(const Rating& r, double stage, double gate_open) {
    if (r.kind == RC_POLY) {
        const double x = stage + r.shift;
        return r.low0 * 2.0 * x + r.low1;
    }
    // central difference with the reference's step, not the analytic slope
    return (rating_q(r, stage + r.fd, gate_open) - rating_q(r, stage - r.fd, gate_open)) / (2.0 * r.fd);
}

// rating_curve._interp: linear interpolation, the end values held outside
// (it clamps otherwise than storage.interp below: the bracket [i, i+1] with
// i = searchsorted(right=True) - 1 in [0, n-2], the ends at x <= xp[0] and
// x >= xp[n-1])
__device__ __forceinline__ double table_q(const double* __restrict__ xp, const double* __restrict__ fp, int n,
                                          double x) {
    int lo = 0, hi = n;   // searchsorted(right=True): entries <= x
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (xp[mid] <= x) lo = mid + 1; else hi = mid;
    }
    int i = lo - 1;
    i = i < 0 ? 0 : (i > n - 2 ? n - 2 : i);
    const double x0 = xp[i], x1 = xp[i + 1], f0 = fp[i], f1 = fp[i + 1];
    double val = f0 + (x - x0) * (f1 - f0) / (x1 - x0);
    if (x <= xp[0]) val = fp[0];
    if (x >= xp[n - 1]) val = fp[n - 1];
    return val;
}

// rating_curve.discharge of the kinds beyond the quadratics, shared by the
// storage row and the junctions of fused_network.cu (each evaluates the
// quadratic kinds itself): poly_n Horner from the top of its `count`
// ascending coefficients at `data` (_polyval_ascending); power a * pow(stage
// + shift, b) (a stage below -shift gives NaN, as the plain engine's tensor
// power does); table rating_curve._interp of `count` stages then `count`
// discharges at `data`.
__device__ __forceinline__ double rating_discharge_n(int kind, double a, double b, double shift,
                                                     const double* __restrict__ data, int count, double stage) {
    if (kind == RC_POLY_N) {
        const double x = stage + shift;
        double out = data[count - 1];
        for (int j = count - 2; j >= 0; --j) out = out * x + data[j];
        return out;
    }
    if (kind == RC_POWER) return a * pow(stage + shift, b);
    return table_q(data, data + count, count, stage);
}

// -- ops/storage.py ---------------------------------------------------------

// ops/storage.py::interp: linear interpolation, the end values held outside
__device__ __forceinline__ double interp_table(double x, const double* __restrict__ xp,
                                               const double* __restrict__ fp, int n) {
    // searchsorted(right=True): the number of entries <= x, by bisection
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (xp[mid] <= x) lo = mid + 1; else hi = mid;
    }
    const int i = lo < 1 ? 1 : (lo > n - 1 ? n - 1 : lo);
    const double df = fp[i] - fp[i - 1];
    const double dx = xp[i] - xp[i - 1];
    const double delta = x - xp[i - 1];
    double val = fabs(dx) <= INTERP_EPS ? fp[i - 1] : fp[i - 1] + (delta / dx) * df;
    if (x < xp[0]) val = fp[0];
    if (x > xp[n - 1]) val = fp[n - 1];
    return val;
}

__device__ __forceinline__ int sign_of(double x) { return (x > 0.0) - (x < 0.0); }

// The fixed_depth + storage boundary row (ops/boundary.py::evaluate, storage
// branch).  sp: this boundary's SP_* block; tab: its tables
// [vol_stage(nv) | vol_table(nv) | area_stage(na) | area_table(na) |
// rating data(nr)], the rating data of a poly_n or table outflow rating
// (rating_discharge_n; power keeps a and b in the block).
// Writes df_dh, df_dQ, -residual and the new stage where the caller points;
// returns the residual.  Not inlined: one thread of the block runs it, and
// its registers should not count against the other threads' budget.
__device__ __noinline__ double storage_row(const double* __restrict__ sp,
                                           const double* __restrict__ tab, int flags, int nv, int na, int nr,
                                           double sign, double bed_level, double dt, double Q_prev,
                                           double Y_old, double A, double R, double n_eq,
                                           double dR_dA, double dA_dh, double h, double Q,
                                           double* p_df_dh, double* p_df_dQ, double* p_neg_res,
                                           double* p_stage) {
    const bool curve = flags & ST_AREA_CURVE, rated = flags & ST_RATING, losses = flags & ST_LOSSES;
    const double* vol_stage = tab;
    const double* vol_table = tab + nv;
    const double* area_stage = tab + 2 * nv;
    const double* area_table = area_stage + na;
    const double* rating_data = area_table + na;
    const double SA = sp[SP_SURFACE_AREA], min_stage = sp[SP_MIN_STAGE];
    Rating rat{};
    if (rated)
        rat = Rating{sp[SP_RC_LOW0], sp[SP_RC_LOW1], sp[SP_RC_LOW2], sp[SP_RC_HIGH0], sp[SP_RC_HIGH1],
                     sp[SP_RC_HIGH2], sp[SP_RC_SHIFT], sp[SP_RC_PIVOT], sp[SP_RC_BUFFER], sp[SP_RC_FD],
                     0.0, flags >> ST_RC_SHIFT};
    // nr doubles of rating data: poly_n's coefficients, or a table's stages then discharges
    const int r_count = rat.kind == RC_TABLE ? nr / 2 : nr;

    const double vol_in = sign * 0.5 * (Q_prev + Q) * dt;

    // mass_balance: 80 halvings of [y_min, y_max] on
    //   g(Y) = net_vol_change(Y_old, Y) - (vol_in - 0.5 (q(Y_old) + q(Y)) dt)
    const double v_old = curve ? interp_table(Y_old, vol_stage, vol_table, nv) : 0.0;
    auto q_of = [&](double Y) {
        return rat.kind >= RC_POLY_N ? rating_discharge_n(rat.kind, rat.low0, rat.low1, rat.shift, rating_data,
                                                          r_count, Y)
                                     : rating_q(rat, Y, 0.0);
    };
    const double q_old = rated ? q_of(Y_old) : 0.0;
    auto g_of = [&](double Y) {
        const double q_new = rated ? q_of(Y) : 0.0;
        const double target_vol = vol_in - 0.5 * (q_old + q_new) * dt;
        const double dv = curve ? interp_table(Y, vol_stage, vol_table, nv) - v_old : (Y - Y_old) * SA;
        return dv - target_vol;
    };
    double lo = sp[SP_Y_MIN], hi = sp[SP_Y_MAX];
    double f_lo = g_of(lo);
    for (int b = 0; b < BISECT_ITERS; ++b) {
        const double mid = 0.5 * (lo + hi);
        const double f_mid = g_of(mid);
        // torch.sign(f_mid) == torch.sign(f_lo): false when either is NaN
        const bool go_right = f_mid == f_mid && f_lo == f_lo && sign_of(f_mid) == sign_of(f_lo);
        if (go_right) { lo = mid; f_lo = f_mid; } else { hi = mid; }
    }
    double Y_new = 0.5 * (lo + hi);
    if (Y_new < min_stage) Y_new = min_stage;

    // entrance losses: friction over the reservoir length + K_q V^2 / 2g
    double head_loss = 0.0, d_hl_dA = 0.0, d_hl_dQ = 0.0;
    if (losses) {
        const double Lres = sp[SP_LRES], K_q = sp[SP_KQ];
        const double K = conveyance(A, n_eq, R);
        const double dK = hyd_dK_dA(A, n_eq, R, dR_dA);
        const double V = Q / A;
        head_loss = friction_slope(Q, K) * Lres + K_q * V * V / (2.0 * G);
        const double dV_dA = -Q / (A * A);
        d_hl_dA = hyd_dSf_dA(Q, K, dK) * Lres + K_q * 2.0 * V * dV_dA / (2.0 * G);
        const double dV_dQ = 1.0 / A;
        d_hl_dQ = hyd_dSf_dQ(Q, K) * Lres + K_q * 2.0 * V * dV_dQ / (2.0 * G);
    }
    const double target = (Y_new + sign * head_loss) - bed_level;
    const double area = curve ? interp_table(Y_new + sp[SP_BETA], area_stage, area_table, na) : SA;
    const double dY_dvol = Y_new <= min_stage ? 0.0 : 1.0 / area;
    const double res = h - target;
    *p_df_dh = 1.0 - sign * d_hl_dA * dA_dh;
    *p_df_dQ = -sign * (dY_dvol * 0.5 * dt + d_hl_dQ);
    *p_neg_res = -res;
    *p_stage = Y_new;
    return res;
}

// -- ops/boundary.py --------------------------------------------------------

struct Bc { double bed_level, bed_slope, init_depth; int kind; };

__device__ __forceinline__ void boundary_row(const Bc& bc, const Rating& rat, const Sec& s,
                                             double h, double Q, double target_k, double gate_open,
                                             double& res, double& df_dh, double& df_dQ) {
    switch (bc.kind) {
    case BC_FLOW:
        res = Q - target_k; df_dh = 0.0; df_dQ = 1.0; break;
    case BC_STAGE:
        res = h - (target_k - bc.bed_level); df_dh = 1.0; df_dQ = 0.0; break;
    case BC_FIXED:
        res = h - bc.init_depth; df_dh = 1.0; df_dQ = 0.0; break;
    case BC_NORMAL: {
        const double root = sqrt(fabs(bc.bed_slope));
        const double Qn = s.K * root;
        const double dQn = s.dK_dA * root;
        const bool neg = bc.bed_slope < 0.0;
        res = Q - (neg ? -Qn : Qn);
        df_dh = -(neg ? -dQn : dQn) * s.dA_dh;
        df_dQ = 1.0;
        break;
    }
    default: {  // BC_RATING
        const double stage = bc.bed_level + h;
        res = Q - rating_q(rat, stage, gate_open);
        df_dh = -rating_dq_dz(rat, stage, gate_open);
        df_dQ = 1.0;
        break;
    }
    }
}

// -- the probe build ----------------------------------------------------------

// Phases of an iteration, as the barriers the kernels already have bound
// them: level start (pad re-sync, gate, the level's records), previous-level
// state, closures, assembly with the end and junction rows and the residual
// norm, the PCR sweeps, back-substitution, the Schur rows, the J x J solve and
// the update.  A kernel without a barrier between two of them adds the first
// to the next (kernel 1: back-substitution and update are one phase).
enum { PH_LEVEL, PH_PREV, PH_CLOSURES, PH_ASSEMBLY, PH_SWEEPS, PH_BACKSOLVE, PH_SCHUR, PH_JSOLVE,
       PH_UPDATE, PH_COUNT };

// In a probe build (ON = true) thread 0 of block 0 reads the SM clock right
// after each barrier and adds the cycles since its previous reading to the
// phase that barrier ends; it adds no barrier and changes no operation of the
// kernel, so the probe build gives the production build's bits.  With ON =
// false nothing of it is compiled.
template <bool ON>
struct Probe {
    long long t = 0, cycles[PH_COUNT] = {};
    bool active = false;
    __device__ __forceinline__ void start() {
        if constexpr (ON) {
            active = threadIdx.x == 0 && blockIdx.x == 0;
            if (active) t = clock64();
        }
    }
    __device__ __forceinline__ void mark(int phase) {
        if constexpr (ON) {
            if (active) {
                const long long now = clock64();
                cycles[phase] += now - t;
                t = now;
            }
        }
    }
    __device__ __forceinline__ void write(long long* out) {
        if constexpr (ON) {
            if (active) {
#pragma unroll
                for (int p = 0; p < PH_COUNT; ++p) out[p] = cycles[p];
            }
        }
    }
};

// Sum over the block; every thread returns the same value (each adds the same
// per-warp partials in the same order), so a loop condition on it is uniform.
__device__ __forceinline__ double block_sum(double v, double* warp_part) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_part[warp] = v;
    __syncthreads();
    const int n_warps = (blockDim.x + 31) >> 5;
    double total = 0.0;
    for (int w = 0; w < n_warps; ++w) total += warp_part[w];
    return total;
}

}  // namespace
