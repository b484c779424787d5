// mlprobs_tpu native runtime: host-side hot loops.
//
// The device computes DP matrices and direction bits; these routines do the
// sequential host work the reference does in C++ (traceback walks,
// feature aggregation over pairwise Viterbi alignments) at native speed.
// Exposed via a plain C ABI and loaded with ctypes.
//
// Build: tools/build_native.py, or automatically on first use and again
// whenever this file is newer than the library (utils/native.build).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

// ---------------------------------------------------------------------------
// Log-space scalar primitives (reference arithmetic).
//
// Both reference aligners run their pair-HMMs in float32 log space with
// POLYNOMIAL approximations: LOOKUP_FLOAT, a piecewise cubic fit of
// log1p(exp(x)) on [0, 7.5] used inside every LOG_ADD/LOG_PLUS_EQUALS,
// and a branch-polynomial EXP on [-16, 0] for the posterior
// (ScoreType.h:36-70,185-212 in baseMSA; same family in QuickProbs).
// The fit error is path-dependent, so reproducing the binary's
// posteriors — and through the MWT tie-breaks its alignments — requires
// replaying the same arithmetic, not something more accurate.  These
// scalars mirror ops/qpx.py (the oracle-tested JAX twins).

namespace {

constexpr float LOG_ZERO_F = -2e20f;
constexpr float LOG_UNDERFLOW = 7.5f;

// With R, x * y is rounded on its own: the barrier keeps the compiler
// from contracting the product into the add that follows (an FMA, one
// rounding), so the polynomials give the f32 values XLA computes on the
// GPU and on the CPU (ops/qpx.py _rounded).  The qp-exact engine, which
// the device replays bit for bit, takes R; the other engines keep the
// faster FMAs.
template <bool R, class T>
inline T mul(T x, T y) {
    if constexpr (R) return __builtin_assoc_barrier(x * y);
    else return x * y;
}

template <bool R, class T>
inline T poly3(T x, T a, T b, T c, T d) {
    return mul<R>(mul<R>(mul<R>(a, x) + b, x) + c, x) + d;
}

template <bool R, class T>
inline T poly4(T x, T a, T b, T c, T d, T e) {
    return mul<R>(mul<R>(mul<R>(mul<R>(a, x) + b, x) + c, x) + d, x) + e;
}

template <bool R = false>
inline float lookup_float(float x) {
    // piecewise-cubic log1p(exp(x)) on [0, 7.5]  (ScoreType.h:185-212)
    if (x <= 1.00f)
        return poly3<R>(x, -0.009350833524763f, 0.130659527668286f,
                     0.498799810682272f, 0.693203116424741f);
    if (x <= 2.50f)
        return poly3<R>(x, -0.014532321752540f, 0.139942324101744f,
                     0.495635523139337f, 0.692140569840976f);
    if (x <= 4.50f)
        return poly3<R>(x, -0.004605031767994f, 0.063427417320019f,
                     0.695956496475118f, 0.514272634594009f);
    return poly3<R>(x, -0.000458661602210f, 0.009695946122598f,
                 0.930734667215156f, 0.168037164329057f);
}

template <bool R = false>
inline float log_add(float x, float y) {
    // LOG_ADD with exact LOG_ZERO absorption and the 7.5 threshold
    float hi = x > y ? x : y;
    float lo = x > y ? y : x;
    float d = hi - lo;
    if (lo == LOG_ZERO_F || d >= LOG_UNDERFLOW) return hi;
    return lookup_float<R>(d) + lo;
}

template <bool R = false>
inline void log_plus_equals(float &x, float y) { x = log_add<R>(x, y); }

template <bool R = false>
inline float exp_ref(float x) {
    // branch-polynomial EXP (ScoreType.h:40-60); exp(x) above 0
    if (x > 0.0f) return std::exp(x);
    if (x > -0.5f)
        return poly4<R>(x, 0.03254409303190190000f, 0.16280432765779600000f,
                     0.49929760485974900000f, 0.99995149601363700000f,
                     0.99999925508501600000f);
    if (x > -1.0f)
        return poly4<R>(x, 0.01973899026052090000f, 0.13822379685007000000f,
                     0.48056651562365000000f, 0.99326940370383500000f,
                     0.99906756856399500000f);
    if (x > -2.0f)
        return poly4<R>(x, 0.00940528203591384000f, 0.09414963667859410000f,
                     0.40825793595877300000f, 0.93933625499130400000f,
                     0.98369508190545300000f);
    if (x > -4.0f)
        return poly4<R>(x, 0.00217245711583303000f, 0.03484829428350620000f,
                     0.22118199801337800000f, 0.67049462206469500000f,
                     0.83556950223398500000f);
    if (x > -8.0f)
        return poly4<R>(x, 0.00012398771025456900f, 0.00349155785951272000f,
                     0.03727721426017900000f, 0.17974997741536900000f,
                     0.33249299994217400000f);
    if (x > -16.0f)
        return poly4<R>(x, 0.00000051741713416603f, 0.00002721456879608080f,
                     0.00053418601865636800f, 0.00464101989351936000f,
                     0.01507447981459420000f);
    return 0.0f;
}

// ------------------------------------------------------------------ hmm5
// 5-state double-affine pair-HMM forward/backward match planes in f32
// log space, row-major, per-cell op order mirroring ops/qpx.hmm5_fb_qpx
// (ParallelProbabilisticModel.cpp:40-238 / ProbabilisticModel.h:153-395
// roles).  Outputs the (lx+1)*(ly+1) M planes and total=(tf+tb)/2.

struct Hmm5Tables {
    const float *init;    // (5,)
    const float *trans;   // (5,5) row-major
    const float *lmatch;  // (21,21)
    const float *lins;    // (21,2)
};

inline float T5(const Hmm5Tables &t, int a, int b) {
    return t.trans[a * 5 + b];
}

void hmm5_fb(const int8_t *x, const int8_t *y, int lx, int ly,
             const Hmm5Tables &tb, float *fM, float *bM, float *total) {
    const int W = ly + 1;
    const size_t plane = (size_t)(lx + 1) * W;
    std::vector<float> fx1(plane), fy1(plane), fx2(plane), fy2(plane);
    auto M = [&](float *p, int i, int j) -> float & {
        return p[(size_t)i * W + j];
    };
    for (size_t k = 0; k < plane; ++k)
        fM[k] = fx1[k] = fy1[k] = fx2[k] = fy2[k] = LOG_ZERO_F;

    // ---- forward (row-major; y states consume j-1 within the row) ----
    for (int i = 0; i <= lx; ++i) {
        for (int j = 0; j <= ly; ++j) {
            if (i == 0 && j == 0) continue;
            const int xc = i >= 1 ? x[i - 1] : 20;
            const int yc = j >= 1 ? y[j - 1] : 20;
            // M
            if (i >= 1 && j >= 1) {
                const float em = tb.lmatch[xc * 21 + yc];
                if (i == 1 && j == 1) {
                    M(fM, 1, 1) = tb.init[0] + em;
                } else {
                    float acc = M(fM, i - 1, j - 1) + T5(tb, 0, 0);
                    if (!(acc > LOG_ZERO_F / 2)) acc = LOG_ZERO_F;
                    const float *prev[4] = {
                        &M(fx1.data(), i - 1, j - 1),
                        &M(fy1.data(), i - 1, j - 1),
                        &M(fx2.data(), i - 1, j - 1),
                        &M(fy2.data(), i - 1, j - 1)};
                    const int st[4] = {1, 2, 3, 4};
                    for (int k = 0; k < 4; ++k) {
                        const float v = *prev[k];
                        if (v != LOG_ZERO_F)
                            log_plus_equals(acc, v + T5(tb, st[k], 0));
                    }
                    M(fM, i, j) = acc + em;
                }
            }
            // X states (consume x; depend on (i-1, j))
            if (i >= 1) {
                const float ins0 = tb.lins[xc * 2 + 0];
                const float ins1 = tb.lins[xc * 2 + 1];
                if (i == 1 && j == 0) {
                    M(fx1.data(), 1, 0) = tb.init[1] + ins0;
                    M(fx2.data(), 1, 0) = tb.init[3] + ins1;
                } else {
                    float a = LOG_ZERO_F;
                    if (M(fM, i - 1, j) != LOG_ZERO_F)
                        a = M(fM, i - 1, j) + T5(tb, 0, 1);
                    if (M(fx1.data(), i - 1, j) != LOG_ZERO_F)
                        log_plus_equals(
                            a, M(fx1.data(), i - 1, j) + T5(tb, 1, 1));
                    M(fx1.data(), i, j) = ins0 + a;
                    float b2 = LOG_ZERO_F;
                    if (M(fM, i - 1, j) != LOG_ZERO_F)
                        b2 = M(fM, i - 1, j) + T5(tb, 0, 3);
                    if (M(fx2.data(), i - 1, j) != LOG_ZERO_F)
                        log_plus_equals(
                            b2, M(fx2.data(), i - 1, j) + T5(tb, 3, 3));
                    M(fx2.data(), i, j) = ins1 + b2;
                }
            }
            // Y states (consume y; depend on (i, j-1))
            if (j >= 1) {
                const float ins0 = tb.lins[yc * 2 + 0];
                const float ins1 = tb.lins[yc * 2 + 1];
                if (i == 0 && j == 1) {
                    M(fy1.data(), 0, 1) = tb.init[2] + ins0;
                    M(fy2.data(), 0, 1) = tb.init[4] + ins1;
                } else {
                    float a = LOG_ZERO_F;
                    if (M(fM, i, j - 1) != LOG_ZERO_F)
                        a = M(fM, i, j - 1) + T5(tb, 0, 2);
                    if (M(fy1.data(), i, j - 1) != LOG_ZERO_F)
                        log_plus_equals(
                            a, M(fy1.data(), i, j - 1) + T5(tb, 2, 2));
                    M(fy1.data(), i, j) = ins0 + a;
                    float b2 = LOG_ZERO_F;
                    if (M(fM, i, j - 1) != LOG_ZERO_F)
                        b2 = M(fM, i, j - 1) + T5(tb, 0, 4);
                    if (M(fy2.data(), i, j - 1) != LOG_ZERO_F)
                        log_plus_equals(
                            b2, M(fy2.data(), i, j - 1) + T5(tb, 4, 4));
                    M(fy2.data(), i, j) = ins1 + b2;
                }
            }
        }
    }
    // forward total at (lx, ly): LPE order M, X1, Y1, X2, Y2
    float tf = LOG_ZERO_F;
    const float *fs[5] = {&M(fM, lx, ly), &M(fx1.data(), lx, ly),
                          &M(fy1.data(), lx, ly), &M(fx2.data(), lx, ly),
                          &M(fy2.data(), lx, ly)};
    for (int k = 0; k < 5; ++k)
        if (*fs[k] != LOG_ZERO_F)
            log_plus_equals(tf, *fs[k] + tb.init[k]);

    // ---- backward ----
    std::vector<float> bx1(plane, LOG_ZERO_F), by1(plane, LOG_ZERO_F);
    std::vector<float> bx2(plane, LOG_ZERO_F), by2(plane, LOG_ZERO_F);
    for (size_t k = 0; k < plane; ++k) bM[k] = LOG_ZERO_F;
    for (int i = lx; i >= 0; --i) {
        for (int j = ly; j >= 0; --j) {
            if (i == lx && j == ly) {
                M(bM, i, j) = tb.init[0];
                M(bx1.data(), i, j) = tb.init[1];
                M(by1.data(), i, j) = tb.init[2];
                M(bx2.data(), i, j) = tb.init[3];
                M(by2.data(), i, j) = tb.init[4];
                continue;
            }
            const int xn = i < lx ? x[i] : 20;   // x_{i+1}
            const int yn = j < ly ? y[j] : 20;   // y_{j+1}
            float pxy = LOG_ZERO_F;
            if (i < lx && j < ly && M(bM, i + 1, j + 1) != LOG_ZERO_F)
                pxy = M(bM, i + 1, j + 1) + tb.lmatch[xn * 21 + yn];
            // terms into M: order M, X1, X2, Y1, Y2
            float acc = pxy == LOG_ZERO_F ? LOG_ZERO_F
                                          : pxy + T5(tb, 0, 0);
            if (i < lx) {
                if (M(bx1.data(), i + 1, j) != LOG_ZERO_F)
                    log_plus_equals(acc, M(bx1.data(), i + 1, j)
                                    + tb.lins[xn * 2 + 0] + T5(tb, 0, 1));
                if (M(bx2.data(), i + 1, j) != LOG_ZERO_F)
                    log_plus_equals(acc, M(bx2.data(), i + 1, j)
                                    + tb.lins[xn * 2 + 1] + T5(tb, 0, 3));
            }
            if (j < ly) {
                if (M(by1.data(), i, j + 1) != LOG_ZERO_F)
                    log_plus_equals(acc, M(by1.data(), i, j + 1)
                                    + tb.lins[yn * 2 + 0] + T5(tb, 0, 2));
                if (M(by2.data(), i, j + 1) != LOG_ZERO_F)
                    log_plus_equals(acc, M(by2.data(), i, j + 1)
                                    + tb.lins[yn * 2 + 1] + T5(tb, 0, 4));
            }
            M(bM, i, j) = acc;
            // insert-state levels
            float v;
            v = pxy == LOG_ZERO_F ? LOG_ZERO_F : pxy + T5(tb, 1, 0);
            if (i < lx && M(bx1.data(), i + 1, j) != LOG_ZERO_F)
                log_plus_equals(v, M(bx1.data(), i + 1, j)
                                + tb.lins[xn * 2 + 0] + T5(tb, 1, 1));
            M(bx1.data(), i, j) = v;
            v = pxy == LOG_ZERO_F ? LOG_ZERO_F : pxy + T5(tb, 3, 0);
            if (i < lx && M(bx2.data(), i + 1, j) != LOG_ZERO_F)
                log_plus_equals(v, M(bx2.data(), i + 1, j)
                                + tb.lins[xn * 2 + 1] + T5(tb, 3, 3));
            M(bx2.data(), i, j) = v;
            v = pxy == LOG_ZERO_F ? LOG_ZERO_F : pxy + T5(tb, 2, 0);
            if (j < ly && M(by1.data(), i, j + 1) != LOG_ZERO_F)
                log_plus_equals(v, M(by1.data(), i, j + 1)
                                + tb.lins[yn * 2 + 0] + T5(tb, 2, 2));
            M(by1.data(), i, j) = v;
            v = pxy == LOG_ZERO_F ? LOG_ZERO_F : pxy + T5(tb, 4, 0);
            if (j < ly && M(by2.data(), i, j + 1) != LOG_ZERO_F)
                log_plus_equals(v, M(by2.data(), i, j + 1)
                                + tb.lins[yn * 2 + 1] + T5(tb, 4, 4));
            M(by2.data(), i, j) = v;
        }
    }
    // backward total re-assembled at the start cells
    float tbtot = tb.init[0] + tb.lmatch[x[0] * 21 + y[0]] + M(bM, 1, 1);
    log_plus_equals(tbtot, tb.init[1] + tb.lins[x[0] * 2 + 0]
                    + M(bx1.data(), 1, 0));
    log_plus_equals(tbtot, tb.init[2] + tb.lins[y[0] * 2 + 0]
                    + M(by1.data(), 0, 1));
    log_plus_equals(tbtot, tb.init[3] + tb.lins[x[0] * 2 + 1]
                    + M(bx2.data(), 1, 0));
    log_plus_equals(tbtot, tb.init[4] + tb.lins[y[0] * 2 + 1]
                    + M(by2.data(), 0, 1));
    *total = 0.5f * (tf + tbtot);
}

// ------------------------------------------------------------------ local
// 3-state local model in odds space (flanking random states); mirror of
// ops/qpx.local_posterior_qpx (ProbabilisticModel.h flag=false).

struct LocalTables {
    const float *trans;   // (3,3)
    const float *lmatch;  // (21,21)
    const float *lins;    // (21,)
    float log_stay;       // random_transProb[1]
};

void local_fb(const int8_t *x, const int8_t *y, int lx, int ly,
              const LocalTables &tb, float *fM, float *bM,
              float *total) {
    const int W = ly + 1;
    const size_t plane = (size_t)(lx + 1) * W;
    const float rt1 = tb.log_stay;
    auto T3 = [&](int a, int b) { return tb.trans[a * 3 + b]; };
    auto emx = [&](int i, int j) {  // em'(i, j), 1-indexed residues
        const int xc = x[i - 1], yc = y[j - 1];
        return tb.lmatch[xc * 21 + yc] - tb.lins[xc] - tb.lins[yc]
               - 2.0f * rt1;
    };
    std::vector<float> fx(plane, LOG_ZERO_F), fy(plane, LOG_ZERO_F);
    auto M = [&](float *p, int i, int j) -> float & {
        return p[(size_t)i * W + j];
    };
    for (size_t k = 0; k < plane; ++k) fM[k] = LOG_ZERO_F;

    for (int i = 0; i <= lx; ++i) {
        for (int j = 0; j <= ly; ++j) {
            if (i >= 1 && j >= 1) {
                const float em = emx(i, j);
                float acc = em;      // start anywhere (odds 1)
                if (M(fM, i - 1, j - 1) != LOG_ZERO_F)
                    log_plus_equals(
                        acc, em + M(fM, i - 1, j - 1) + T3(0, 0));
                if (M(fx.data(), i - 1, j - 1) != LOG_ZERO_F)
                    log_plus_equals(
                        acc, em + M(fx.data(), i - 1, j - 1) + T3(1, 0));
                if (M(fy.data(), i - 1, j - 1) != LOG_ZERO_F)
                    log_plus_equals(
                        acc, em + M(fy.data(), i - 1, j - 1) + T3(2, 0));
                M(fM, i, j) = acc;
            }
            if (i >= 1) {
                float a = LOG_ZERO_F;
                if (M(fM, i - 1, j) != LOG_ZERO_F)
                    a = M(fM, i - 1, j) + T3(0, 1) - rt1;
                if (M(fx.data(), i - 1, j) != LOG_ZERO_F)
                    log_plus_equals(
                        a, M(fx.data(), i - 1, j) + T3(1, 1) - rt1);
                M(fx.data(), i, j) = a;
            }
            if (j >= 1) {
                float a = LOG_ZERO_F;
                if (M(fM, i, j - 1) != LOG_ZERO_F)
                    a = M(fM, i, j - 1) + T3(0, 2) - rt1;
                if (M(fy.data(), i, j - 1) != LOG_ZERO_F)
                    log_plus_equals(
                        a, M(fy.data(), i, j - 1) + T3(2, 2) - rt1);
                M(fy.data(), i, j) = a;
            }
        }
    }
    // exact stable LSE over interior cells (see qpx docstring)
    double mx = -1e300;
    for (int i = 1; i <= lx; ++i)
        for (int j = 1; j <= ly; ++j)
            if (M(fM, i, j) > mx) mx = M(fM, i, j);
    double s = 0.0;
    for (int i = 1; i <= lx; ++i)
        for (int j = 1; j <= ly; ++j)
            s += std::exp((double)M(fM, i, j) - mx);
    const float total_f = (float)(mx + std::log(s));

    std::vector<float> bx(plane, LOG_ZERO_F), by(plane, LOG_ZERO_F);
    for (size_t k = 0; k < plane; ++k) bM[k] = LOG_ZERO_F;
    for (int i = lx; i >= 0; --i) {
        for (int j = ly; j >= 0; --j) {
            float pxy = LOG_ZERO_F;
            if (i < lx && j < ly && M(bM, i + 1, j + 1) != LOG_ZERO_F)
                pxy = M(bM, i + 1, j + 1) + emx(i + 1, j + 1);
            float b0 = 0.0f;  // LOG_ONE: end anywhere
            if (pxy != LOG_ZERO_F)
                log_plus_equals(b0, pxy + T3(0, 0));
            if (i < lx && M(bx.data(), i + 1, j) != LOG_ZERO_F)
                log_plus_equals(
                    b0, M(bx.data(), i + 1, j) + T3(0, 1) - rt1);
            if (j < ly && M(by.data(), i, j + 1) != LOG_ZERO_F)
                log_plus_equals(
                    b0, M(by.data(), i, j + 1) + T3(0, 2) - rt1);
            M(bM, i, j) = b0;
            float vx = pxy == LOG_ZERO_F ? LOG_ZERO_F : pxy + T3(1, 0);
            if (i < lx && M(bx.data(), i + 1, j) != LOG_ZERO_F)
                log_plus_equals(
                    vx, M(bx.data(), i + 1, j) + T3(1, 1) - rt1);
            M(bx.data(), i, j) = vx;
            float vy = pxy == LOG_ZERO_F ? LOG_ZERO_F : pxy + T3(2, 0);
            if (j < ly && M(by.data(), i, j + 1) != LOG_ZERO_F)
                log_plus_equals(
                    vy, M(by.data(), i, j + 1) + T3(2, 2) - rt1);
            M(by.data(), i, j) = vy;
        }
    }
    mx = -1e300;
    for (int i = 1; i <= lx; ++i)
        for (int j = 1; j <= ly; ++j) {
            const double t = (double)M(bM, i, j) + emx(i, j);
            if (t > mx) mx = t;
        }
    s = 0.0;
    for (int i = 1; i <= lx; ++i)
        for (int j = 1; j <= ly; ++j)
            s += std::exp((double)M(bM, i, j) + emx(i, j) - mx);
    const float total_b = (float)(mx + std::log(s));
    *total = 0.5f * (total_f + total_b);
}

// -------------------------------------------------------------- partition
// Probalign partition function in PROBABILITY space (the reference
// computes long double, MSAPartProbs.cpp:400-660; QuickProbs double
// with useDoublePartition=true).  Free terminal gaps.  Writes the
// forward Zm plane; the caller runs it twice (reversed sequences) and
// combines p = Zm_f * Zm_r / (score * Z)  (revers_partf role).

struct PartTables {
    const float *lscore;  // (21,21) log (= beta * score matrix)
    float lgo, lge;       // log gap open / extend
};

typedef long double pfloat;  // MSAPartProbs.cpp computes long double

void partition_forward(const int8_t *x, const int8_t *y, int lx, int ly,
                       const PartTables &tb, pfloat *zm, pfloat *ztot) {
    const int W = ly + 1;
    const pfloat go = expl((pfloat)tb.lgo);
    const pfloat ge = expl((pfloat)tb.lge);
    std::vector<pfloat> ze_p(W), zf_p(W), ze(W), zf(W), zm_p(W);
    auto M = [&](pfloat *p, int i, int j) -> pfloat & {
        return p[(size_t)i * W + j];
    };
    // row 0: zm(0,0)=1; ze(0,j>=1)=1 (free leading gap in x); zf=0
    for (int j = 0; j <= ly; ++j) {
        M(zm, 0, j) = j == 0 ? 1.0 : 0.0;
        ze_p[j] = j >= 1 ? 1.0 : 0.0;
        zf_p[j] = 0.0;
        zm_p[j] = M(zm, 0, j);
    }
    for (int i = 1; i <= lx; ++i) {
        const bool at_end = i == lx;
        const int xc = x[i - 1];
        for (int j = 0; j <= ly; ++j) {
            // Zf consumes x: free at j==0 / j==ly (terminal gap in y)
            const pfloat gof = (j == 0 || j == ly) ? 1.0 : go;
            const pfloat gef = (j == 0 || j == ly) ? 1.0 : ge;
            zf[j] = zm_p[j] * gof + zf_p[j] * gef;
            if (j == 0) zf[j] = 1.0;  // free leading gap in y
            // Zm from any state at (i-1, j-1)
            if (j >= 1) {
                const int yc = y[j - 1];
                const pfloat sc =
                    expl((pfloat)tb.lscore[xc * 21 + yc]);
                M(zm, i, j) =
                    sc * (zm_p[j - 1] + ze_p[j - 1] + zf_p[j - 1]);
            } else {
                M(zm, i, j) = 0.0;
            }
            // Ze consumes y: within-row; free when x exhausted
            const pfloat goe = at_end ? 1.0 : go;
            const pfloat gee = at_end ? 1.0 : ge;
            ze[j] = j == 0 ? 0.0
                           : M(zm, i, j - 1) * goe + ze[j - 1] * gee;
        }
        std::swap(ze_p, ze);
        std::swap(zf_p, zf);
        for (int j = 0; j <= ly; ++j) zm_p[j] = M(zm, i, j);
    }
    *ztot = M(zm, lx, ly) + ze_p[ly] + zf_p[ly];
}

void partition_posterior_native(const int8_t *x, const int8_t *y,
                                int lx, int ly, const PartTables &tb,
                                bool window, float *post /*(lx+1)*(ly+1)*/) {
    const int W = ly + 1;
    const size_t plane = (size_t)(lx + 1) * W;
    std::vector<pfloat> zf(plane), zr(plane);
    pfloat ztot, zdummy;
    partition_forward(x, y, lx, ly, tb, zf.data(), &ztot);
    std::vector<int8_t> xr(lx), yr(ly);
    for (int i = 0; i < lx; ++i) xr[i] = x[lx - 1 - i];
    for (int j = 0; j < ly; ++j) yr[j] = y[ly - 1 - j];
    partition_forward(xr.data(), yr.data(), lx, ly, tb, zr.data(),
                      &zdummy);
    for (size_t k = 0; k < plane; ++k) post[k] = 0.0f;
    for (int i = 1; i <= lx; ++i) {
        for (int j = 1; j <= ly; ++j) {
            const pfloat sc = expl(
                (pfloat)tb.lscore[x[i - 1] * 21 + y[j - 1]]);
            pfloat p = zf[(size_t)i * W + j]
                       * zr[(size_t)(lx - i + 1) * W + (ly - j + 1)]
                       / (sc * ztot);
            if (p > 1.0) p = 1.0;
            if (window && (p < 0.001 || p > 1.0)) p = 0.0;
            post[(size_t)i * W + j] = (float)p;
        }
    }
}

// ---------------------------------------------------------------- SIMD
// 16-lane batched pair-HMM forward/backward: the same per-cell op
// order as the scalar engines above, but each vector lane carries one
// PAIR (the CPU twin of the device wave batching,
// QuickPosteriorStage.cpp:107-135).  GCC vector extensions compile to
// AVX-512 on this host (16 f32 lanes); per-lane (lx, ly) masks follow
// ops/qpx.py's padded-batch semantics: out-of-range forward cells hold
// garbage no in-range cell reads, backward consumption is guarded by
// per-lane masks, and totals are read at each lane's terminal cell.

typedef float v16 __attribute__((vector_size(64)));
typedef int32_t m16 __attribute__((vector_size(64)));

constexpr int VL = 16;

static inline v16 vbc(float x) {
    v16 r;
    for (int k = 0; k < VL; ++k) r[k] = x;
    return r;
}

template <bool R>
static inline v16 vpoly3(v16 x, float a, float b, float c, float d) {
    return poly3<R>(x, vbc(a), vbc(b), vbc(c), vbc(d));
}

template <bool R = false>
static inline v16 vlookup(v16 x) {
    const v16 p1 = vpoly3<R>(x, -0.009350833524763f, 0.130659527668286f,
                          0.498799810682272f, 0.693203116424741f);
    const v16 p2 = vpoly3<R>(x, -0.014532321752540f, 0.139942324101744f,
                          0.495635523139337f, 0.692140569840976f);
    const v16 p3 = vpoly3<R>(x, -0.004605031767994f, 0.063427417320019f,
                          0.695956496475118f, 0.514272634594009f);
    const v16 p4 = vpoly3<R>(x, -0.000458661602210f, 0.009695946122598f,
                          0.930734667215156f, 0.168037164329057f);
    return (x <= vbc(1.0f)) ? p1
           : (x <= vbc(2.5f)) ? p2
           : (x <= vbc(4.5f)) ? p3 : p4;
}

template <bool R = false>
static inline v16 vlog_add(v16 x, v16 y) {
    const m16 xg = x > y;
    const v16 hi = xg ? x : y;
    const v16 lo = xg ? y : x;
    const v16 d = hi - lo;
    const m16 absorb =
        (lo == vbc(LOG_ZERO_F)) | (d >= vbc(LOG_UNDERFLOW));
    return absorb ? hi : (vlookup<R>(d) + lo);
}

template <bool R>
static inline v16 vpoly4(v16 x, float a, float b, float c, float d,
                         float e) {
    return poly4<R>(x, vbc(a), vbc(b), vbc(c), vbc(d), vbc(e));
}

template <bool R = false>
static inline v16 vexp_ref(v16 x) {
    // branch-polynomial EXP for x <= 0 (callers clamp); 0 below -16
    const v16 m05 = vpoly4<R>(x, 0.03254409303190190000f,
                           0.16280432765779600000f,
                           0.49929760485974900000f,
                           0.99995149601363700000f,
                           0.99999925508501600000f);
    const v16 m1 = vpoly4<R>(x, 0.01973899026052090000f,
                          0.13822379685007000000f,
                          0.48056651562365000000f,
                          0.99326940370383500000f,
                          0.99906756856399500000f);
    const v16 m2 = vpoly4<R>(x, 0.00940528203591384000f,
                          0.09414963667859410000f,
                          0.40825793595877300000f,
                          0.93933625499130400000f,
                          0.98369508190545300000f);
    const v16 m4 = vpoly4<R>(x, 0.00217245711583303000f,
                          0.03484829428350620000f,
                          0.22118199801337800000f,
                          0.67049462206469500000f,
                          0.83556950223398500000f);
    const v16 m8 = vpoly4<R>(x, 0.00012398771025456900f,
                          0.00349155785951272000f,
                          0.03727721426017900000f,
                          0.17974997741536900000f,
                          0.33249299994217400000f);
    const v16 m16v = vpoly4<R>(x, 0.00000051741713416603f,
                            0.00002721456879608080f,
                            0.00053418601865636800f,
                            0.00464101989351936000f,
                            0.01507447981459420000f);
    return (x > vbc(-0.5f)) ? m05
           : (x > vbc(-1.0f)) ? m1
           : (x > vbc(-2.0f)) ? m2
           : (x > vbc(-4.0f)) ? m4
           : (x > vbc(-8.0f)) ? m8
           : (x > vbc(-16.0f)) ? m16v : vbc(0.0f);
}

// Residue class of lane k at 1-indexed position i (PAD=20 beyond).
static inline int lane_char(const int8_t *s, int len, int i) {
    return (i >= 1 && i <= len) ? s[i - 1] : 20;
}

// 16-lane hmm5 forward/backward.  fM/bM are (LX+1)*(LY+1) v16 planes;
// totals[k] = (tf_k + tb_k) / 2.
template <bool R>
void hmm5_fb_batch(const int8_t *const *xs, const int8_t *const *ys,
                   const int *lxs, const int *lys, int lanes,
                   int LX, int LY, const Hmm5Tables &tb,
                   v16 *fM, v16 *bM, float *totals) {
    const int W = LY + 1;
    const v16 LZ = vbc(LOG_ZERO_F);
    std::vector<v16> x1p(W, LZ), y1p(W, LZ), x2p(W, LZ), y2p(W, LZ);
    std::vector<v16> x1c(W), y1c(W), x2c(W), y2c(W), mp(W, LZ), mc(W);
    // per-j y-character tables
    std::vector<v16> emy0(W), emy1(W);
    std::vector<int> ycs((size_t)W * VL);
    for (int j = 0; j <= LY; ++j)
        for (int k = 0; k < VL; ++k) {
            const int yc = k < lanes ? lane_char(ys[k], lys[k], j) : 20;
            ycs[(size_t)j * VL + k] = yc;
            emy0[j][k] = tb.lins[yc * 2 + 0];
            emy1[j][k] = tb.lins[yc * 2 + 1];
        }
    std::vector<float> tf(VL, LOG_ZERO_F);

    // ---- forward ----
    for (int i = 0; i <= LX; ++i) {
        v16 emx0, emx1;
        std::vector<int> xcs(VL);
        for (int k = 0; k < VL; ++k) {
            const int xc = k < lanes ? lane_char(xs[k], lxs[k], i) : 20;
            xcs[k] = xc;
            emx0[k] = tb.lins[xc * 2 + 0];
            emx1[k] = tb.lins[xc * 2 + 1];
        }
        for (int j = 0; j <= LY; ++j) {
            v16 M = LZ, X1 = LZ, Y1 = LZ, X2 = LZ, Y2 = LZ;
            if (i >= 1 && j >= 1) {
                v16 em;
                for (int k = 0; k < VL; ++k)
                    em[k] = tb.lmatch[xcs[k] * 21
                                      + ycs[(size_t)j * VL + k]];
                if (i == 1 && j == 1) {
                    M = vbc(tb.init[0]) + em;
                } else {
                    v16 acc = mp[j - 1] + vbc(T5(tb, 0, 0));
                    acc = (acc > vbc(LOG_ZERO_F / 2)) ? acc : LZ;
                    acc = vlog_add<R>(acc, (x1p[j - 1] == LZ) ? LZ
                                   : x1p[j - 1] + vbc(T5(tb, 1, 0)));
                    acc = vlog_add<R>(acc, (y1p[j - 1] == LZ) ? LZ
                                   : y1p[j - 1] + vbc(T5(tb, 2, 0)));
                    acc = vlog_add<R>(acc, (x2p[j - 1] == LZ) ? LZ
                                   : x2p[j - 1] + vbc(T5(tb, 3, 0)));
                    acc = vlog_add<R>(acc, (y2p[j - 1] == LZ) ? LZ
                                   : y2p[j - 1] + vbc(T5(tb, 4, 0)));
                    M = acc + em;
                }
            }
            if (i >= 1) {
                if (i == 1 && j == 0) {
                    X1 = vbc(tb.init[1]) + emx0;
                    X2 = vbc(tb.init[3]) + emx1;
                } else {
                    v16 a = (mp[j] == LZ) ? LZ
                            : mp[j] + vbc(T5(tb, 0, 1));
                    a = vlog_add<R>(a, (x1p[j] == LZ) ? LZ
                                 : x1p[j] + vbc(T5(tb, 1, 1)));
                    X1 = emx0 + a;
                    v16 b = (mp[j] == LZ) ? LZ
                            : mp[j] + vbc(T5(tb, 0, 3));
                    b = vlog_add<R>(b, (x2p[j] == LZ) ? LZ
                                 : x2p[j] + vbc(T5(tb, 3, 3)));
                    X2 = emx1 + b;
                }
            }
            if (j >= 1) {
                if (i == 0 && j == 1) {
                    Y1 = vbc(tb.init[2]) + emy0[1];
                    Y2 = vbc(tb.init[4]) + emy1[1];
                } else {
                    v16 a = (mc[j - 1] == LZ) ? LZ
                            : mc[j - 1] + vbc(T5(tb, 0, 2));
                    a = vlog_add<R>(a, (y1c[j - 1] == LZ) ? LZ
                                 : y1c[j - 1] + vbc(T5(tb, 2, 2)));
                    Y1 = emy0[j] + a;
                    v16 b = (mc[j - 1] == LZ) ? LZ
                            : mc[j - 1] + vbc(T5(tb, 0, 4));
                    b = vlog_add<R>(b, (y2c[j - 1] == LZ) ? LZ
                                 : y2c[j - 1] + vbc(T5(tb, 4, 4)));
                    Y2 = emy1[j] + b;
                }
            }
            mc[j] = M;
            x1c[j] = X1;
            y1c[j] = Y1;
            x2c[j] = X2;
            y2c[j] = Y2;
            fM[(size_t)i * W + j] = M;
        }
        // forward total capture at per-lane terminal rows
        for (int k = 0; k < lanes; ++k) {
            if (lxs[k] != i) continue;
            const int jt = lys[k];
            float t = LOG_ZERO_F;
            const float st[5] = {mc[jt][k], x1c[jt][k], y1c[jt][k],
                                 x2c[jt][k], y2c[jt][k]};
            const int order[5] = {0, 1, 2, 3, 4};
            for (int q = 0; q < 5; ++q)
                if (st[order[q]] != LOG_ZERO_F)
                    log_plus_equals<R>(t, st[order[q]] + tb.init[order[q]]);
            tf[k] = t;
        }
        std::swap(mp, mc);
        std::swap(x1p, x1c);
        std::swap(y1p, y1c);
        std::swap(x2p, x2c);
        std::swap(y2p, y2c);
    }

    // ---- backward ----
    v16 lxv, lyv;
    for (int k = 0; k < VL; ++k) {
        lxv[k] = k < lanes ? (float)lxs[k] : 0.0f;
        lyv[k] = k < lanes ? (float)lys[k] : 0.0f;
    }
    std::vector<v16> nx1(W, LZ), ny1(W, LZ), nx2(W, LZ), ny2(W, LZ);
    std::vector<v16> cx1(W), cy1(W), cx2(W), cy2(W), nm(W, LZ), cm(W);
    float bx1_10[VL], bx2_10[VL], by1_01[VL], by2_01[VL], bm_11[VL];
    for (int i = LX; i >= 0; --i) {
        v16 in0, in1;   // insert emissions of x_{i+1} per lane
        std::vector<int> xns(VL);
        for (int k = 0; k < VL; ++k) {
            const int xn = k < lanes ? lane_char(xs[k], lxs[k], i + 1)
                                     : 20;
            xns[k] = xn;
            in0[k] = tb.lins[xn * 2 + 0];
            in1[k] = tb.lins[xn * 2 + 1];
        }
        const m16 mask_i = vbc((float)i) < lxv;
        for (int j = LY; j >= 0; --j) {
            const m16 mask_j = vbc((float)j) < lyv;
            const m16 mm = mask_i & mask_j;
            v16 emn;
            for (int k = 0; k < VL; ++k)
                emn[k] = tb.lmatch[xns[k] * 21
                                   + ycs[(size_t)std::min(j + 1, LY)
                                         * VL + k]];
            // j+1 > LY means no lane has mask_j there; emn is masked
            const v16 nm11 = (j + 1 <= LY)
                ? nm[j + 1] : vbc(LOG_ZERO_F);
            v16 pxy = (mm & (nm11 != LZ))
                ? nm11 + emn : LZ;
            // M: order M, X1, X2, Y1, Y2
            v16 acc = (pxy == LZ) ? LZ : pxy + vbc(T5(tb, 0, 0));
            acc = vlog_add<R>(acc, (mask_i & (nx1[j] != LZ))
                           ? nx1[j] + in0 + vbc(T5(tb, 0, 1)) : LZ);
            acc = vlog_add<R>(acc, (mask_i & (nx2[j] != LZ))
                           ? nx2[j] + in1 + vbc(T5(tb, 0, 3)) : LZ);
            const v16 cy1n = (j + 1 <= LY) ? cy1[j + 1] : LZ;
            const v16 cy2n = (j + 1 <= LY) ? cy2[j + 1] : LZ;
            const v16 iny0 = (j + 1 <= LY) ? emy0[j + 1] : LZ;
            const v16 iny1 = (j + 1 <= LY) ? emy1[j + 1] : LZ;
            acc = vlog_add<R>(acc, (mask_j & (cy1n != LZ))
                           ? cy1n + iny0 + vbc(T5(tb, 0, 2)) : LZ);
            acc = vlog_add<R>(acc, (mask_j & (cy2n != LZ))
                           ? cy2n + iny1 + vbc(T5(tb, 0, 4)) : LZ);
            v16 M = acc;
            v16 X1 = vlog_add<R>(
                (pxy == LZ) ? LZ : pxy + vbc(T5(tb, 1, 0)),
                (mask_i & (nx1[j] != LZ))
                    ? nx1[j] + in0 + vbc(T5(tb, 1, 1)) : LZ);
            v16 X2 = vlog_add<R>(
                (pxy == LZ) ? LZ : pxy + vbc(T5(tb, 3, 0)),
                (mask_i & (nx2[j] != LZ))
                    ? nx2[j] + in1 + vbc(T5(tb, 3, 3)) : LZ);
            v16 Y1 = vlog_add<R>(
                (pxy == LZ) ? LZ : pxy + vbc(T5(tb, 2, 0)),
                (mask_j & (cy1n != LZ))
                    ? cy1n + iny0 + vbc(T5(tb, 2, 2)) : LZ);
            v16 Y2 = vlog_add<R>(
                (pxy == LZ) ? LZ : pxy + vbc(T5(tb, 4, 0)),
                (mask_j & (cy2n != LZ))
                    ? cy2n + iny1 + vbc(T5(tb, 4, 4)) : LZ);
            // per-lane terminal cell: the initial distribution
            for (int k = 0; k < lanes; ++k) {
                if (lxs[k] == i && lys[k] == j) {
                    M[k] = tb.init[0];
                    X1[k] = tb.init[1];
                    Y1[k] = tb.init[2];
                    X2[k] = tb.init[3];
                    Y2[k] = tb.init[4];
                }
            }
            cm[j] = M;
            cx1[j] = X1;
            cy1[j] = Y1;
            cx2[j] = X2;
            cy2[j] = Y2;
            bM[(size_t)i * W + j] = M;
        }
        if (i == 1) {
            for (int k = 0; k < VL; ++k) {
                bx1_10[k] = cx1[0][k];
                bx2_10[k] = cx2[0][k];
                bm_11[k] = LY >= 1 ? cm[1][k] : LOG_ZERO_F;
            }
        }
        if (i == 0) {
            for (int k = 0; k < VL; ++k) {
                by1_01[k] = LY >= 1 ? cy1[1][k] : LOG_ZERO_F;
                by2_01[k] = LY >= 1 ? cy2[1][k] : LOG_ZERO_F;
            }
        }
        std::swap(nm, cm);
        std::swap(nx1, cx1);
        std::swap(ny1, cy1);
        std::swap(nx2, cx2);
        std::swap(ny2, cy2);
    }
    for (int k = 0; k < lanes; ++k) {
        const int x0 = xs[k][0], y0 = ys[k][0];
        float tbt = tb.init[0] + tb.lmatch[x0 * 21 + y0] + bm_11[k];
        log_plus_equals<R>(tbt, tb.init[1] + tb.lins[x0 * 2 + 0]
                        + bx1_10[k]);
        log_plus_equals<R>(tbt, tb.init[2] + tb.lins[y0 * 2 + 0]
                        + by1_01[k]);
        log_plus_equals<R>(tbt, tb.init[3] + tb.lins[x0 * 2 + 1]
                        + bx2_10[k]);
        log_plus_equals<R>(tbt, tb.init[4] + tb.lins[y0 * 2 + 1]
                        + by2_01[k]);
        totals[k] = 0.5f * (tf[k] + tbt);
    }
}

// 16-lane local-model forward/backward (odds space).  Totals per lane
// use the exact double-precision LSE over the lane's interior cells —
// the same deviation from op-order fidelity as the scalar engine.
void local_fb_batch(const int8_t *const *xs, const int8_t *const *ys,
                    const int *lxs, const int *lys, int lanes,
                    int LX, int LY, const LocalTables &tb,
                    v16 *fM, v16 *bM, float *totals) {
    const int W = LY + 1;
    const v16 LZ = vbc(LOG_ZERO_F);
    const float rt1 = tb.log_stay;
    auto T3 = [&](int a, int b) { return tb.trans[a * 3 + b]; };
    std::vector<int> ycs((size_t)W * VL);
    std::vector<v16> liny(W);
    for (int j = 0; j <= LY; ++j)
        for (int k = 0; k < VL; ++k) {
            const int yc = k < lanes ? lane_char(ys[k], lys[k], j) : 20;
            ycs[(size_t)j * VL + k] = yc;
            liny[j][k] = tb.lins[yc];
        }
    // em'(i, j) rows are rebuilt per i below
    std::vector<v16> xp(W, LZ), yp(W, LZ), mp(W, LZ);
    std::vector<v16> xc(W), yc_(W), mc(W);

    for (int i = 0; i <= LX; ++i) {
        std::vector<int> xcs(VL);
        v16 linx;
        for (int k = 0; k < VL; ++k) {
            const int c = k < lanes ? lane_char(xs[k], lxs[k], i) : 20;
            xcs[k] = c;
            linx[k] = tb.lins[c];
        }
        for (int j = 0; j <= LY; ++j) {
            v16 M = LZ, X = LZ, Y = LZ;
            if (i >= 1 && j >= 1) {
                v16 em;
                for (int k = 0; k < VL; ++k)
                    em[k] = tb.lmatch[xcs[k] * 21
                                      + ycs[(size_t)j * VL + k]]
                            - linx[k] - liny[j][k] - 2.0f * rt1;
                v16 acc = em;
                acc = vlog_add(acc, (mp[j - 1] == LZ) ? LZ
                               : em + mp[j - 1] + vbc(T3(0, 0)));
                acc = vlog_add(acc, (xp[j - 1] == LZ) ? LZ
                               : em + xp[j - 1] + vbc(T3(1, 0)));
                acc = vlog_add(acc, (yp[j - 1] == LZ) ? LZ
                               : em + yp[j - 1] + vbc(T3(2, 0)));
                M = acc;
            }
            if (i >= 1) {
                v16 a = (mp[j] == LZ) ? LZ
                        : mp[j] + vbc(T3(0, 1) - rt1);
                X = vlog_add(a, (xp[j] == LZ) ? LZ
                             : xp[j] + vbc(T3(1, 1) - rt1));
            }
            if (j >= 1) {
                v16 a = (mc[j - 1] == LZ) ? LZ
                        : mc[j - 1] + vbc(T3(0, 2) - rt1);
                Y = vlog_add(a, (yc_[j - 1] == LZ) ? LZ
                             : yc_[j - 1] + vbc(T3(2, 2) - rt1));
            }
            mc[j] = M;
            xc[j] = X;
            yc_[j] = Y;
            fM[(size_t)i * W + j] = M;
        }
        std::swap(mp, mc);
        std::swap(xp, xc);
        std::swap(yp, yc_);
    }

    // backward
    v16 lxv, lyv;
    for (int k = 0; k < VL; ++k) {
        lxv[k] = k < lanes ? (float)lxs[k] : 0.0f;
        lyv[k] = k < lanes ? (float)lys[k] : 0.0f;
    }
    std::vector<v16> nx(W, LZ), ny(W, LZ), nm(W, LZ);
    std::vector<v16> cx(W), cy(W), cm(W);
    for (int i = LX; i >= 0; --i) {
        std::vector<int> xns(VL);
        v16 linxn;
        for (int k = 0; k < VL; ++k) {
            const int c = k < lanes ? lane_char(xs[k], lxs[k], i + 1)
                                    : 20;
            xns[k] = c;
            linxn[k] = tb.lins[c];
        }
        const m16 mask_i = vbc((float)i) < lxv;
        for (int j = LY; j >= 0; --j) {
            const m16 mask_j = vbc((float)j) < lyv;
            const m16 mm = mask_i & mask_j;
            v16 emn;
            for (int k = 0; k < VL; ++k) {
                const int yn = ycs[(size_t)std::min(j + 1, LY) * VL + k];
                emn[k] = tb.lmatch[xns[k] * 21 + yn] - linxn[k]
                         - tb.lins[yn] - 2.0f * rt1;
            }
            const v16 nm11 = (j + 1 <= LY) ? nm[j + 1] : LZ;
            const v16 pxy = (mm & (nm11 != LZ)) ? nm11 + emn : LZ;
            v16 b0 = vbc(0.0f);   // LOG_ONE: end anywhere
            b0 = vlog_add(b0, (pxy == LZ) ? LZ : pxy + vbc(T3(0, 0)));
            b0 = vlog_add(b0, (mask_i & (nx[j] != LZ))
                          ? nx[j] + vbc(T3(0, 1) - rt1) : LZ);
            const v16 cyn = (j + 1 <= LY) ? cy[j + 1] : LZ;
            b0 = vlog_add(b0, (mask_j & (cyn != LZ))
                          ? cyn + vbc(T3(0, 2) - rt1) : LZ);
            v16 X = vlog_add(
                (pxy == LZ) ? LZ : pxy + vbc(T3(1, 0)),
                (mask_i & (nx[j] != LZ))
                    ? nx[j] + vbc(T3(1, 1) - rt1) : LZ);
            v16 Y = vlog_add(
                (pxy == LZ) ? LZ : pxy + vbc(T3(2, 0)),
                (mask_j & (cyn != LZ))
                    ? cyn + vbc(T3(2, 2) - rt1) : LZ);
            // valid = i <= lx && j <= ly
            const m16 valid = (vbc((float)i) <= lxv)
                              & (vbc((float)j) <= lyv);
            b0 = valid ? b0 : LZ;
            cm[j] = b0;
            cx[j] = valid ? X : LZ;
            cy[j] = valid ? Y : LZ;
            bM[(size_t)i * W + j] = b0;
        }
        std::swap(nm, cm);
        std::swap(nx, cx);
        std::swap(ny, cy);
    }

    // per-lane exact LSE totals over interior cells (double precision)
    for (int k = 0; k < lanes; ++k) {
        const int lx = lxs[k], ly = lys[k];
        double mx = -1e300;
        for (int i = 1; i <= lx; ++i)
            for (int j = 1; j <= ly; ++j) {
                const double v = fM[(size_t)i * W + j][k];
                if (v > mx) mx = v;
            }
        double s = 0.0;
        for (int i = 1; i <= lx; ++i)
            for (int j = 1; j <= ly; ++j)
                s += std::exp((double)fM[(size_t)i * W + j][k] - mx);
        const float total_f = (float)(mx + std::log(s));
        auto emx = [&](int i, int j) {
            const int a = xs[k][i - 1], b = ys[k][j - 1];
            return tb.lmatch[a * 21 + b] - tb.lins[a] - tb.lins[b]
                   - 2.0f * rt1;
        };
        mx = -1e300;
        for (int i = 1; i <= lx; ++i)
            for (int j = 1; j <= ly; ++j) {
                const double v = (double)bM[(size_t)i * W + j][k]
                                 + emx(i, j);
                if (v > mx) mx = v;
            }
        s = 0.0;
        for (int i = 1; i <= lx; ++i)
            for (int j = 1; j <= ly; ++j)
                s += std::exp((double)bM[(size_t)i * W + j][k]
                              + emx(i, j) - mx);
        const float total_b = (float)(mx + std::log(s));
        totals[k] = 0.5f * (total_f + total_b);
    }
}

// ------------------------------------------------------------------ MWT
// Maximum-expected-accuracy DP over a 0-indexed-interior posterior
// plane laid out (lx+1)*(ly+1) with p(i, j) at [i*W + j] (1-indexed).
// ChooseBestOfThree tie order: diagonal >= left >= up
// (ProbabilisticModel.h:804-864, ScoreType.h:347-366).

float mwt_fill(const float *post, int lx, int ly, int8_t *dirs) {
    const int W = ly + 1;
    std::vector<float> s_prev(W, 0.0f), s(W);
    for (int j = 0; j <= ly; ++j) dirs[j] = 1;  // row 0: left
    for (int i = 1; i <= lx; ++i) {
        s[0] = 0.0f;
        dirs[(size_t)i * W] = 2;                // column 0: up
        for (int j = 1; j <= ly; ++j) {
            const float pd = post[(size_t)i * W + j] + s_prev[j - 1];
            const float left = s[j - 1];
            const float up = s_prev[j];
            if (pd >= left && pd >= up) {
                s[j] = pd;
                dirs[(size_t)i * W + j] = 0;
            } else if (left >= up) {
                s[j] = left;
                dirs[(size_t)i * W + j] = 1;
            } else {
                s[j] = up;
                dirs[(size_t)i * W + j] = 2;
            }
        }
        std::swap(s_prev, s);
    }
    return s_prev[ly];
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Probabilistic-consistency relaxation over sparse posteriors.
//
// The reference's hottest host transform (MSA::DoRelaxation,
// MSA.cpp:1172-1360; QuickProbs ConsistencyStage.cpp:133-334): for each
// aligned pair (i, j),
//
//   R_ij = self_coef[p] * P_ij + z_scale[p] * sum_z w_eff[p,z] P_iz P_zj
//
// masked to the original support of P_ij and thresholded at `cutoff`
// (support never grows, so outputs reuse the input index structure).
// self_coef / z_scale / w_eff encode both variants: the plain baseMSA
// transform (self=2/N, scale=1/N, w=1 for z != i,j) and the QuickProbs
// weighted one (self=1/sumW, scale=1/(Wij*sumW), w_z = ClustalW weight,
// zeroed for z rejected by the stochastic selectivity filter).
//
// Cell storage: all ordered cells (i, j), i != j, as CSR over a shared
// pool; cell c = i*n + j has indptr at indptr_pool + cell_ptr[c]
// (lengths[i] + 1 entries) and indices/data at indices_pool/data_pool +
// cell_dat[c].  Lower cells hold precomputed transposes.  Results are
// written to out_data at the same offsets as the upper pair's data.
//
// Parallelism: OpenMP dynamic over pairs — the exact analogue of the
// reference's `#pragma omp parallel for schedule(dynamic)` pair loops.
// A per-thread epoch-stamped dense scratch row avoids per-row memsets.
// `reps` rounds run entirely in native code: zeroed entries stay
// structurally present between rounds but are treated as out of
// support (the reference rebuilds its sparse matrices each round, so
// a dropped entry can never resurrect).  `cutoff_last` is the final
// round's re-threshold (QuickProbs numFilterings=-1 re-sparsifies the
// last iteration at 1e-5, ConsistencyStage.cpp:230-259).  Between
// rounds the lower (transposed) cells are refreshed through
// `tperm_pool`: upper entry s of pair p lands at transpose-data index
// tperm_pool[tperm_off[p] + s].
void relax_all_pairs(
    int n,
    const int32_t* lengths,
    const int64_t* cell_ptr,    // (n*n,) offsets into indptr_pool
    const int64_t* cell_dat,    // (n*n,) offsets into indices/data pools
    const int32_t* indptr_pool,
    const int32_t* indices_pool,
    const float* data_pool,
    int64_t data_pool_len,
    int npairs,
    const int32_t* pair_ij,     // (npairs, 2)
    const float* self_coef,     // (npairs,)
    const float* z_scale,       // (npairs,)
    const float* w_eff,         // (npairs * n)
    float cutoff,
    float cutoff_last,
    int reps,
    const int64_t* tperm_off,   // (npairs,) offsets into tperm_pool
    const int32_t* tperm_pool,
    float* out_data             // same layout as data_pool (upper cells)
) {
    int max_len = 0;
    for (int i = 0; i < n; ++i)
        if (lengths[i] > max_len) max_len = lengths[i];
    std::vector<float> work(data_pool, data_pool + data_pool_len);

    for (int rep = 0; rep < reps; ++rep) {
        const float cut = rep == reps - 1 ? cutoff_last : cutoff;
        const float* cur = work.data();
#pragma omp parallel
        {
            std::vector<float> acc((size_t)max_len, 0.0f);

#pragma omp for schedule(dynamic)
            for (int p = 0; p < npairs; ++p) {
                const int i = pair_ij[2 * p];
                const int j = pair_ij[2 * p + 1];
                const int li = lengths[i];
                const int lj = lengths[j];
                const float sc = self_coef[p];
                const float zs = z_scale[p];
                const float* we = w_eff + (size_t)p * n;

                const int64_t cij = (int64_t)i * n + j;
                const int32_t* ip_ij = indptr_pool + cell_ptr[cij];
                const int32_t* ix_ij = indices_pool + cell_dat[cij];
                const float* da_ij = cur + cell_dat[cij];
                float* out = out_data + cell_dat[cij];

                for (int r = 0; r < li; ++r) {
                    const int s0 = ip_ij[r], s1 = ip_ij[r + 1];
                    if (s0 == s1) continue;
                    std::memset(acc.data(), 0,
                                (size_t)lj * sizeof(float));
                    // accumulate sum_z w_z * (row r of P_iz) @ P_zj
                    for (int z = 0; z < n; ++z) {
                        const float wz = we[z];
                        if (wz == 0.0f) continue;
                        const int64_t ciz = (int64_t)i * n + z;
                        const int32_t* ip_a = indptr_pool + cell_ptr[ciz];
                        const int32_t a0 = ip_a[r], a1 = ip_a[r + 1];
                        if (a0 == a1) continue;
                        const int32_t* ix_a = indices_pool + cell_dat[ciz];
                        const float* da_a = cur + cell_dat[ciz];
                        const int64_t czj = (int64_t)z * n + j;
                        const int32_t* ip_b = indptr_pool + cell_ptr[czj];
                        const int32_t* ix_b = indices_pool + cell_dat[czj];
                        const float* da_b = cur + cell_dat[czj];
                        for (int a = a0; a < a1; ++a) {
                            const float va = wz * da_a[a];
                            if (va == 0.0f) continue;
                            const int m = ix_a[a];
                            const int b0 = ip_b[m], b1 = ip_b[m + 1];
                            for (int b = b0; b < b1; ++b) {
                                acc[ix_b[b]] += va * da_b[b];
                            }
                        }
                    }
                    // emit at the live support of P_ij only (zeroed
                    // entries are structurally present but dead)
                    for (int s = s0; s < s1; ++s) {
                        const float dv = da_ij[s];
                        if (dv == 0.0f) { out[s] = 0.0f; continue; }
                        const float v = sc * dv + zs * acc[ix_ij[s]];
                        out[s] = (v < cut) ? 0.0f : v;
                    }
                }
            }
        }
        if (rep == reps - 1 || tperm_off == nullptr) break;
        // refresh both orientations for the next round
#pragma omp parallel for schedule(static)
        for (int p = 0; p < npairs; ++p) {
            const int i = pair_ij[2 * p];
            const int j = pair_ij[2 * p + 1];
            const int64_t cij = (int64_t)i * n + j;
            const int64_t cji = (int64_t)j * n + i;
            const int32_t* ip_ij = indptr_pool + cell_ptr[cij];
            const int64_t nnz = ip_ij[lengths[i]];
            const float* out = out_data + cell_dat[cij];
            float* up = work.data() + cell_dat[cij];
            float* lo = work.data() + cell_dat[cji];
            const int32_t* tp = tperm_pool + tperm_off[p];
            for (int64_t s = 0; s < nnz; ++s) {
                up[s] = out[s];
                lo[tp[s]] = out[s];
            }
        }
    }
}

// Walk one MWT direction matrix (0=diag, 1=left, 2=up) from (lx, ly).
// dirs has row stride `stride`. Writes path codes (0='B',1='X',2='Y')
// in forward order into out (capacity lx+ly); returns path length.
int mwt_traceback(const int8_t* dirs, int stride, int lx, int ly,
                  int8_t* out) {
    int r = lx, c = ly, n = 0;
    int8_t* rev = out;  // fill backwards then reverse
    while (r != 0 || c != 0) {
        int8_t d = dirs[r * stride + c];
        if (d == 0) { --r; --c; rev[n++] = 0; }
        else if (d == 1) { --c; rev[n++] = 2; }
        else { --r; rev[n++] = 1; }
    }
    for (int i = 0; i < n / 2; ++i) {
        int8_t t = out[i]; out[i] = out[n - 1 - i]; out[n - 1 - i] = t;
    }
    return n;
}

// Walk one packed Viterbi direction matrix (bits 0-1: M predecessor,
// bit 2: X-from-X, bit 3: Y-from-Y) from (lx, ly) in state `state`.
int viterbi_traceback(const int8_t* dirs, int stride, int lx, int ly,
                      int state, int8_t* out) {
    int r = lx, c = ly, n = 0;
    while (r != 0 || c != 0) {
        int8_t d = dirs[r * stride + c];
        int nxt;
        if (state == 0) { nxt = d & 3; --r; --c; out[n++] = 0; }
        else if (state == 1) { nxt = (d & 4) ? 1 : 0; --r; out[n++] = 1; }
        else { nxt = (d & 8) ? 2 : 0; --c; out[n++] = 2; }
        state = nxt;
    }
    for (int i = 0; i < n / 2; ++i) {
        int8_t t = out[i]; out[i] = out[n - 1 - i]; out[n - 1 - i] = t;
    }
    return n;
}

// Aggregate the -G feature pass over a batch of pairwise Viterbi
// alignments (MSA.cpp Alter_ModelAdjustmentTest semantics).
//
// For each pair k: traceback dirs[k], walk the path against sequences
// x=seqs[xi[k]], y=seqs[yi[k]] (int8 residue classes; 0..19 standard),
// and accumulate:
//   pids[k]      = matches / path_len
//   lengths[k]   = path_len
//   col_acc[pos] += blosum(a,b) for matched standard residues with
//                  score < 10 (shared across pairs)
//   sp_sum, sp_cols
// Returns the max path length over the batch.
int viterbi_features_batch(
    const int8_t* dirs,        // (B, stride_r, stride_c) packed dirs
    const int32_t* end_states, // (B,)
    int batch, int stride_r, int stride_c,
    const int8_t* const* xs,   // per-pair pointers to encoded sequences
    const int8_t* const* ys,
    const int32_t* lxs, const int32_t* lys,
    const double* blosum,      // (21*21) with unknown row zero
    double* pids,              // out (B,)
    int32_t* lengths,          // out (B,)
    double* col_acc,           // out (cap,) shared accumulation
    int col_cap,
    double* sp_out             // out [sp_sum, sp_cols]
) {
    int max_len = 0;
    double sp_sum = 0.0;
    long long sp_cols = 0;
    std::vector<int8_t> path;
    for (int k = 0; k < batch; ++k) {
        int lx = lxs[k], ly = lys[k];
        path.resize(lx + ly + 2);
        const int8_t* d = dirs + (long long)k * stride_r * stride_c;
        int n = viterbi_traceback(d, stride_c, lx, ly, end_states[k],
                                  path.data());
        if (n > max_len) max_len = n;
        const int8_t* x = xs[k];
        const int8_t* y = ys[k];
        int a = 0, b = 0, matches = 0;
        for (int t = 0; t < n; ++t) {
            if (path[t] == 0) {
                int ca = x[a++], cb = y[b++];
                if (ca == cb) ++matches;
                if (ca < 20 && cb < 20) {
                    double s = blosum[ca * 21 + cb];
                    if (s < 10.0 && t < col_cap) {
                        col_acc[t] += s;
                        sp_sum += s;
                    }
                }
            } else if (path[t] == 1) ++a;
            else ++b;
        }
        sp_cols += n;
        pids[k] = n > 0 ? (double)matches / n : 0.0;
        lengths[k] = n;
    }
    sp_out[0] = sp_sum;
    sp_out[1] = (double)sp_cols;
    return max_len;
}

// ---------------------------------------------------------------------------
// Profile-profile posterior builder.
//
// The construction hot loop (ProbabilisticModel::BuildPosterior,
// ProbabilisticModel.h:1197-1379 / ParallelProbabilisticModel.cpp
// buildPosterior): for every inter-group sequence pair, scatter its
// sparse posterior through the two gap mappings into the dense
// (l1, l2) profile plane, weighted; optionally subtract w * cutoff at
// every mapped cell (the QuickProbs posteriorCutoff subtraction over
// ungapped rows x the first l2-1 mapped columns).
//
// COO pool layout: pair p owns entries [pair_off[p], pair_off[p+1]) of
// coo_r / coo_c / coo_v (ungapped 0-based coordinates in its two
// sequences).  maps1/maps2 pools hold each group member's
// ungapped-position -> profile-column map (map1_off has n1+1 entries).
//
// OpenMP over pairs with per-thread accumulation planes, reduced at
// the end (matches the reference's row-block parallel variant).
void profile_posterior(
    int l1, int l2,
    int npairs,
    const int64_t* pair_start,   // (npairs,) offsets into the COO pool
    const int64_t* pair_len,     // (npairs,)
    const int32_t* a_idx,        // (npairs,) group-1 member
    const int32_t* b_idx,        // (npairs,) group-2 member
    const float* wts,            // (npairs,)
    const int32_t* coo_r,
    const int32_t* coo_c,
    const float* coo_v,
    const int32_t* maps1, const int64_t* map1_off,
    const int32_t* maps2, const int64_t* map2_off,
    float cutoff_sub,
    float* out                   // (l1*l2), caller-zeroed
) {
    const size_t plane = (size_t)l1 * l2;
#ifdef _OPENMP
    int nthreads = omp_get_max_threads();
#else
    int nthreads = 1;
#endif
    std::vector<std::vector<double>> acc(
        nthreads, std::vector<double>(plane, 0.0));

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int p = 0; p < npairs; ++p) {
#ifdef _OPENMP
        double* A = acc[omp_get_thread_num()].data();
#else
        double* A = acc[0].data();
#endif
        const int32_t* m1 = maps1 + map1_off[a_idx[p]];
        const int32_t* m2 = maps2 + map2_off[b_idx[p]];
        const double w = wts[p];
        const int64_t e0 = pair_start[p], e1 = e0 + pair_len[p];
        for (int64_t e = e0; e < e1; ++e) {
            A[(size_t)m1[coo_r[e]] * l2 + m2[coo_c[e]]] += w * coo_v[e];
        }
        if (cutoff_sub != 0.0f) {
            const int64_t n1 =
                map1_off[a_idx[p] + 1] - map1_off[a_idx[p]];
            const int64_t n2 =
                map2_off[b_idx[p] + 1] - map2_off[b_idx[p]];
            const double sub = w * (double)cutoff_sub;
            // ungapped rows x the first n2-1 mapped columns
            // (the reference mapping's 0 sentinel swallows one entry)
            for (int64_t r = 0; r < n1; ++r) {
                double* row = A + (size_t)m1[r] * l2;
                for (int64_t c = 0; c + 1 < n2; ++c) {
                    row[m2[c]] -= sub;
                }
            }
        }
    }
    for (int t = 0; t < nthreads; ++t) {
        const double* A = acc[t].data();
        for (size_t k = 0; k < plane; ++k) out[k] += (float)A[k];
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// All-pairs posterior stage (native host engine).
//
// The host twin of align/pairwise.all_pairs_posteriors: per pair,
// compute the mode's posterior models, RMS-combine, run the MWT accuracy
// DP (score + aligned-pair count), and sparsify at `cutoff` into CSR.
// This is the engine the router picks for families whose total DP work
// is too small to pay for the device's dispatch and readback
// (pairwise._native_route), the engine on a host with no accelerator,
// and the recovery engine when the device allocator
// is poisoned (driver._fallback_align).  Roles: PosteriorStage.cpp:94-196
// and MSA.cpp:895-1013, OpenMP schedule(dynamic) over pairs like both.
//
// modes: 0=mix (hmm5+partition+local, /3), 1=local, 2=partition,
//        3=qp (hmm5 + partition with the [0.001, 1] window, /2).
// Results live in a static store between _run and _export (single
// Python caller; guarded by a mutex for safety).

namespace {

struct CsrResult {
    std::vector<int32_t> indptr;
    std::vector<int32_t> indices;
    std::vector<float> data;
};

std::mutex g_post_mutex;
std::vector<CsrResult> g_post_results;

}  // namespace

extern "C" {

int64_t posterior_family_run(
    int n_seqs,
    const int8_t *seq_pool, const int64_t *seq_off,  // (n_seqs+1,)
    int n_pairs, const int32_t *pair_ij,             // (n_pairs, 2)
    int mode,
    // hmm5 tables (f32 log)
    const float *h5_init, const float *h5_trans,
    const float *h5_lmatch, const float *h5_lins,
    // local tables
    const float *lo_trans, const float *lo_lmatch,
    const float *lo_lins, float lo_log_stay,
    // partition tables
    const float *pt_lscore, float pt_lgo, float pt_lge,
    float cutoff,
    // outputs per pair
    float *scores, int32_t *matches, int64_t *nnz_out
) {
    std::lock_guard<std::mutex> lock(g_post_mutex);
    g_post_results.assign(n_pairs, CsrResult());
    Hmm5Tables h5{h5_init, h5_trans, h5_lmatch, h5_lins};
    LocalTables lo{lo_trans, lo_lmatch, lo_lins, lo_log_stay};
    PartTables pt{pt_lscore, pt_lgo, pt_lge};

    // Lane-group the pairs by similar dimensions (sort by (ly, lx)) so
    // the 16-lane SIMD engines waste little padding; OpenMP over groups.
    std::vector<int> order(n_pairs);
    for (int p = 0; p < n_pairs; ++p) order[p] = p;
    auto dims = [&](int p, int &lx, int &ly) {
        const int i = pair_ij[2 * p], j = pair_ij[2 * p + 1];
        lx = (int)(seq_off[i + 1] - seq_off[i]);
        ly = (int)(seq_off[j + 1] - seq_off[j]);
    };
    std::sort(order.begin(), order.end(), [&](int a, int b) {
        int ax, ay, bx, by;
        dims(a, ax, ay);
        dims(b, bx, by);
        if (ay != by) return ay < by;
        return ax < bx;
    });
    const int n_groups = (n_pairs + VL - 1) / VL;

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int g = 0; g < n_groups; ++g) {
        const int g0 = g * VL;
        const int lanes = std::min(VL, n_pairs - g0);
        const int8_t *sx[VL];
        const int8_t *sy[VL];
        int lxs[VL], lys[VL];
        int LX = 1, LY = 1;
        for (int k = 0; k < lanes; ++k) {
            const int p = order[g0 + k];
            const int i = pair_ij[2 * p], j = pair_ij[2 * p + 1];
            sx[k] = seq_pool + seq_off[i];
            sy[k] = seq_pool + seq_off[j];
            lxs[k] = (int)(seq_off[i + 1] - seq_off[i]);
            lys[k] = (int)(seq_off[j + 1] - seq_off[j]);
            if (lxs[k] > LX) LX = lxs[k];
            if (lys[k] > LY) LY = lys[k];
        }
        const int Wg = LY + 1;
        const size_t gplane = (size_t)(LX + 1) * Wg;
        std::vector<v16> fM(gplane), bM(gplane);
        std::vector<v16> comb(gplane, vbc(0.0f));
        float totals[VL];
        int n_models = 0;

        const bool qp = mode == 3;
        auto accumulate = [&]() {
            v16 tot;
            for (int k = 0; k < VL; ++k) {
                const float t = k < lanes ? totals[k] : 1.0f;
                tot[k] = t == 0.0f ? 1.0f : t;
            }
            for (size_t c = 0; c < gplane; ++c) {
                v16 v = fM[c] + bM[c] - tot;
                v = (v < vbc(0.0f)) ? v : vbc(0.0f);
                const v16 pm = qp ? vexp_ref<true>(v) : vexp_ref<false>(v);
                comb[c] += pm * pm;
            }
            ++n_models;
        };

        if (mode == 0 || mode == 3) {           // hmm5
            // qp: the qp-exact engine, rounded as on the device
            if (qp)
                hmm5_fb_batch<true>(sx, sy, lxs, lys, lanes, LX, LY, h5,
                                    fM.data(), bM.data(), totals);
            else
                hmm5_fb_batch<false>(sx, sy, lxs, lys, lanes, LX, LY, h5,
                                     fM.data(), bM.data(), totals);
            accumulate();
        }
        if (mode == 0 || mode == 1) {           // local
            local_fb_batch(sx, sy, lxs, lys, lanes, LX, LY, lo,
                           fM.data(), bM.data(), totals);
            accumulate();
        }
        if (mode == 0 || mode == 2 || mode == 3) {  // partition
            for (int k = 0; k < lanes; ++k) {
                const int W = lys[k] + 1;
                std::vector<float> pm((size_t)(lxs[k] + 1) * W);
                partition_posterior_native(sx[k], sy[k], lxs[k],
                                           lys[k], pt, mode == 3,
                                           pm.data());
                for (int a = 1; a <= lxs[k]; ++a)
                    for (int b = 1; b <= lys[k]; ++b) {
                        const float q = pm[(size_t)a * W + b];
                        comb[(size_t)a * Wg + b][k] += q * q;
                    }
            }
            ++n_models;
        }

        const float inv = 1.0f / (float)n_models;
        for (int k = 0; k < lanes; ++k) {
            const int p = order[g0 + k];
            const int lx = lxs[k], ly = lys[k];
            const int W = ly + 1;
            const size_t plane = (size_t)(lx + 1) * W;
            std::vector<float> post(plane, 0.0f);
            for (int a = 1; a <= lx; ++a)
                for (int b = 1; b <= ly; ++b)
                    post[(size_t)a * W + b] = std::sqrt(
                        comb[(size_t)a * Wg + b][k] * inv);

            // MWT accuracy DP + aligned-pair count via traceback
            std::vector<int8_t> dirs(plane);
            scores[p] = mwt_fill(post.data(), lx, ly, dirs.data());
            if (matches) {
                int r = lx, c = ly, nb = 0;
                while (r != 0 || c != 0) {
                    const int8_t d = dirs[(size_t)r * W + c];
                    if (d == 0) { --r; --c; ++nb; }
                    else if (d == 1) { --c; }
                    else { --r; }
                }
                matches[p] = nb;
            }

            // sparsify (cutoff keeps every entry >= 0.01 like
            // SparseMatrix.h:14 — no top-k truncation on the host)
            CsrResult &res = g_post_results[p];
            res.indptr.resize(lx + 1);
            for (int a = 1; a <= lx; ++a) {
                res.indptr[a - 1] = (int32_t)res.indices.size();
                const float *row = post.data() + (size_t)a * W;
                for (int b = 1; b <= ly; ++b) {
                    if (row[b] >= cutoff) {
                        res.indices.push_back(b - 1);
                        res.data.push_back(row[b]);
                    }
                }
            }
            res.indptr[lx] = (int32_t)res.indices.size();
            nnz_out[p] = (int64_t)res.data.size();
        }
    }
    int64_t total_nnz = 0;
    for (int p = 0; p < n_pairs; ++p)
        total_nnz += (int64_t)g_post_results[p].data.size();
    return total_nnz;
}

// Copy the stored CSRs out.  indptr_pool must hold sum(lx_p + 1),
// indices/data pools the total nnz returned by _run; per-pair offsets
// are the caller's to reconstruct from nnz_out and pair lengths.
void posterior_family_export(int32_t *indptr_pool, int32_t *indices_pool,
                             float *data_pool) {
    std::lock_guard<std::mutex> lock(g_post_mutex);
    size_t po = 0, dof = 0;
    for (const CsrResult &r : g_post_results) {
        std::memcpy(indptr_pool + po, r.indptr.data(),
                    r.indptr.size() * sizeof(int32_t));
        std::memcpy(indices_pool + dof, r.indices.data(),
                    r.indices.size() * sizeof(int32_t));
        std::memcpy(data_pool + dof, r.data.data(),
                    r.data.size() * sizeof(float));
        po += r.indptr.size();
        dof += r.data.size();
    }
    g_post_results.clear();
}

// ---------------------------------------------------------------------------
// Local-model Viterbi feature pass, fully native.
//
// The -G / ModelAdjustmentTest engine (MSA.cpp:646-882,
// ProbabilisticModel.h:1043+): per pair, fill the 3-state local Viterbi
// DP (f32, tie order M >= X >= Y), traceback, and aggregate PID /
// column-profile / SP statistics.  OpenMP over pairs with per-thread
// column accumulators reduced at the end.  vinit: the fixed Viterbi
// initial distribution (ProbabilisticModel.h:1075-1077).

int viterbi_family_features(
    int n_seqs, const int8_t *seq_pool, const int64_t *seq_off,
    int n_pairs, const int32_t *pair_ij,
    const float *lo_trans,    // (3,3) log
    const float *lo_lmatch,   // (21,21)
    const float *lo_lins,     // (21,)
    const float *vinit,       // (3,)
    const double *blosum,     // (21*21)
    double *pids,             // out (n_pairs,)
    int32_t *path_lens,       // out (n_pairs,)
    double *col_acc,          // out (cap,)
    int col_cap,
    double *sp_out            // out [sp_sum, sp_cols]
) {
    auto T3 = [&](int a, int b) { return lo_trans[a * 3 + b]; };
    int max_len_all = 0;
    double sp_sum_all = 0.0;
    long long sp_cols_all = 0;

#ifdef _OPENMP
    const int nthreads = omp_get_max_threads();
#else
    const int nthreads = 1;
#endif
    std::vector<std::vector<double>> col_tls(
        nthreads, std::vector<double>((size_t)col_cap, 0.0));

#ifdef _OPENMP
#pragma omp parallel reduction(max : max_len_all) \
    reduction(+ : sp_sum_all, sp_cols_all)
#endif
    {
#ifdef _OPENMP
        double *cacc = col_tls[omp_get_thread_num()].data();
#else
        double *cacc = col_tls[0].data();
#endif
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int p = 0; p < n_pairs; ++p) {
            const int i = pair_ij[2 * p], j = pair_ij[2 * p + 1];
            const int8_t *sx = seq_pool + seq_off[i];
            const int8_t *sy = seq_pool + seq_off[j];
            const int lx = (int)(seq_off[i + 1] - seq_off[i]);
            const int ly = (int)(seq_off[j + 1] - seq_off[j]);
            const int W = ly + 1;
            std::vector<int8_t> dirs((size_t)(lx + 1) * W);
            std::vector<float> Mp(W), Xp(W), Yp(W), Mc(W), Xc(W), Yc(W);
            // row 0
            Mp[0] = vinit[0]; Xp[0] = vinit[1]; Yp[0] = vinit[2];
            dirs[0] = 0;
            for (int b = 1; b <= ly; ++b) {
                Mp[b] = LOG_ZERO_F;
                Xp[b] = LOG_ZERO_F;
                const float liy = lo_lins[sy[b - 1]];
                const float cm = Mp[b - 1] + T3(0, 2);
                const float cy = Yp[b - 1] + T3(2, 2);
                const bool from_y = cm < cy;
                Yp[b] = liy + (from_y ? cy : cm);
                dirs[b] = (int8_t)(from_y ? 8 : 0);
            }
            for (int a = 1; a <= lx; ++a) {
                const float lix = lo_lins[sx[a - 1]];
                Mc[0] = LOG_ZERO_F;
                Yc[0] = LOG_ZERO_F;
                {
                    const float fm = Mp[0] + T3(0, 1);
                    const float fx = Xp[0] + T3(1, 1);
                    const bool from_x = fm < fx;
                    Xc[0] = lix + (from_x ? fx : fm);
                    dirs[(size_t)a * W] = (int8_t)(from_x ? 4 : 0);
                }
                for (int b = 1; b <= ly; ++b) {
                    // M: diagonal, tie order M > X > Y
                    const float cm = Mp[b - 1] + T3(0, 0);
                    const float cx = Xp[b - 1] + T3(1, 0);
                    const float cy = Yp[b - 1] + T3(2, 0);
                    int tbm;
                    float best;
                    if (cm >= cx && cm >= cy) { best = cm; tbm = 0; }
                    else if (cx >= cy) { best = cx; tbm = 1; }
                    else { best = cy; tbm = 2; }
                    Mc[b] = lo_lmatch[sx[a - 1] * 21 + sy[b - 1]] + best;
                    // X: vertical, prefer M on ties
                    const float fm = Mp[b] + T3(0, 1);
                    const float fx = Xp[b] + T3(1, 1);
                    const bool from_x = fm < fx;
                    Xc[b] = lix + (from_x ? fx : fm);
                    // Y: horizontal within-row, prefer M on ties
                    const float liy = lo_lins[sy[b - 1]];
                    const float gm = Mc[b - 1] + T3(0, 2);
                    const float gy = Yc[b - 1] + T3(2, 2);
                    const bool from_y = gm < gy;
                    Yc[b] = liy + (from_y ? gy : gm);
                    dirs[(size_t)a * W + b] =
                        (int8_t)(tbm + (from_x ? 4 : 0) + (from_y ? 8 : 0));
                }
                std::swap(Mp, Mc);
                std::swap(Xp, Xc);
                std::swap(Yp, Yc);
            }
            const float fm = Mp[ly] + vinit[0];
            const float fx = Xp[ly] + vinit[1];
            const float fy = Yp[ly] + vinit[2];
            int state;
            if (fm >= fx && fm >= fy) state = 0;
            else if (fx >= fy) state = 1;
            else state = 2;

            // traceback + feature aggregation (forward order)
            std::vector<int8_t> path((size_t)lx + ly + 2);
            const int n = viterbi_traceback(dirs.data(), W, lx, ly,
                                            state, path.data());
            if (n > max_len_all) max_len_all = n;
            int a2 = 0, b2 = 0, match_cnt = 0;
            for (int t = 0; t < n; ++t) {
                if (path[t] == 0) {
                    const int ca = sx[a2++], cb = sy[b2++];
                    if (ca == cb) ++match_cnt;
                    if (ca < 20 && cb < 20) {
                        const double sc = blosum[ca * 21 + cb];
                        if (sc < 10.0 && t < col_cap) {
                            cacc[t] += sc;
                            sp_sum_all += sc;
                        }
                    }
                } else if (path[t] == 1) ++a2;
                else ++b2;
            }
            sp_cols_all += n;
            pids[p] = n > 0 ? (double)match_cnt / n : 0.0;
            path_lens[p] = n;
        }
    }
    for (int t = 0; t < nthreads; ++t)
        for (int k = 0; k < col_cap; ++k) col_acc[k] += col_tls[t][k];
    sp_out[0] = sp_sum_all;
    sp_out[1] = (double)sp_cols_all;
    return max_len_all;
}

// Dense MWT fill for the progressive/refinement profile DP
// (ProbabilisticModel.h:804-864 ComputeAlignment role).  post is the
// 0-based (lx, ly) plane; dirs is (lx+1)*(ly+1).  Returns the score.
float mwt_fill_dense(const float *post, int lx, int ly, int8_t *dirs) {
    // re-layout into the 1-indexed plane convention of mwt_fill
    const int W = ly + 1;
    std::vector<float> plane((size_t)(lx + 1) * W, 0.0f);
    for (int i = 1; i <= lx; ++i)
        std::memcpy(plane.data() + (size_t)i * W + 1,
                    post + (size_t)(i - 1) * ly, ly * sizeof(float));
    return mwt_fill(plane.data(), lx, ly, dirs);
}

}  // extern "C"
