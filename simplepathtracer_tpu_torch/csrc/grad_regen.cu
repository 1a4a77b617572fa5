// Regeneration gradient kernels for Hopper (sm_90a): the recording forward
// (two modes), the scan-free re-forward and the backward.
//
// Replace the TPU kernels of the JAX package's ops/pallas_grad_regen.py:
//   regen_kernel<kModeFull>   _regen_fwd_kernel, emit_full=True
//   regen_kernel<kModeIdx>    _regen_fwd_kernel, emit_idx_only=True
//   regen_kernel<kModeRefwd>  _regen_refwd_kernel
//   regen_bwd_kernel          _regen_bwd_kernel
// together with the hard branch of ops/pallas_grad.py:bounce_tile (the
// physics all four share) and its jax.vjp, which CUDA does not have: the
// adjoint below is written by hand and mirrors the plain PyTorch
// ops/bounce.py:bounce_tile_adjoint line by line.
//
// What they compute.  Lane l of the banked layout (ops/persistent.py:
// bank_geometry) serves the pixels at positions l + k * n_lanes, k <
// n_banks, each for n_samples samples; a lane whose path ends starts the
// next sample (or the next bank's pixel) in the next iteration.  Iteration
// `it` of a lane is one bounce.  The forward records, per iteration, the
// 25 residual planes of the JAX package (entry o, d, tp; alive, regen;
// bank kb, sample s, bounce b; winner idx, material and its 9 attributes)
// or, in idx mode, only the winner index packed three to a word (10 bits of
// idx + 1 each).  The re-forward replays the same state evolution with the
// sphere scan replaced by the recorded index, and so emits the planes the
// full forward would have.  The backward walks a lane's iterations in
// reverse with the carried (o, d, tp) cotangents, writes the 9 winner
// attribute cotangents per iteration (bucketed into the table by
// csrc/bucket.cu) and sums the lane's sky (6) and plane (4) cotangents.
//
// Design.  One thread per lane; ray state in registers.  Planes are
// [n_iter, n_lanes] (iteration-major), so a warp's stores coalesce.  A
// lane's live iterations are 0 .. count - 1 (it regenerates at once until
// its banks are done), so the forward breaks out of its loop there and
// marks the rest dead (alive 0, idx -1, packed words 0); the backward skips
// dead iterations and writes their cotangents as 0.  Sphere tables sit in
// shared memory (common.cuh); the re-forward reads its winner by index
// there instead of the TPU's one-hot matrix product.  Per-lane partials are
// written once and summed by the host, so every result is deterministic.
//
// Bound.  The recording forward is bound by the sphere scan's FP32 work,
// as the persistent kernel (20 operations per sphere test); the re-forward
// and backward do O(1) work per iteration and are bound by the planes they
// write and read (25 planes out; 25 in and 9 out).
//
// Numerics.  --fmad=false (cuda_build.py) and IEEE sqrt / division: every
// operation rounds as the PyTorch elementwise op of the plain versions
// (ops/grad_regen.py, ops/bounce.py), so the kernels match them bit for
// bit.  Where the plain version divides a constant by a tensor, PyTorch
// computes reciprocal(x) * c; the code below does the same.

#include "common.cuh"

namespace spt {
namespace {

constexpr int kThreads = 128;
constexpr int kIdxBits = 10;
constexpr int kIdxMask = (1 << kIdxBits) - 1;
constexpr int kPlaneIdx = kIdxMask - 1;  // winner code of a ground-plane hit
constexpr int kModeFull = 0;
constexpr int kModeIdx = 1;
constexpr int kModeRefwd = 2;
// f32 residual planes: 0-2 o, 3-5 d, 6-8 tp, 9 alive, 10 regen, 11-19 the
// winner's cx cy cz r ar ag ab fuzz ior.  i32: 0 kb, 1 s, 2 b, 3 idx, 4 mat.
constexpr int kFAlive = 9;
constexpr int kFRegen = 10;
constexpr int kFAttr = 11;
constexpr int kIKb = 0, kIS = 1, kIB = 2, kIIdx = 3, kIMat = 4;

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// d max(a, b) / da under JAX's rule: 1 if a > b, 0.5 on a tie, else 0.
__device__ __forceinline__ float wmax(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

__device__ __forceinline__ float wmin(float a, float b) {
  return a < b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

// One hard bounce of an alive lane: inputs, the intermediates the adjoint
// reads, and the outputs (ops/bounce.py:_forward).
struct Bounce {
  // inputs
  float o[3], d[3], tp[3], c[3], r, alb[3], fz, io;
  int mat;
  bool hit, pm, do_rr;
  float u[8];
  // sky
  float s01, skw[3], sk[3];
  // hit reconstruction
  float oc[3], tc, disc, sq;
  bool use_near;
  float den_p, den_s, num, psgn;
  bool live_d;
  float t, p[3], q[3], n0[3], sn, ninv;
  bool front;
  float fsign, nf[3], dnf, cos_t, two_dn, rf[3];
  // Lambertian
  float l[3], ln2, lm, linv;
  bool ldeg;
  // metal
  float rm, cm, sm, zm, bs0, m[3], mn2, mm, minv;
  bool mdeg;
  // dielectric
  float eta, inner[3], pp[3], px, par, g[3], gn2, gm, ginv;
  bool do_refl, gdeg;
  bool is_metal, is_diel, surv0;
  float sd[3], at[3];
  // throughput and Russian roulette
  float nt[3], m1, m2, q1, qq;
  bool surv, boost;
  // outputs
  float no[3], nd[3], ntp[3], rad[3];
};

__device__ __forceinline__ void normalize_or(const float* v, const float* nf,
                                             float& n2, float& mx, float& inv,
                                             bool& deg, float* out) {
  n2 = dot3(v, v);
  mx = fmaxf(n2, 1e-20f);
  inv = rsqrtf(mx);
  deg = n2 <= 1e-12f;
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = deg ? nf[c] : v[c] * inv;
}

__device__ void bounce_forward(Bounce& f, const float* sky, float t_min,
                               float t_max, bool rr_on) {
  f.s01 = 0.5f * (f.d[1] + 1.0f);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    f.skw[c] = sky[c + 3] - sky[c];
    f.sk[c] = sky[c] + f.skw[c] * f.s01;
  }
  if (!f.hit) {
    // Sky on a live miss; the path ends where it is.
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      f.rad[c] = f.tp[c] * f.sk[c];
      f.no[c] = f.o[c];
      f.nd[c] = f.d[c];
      f.ntp[c] = f.tp[c];
      f.nt[c] = f.tp[c];
    }
    f.surv0 = f.surv = f.boost = false;
    return;
  }
  // Hit rebuilt from the winner's attributes.
#pragma unroll
  for (int c = 0; c < 3; ++c) f.oc[c] = f.c[c] - f.o[c];
  f.tc = dot3(f.oc, f.d);
  const float oc2 = dot3(f.oc, f.oc);
  f.disc = f.r * f.r - (oc2 - f.tc * f.tc);
  f.sq = sqrtf(fmaxf(f.disc, 1e-12f));
  const float t_near = f.tc - f.sq;
  f.use_near = t_near > t_min;
  f.t = f.use_near ? t_near : f.tc + f.sq;
  if (f.pm) {
    // True plane intersection: (cx, cy, cz) = unit normal, r = offset.
    f.den_p = f.d[0] * f.c[0] + f.d[1] * f.c[1] + f.d[2] * f.c[2];
    f.live_d = fabsf(f.den_p) > 1e-8f;
    f.den_s = f.live_d ? f.den_p : 1.0f;
    f.num = -(f.o[0] * f.c[0] + f.o[1] * f.c[1] + f.o[2] * f.c[2]) - f.r;
    f.t = f.num / f.den_s;
    f.psgn = f.den_p > 0.0f ? -1.0f : 1.0f;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    f.p[c] = f.o[c] + f.t * f.d[c];
    f.q[c] = f.p[c] - f.c[c];
  }
  float n[3];
  if (f.pm) {
#pragma unroll
    for (int c = 0; c < 3; ++c) n[c] = f.psgn * f.c[c];
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) f.n0[c] = f.q[c] / f.r;
    f.sn = sqrtf(dot3(f.n0, f.n0) + 1e-20f);
    f.ninv = 1.0f / f.sn;
#pragma unroll
    for (int c = 0; c < 3; ++c) n[c] = f.n0[c] * f.ninv;
  }
  f.front = dot3(f.d, n) < 0.0f;
  f.fsign = f.front ? 1.0f : -1.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) f.nf[c] = n[c] * f.fsign;
  f.dnf = dot3(f.d, f.nf);
  f.cos_t = fminf(-f.dnf, 1.0f);
  f.two_dn = 2.0f * dot3(f.d, f.nf);
#pragma unroll
  for (int c = 0; c < 3; ++c) f.rf[c] = f.d[c] - f.two_dn * f.nf[c];

  f.is_metal = f.mat == kMetal;
  f.is_diel = f.mat == kDielectric;
  bool scattered = true;
  if (f.is_metal) {
    f.zm = 1.0f - 2.0f * f.u[2];
    f.rm = sqrtf(fmaxf(1.0f - f.zm * f.zm, 0.0f));
    const float phm = kTwoPi * f.u[3];
    sincosf(phm, &f.sm, &f.cm);
    f.bs0 = expf(logf(fmaxf(f.u[4], 1e-30f)) * (1.0f / 3.0f));
    const float bscale = f.bs0 * f.fz;
    f.m[0] = f.rf[0] + bscale * f.rm * f.cm;
    f.m[1] = f.rf[1] + bscale * f.rm * f.sm;
    f.m[2] = f.rf[2] + bscale * f.zm;
    normalize_or(f.m, f.nf, f.mn2, f.mm, f.minv, f.mdeg, f.sd);
    scattered = dot3(f.sd, f.nf) > 0.0f;
  } else if (f.is_diel) {
    f.eta = f.front ? 1.0f / f.io : f.io;
    const float sin2 = fmaxf(1.0f - f.cos_t * f.cos_t, 0.0f);
    const bool cannot = f.eta * f.eta * sin2 > 1.0f;
    const float r0s = (1.0f - f.eta) / (1.0f + f.eta);
    const float r0 = r0s * r0s;
    const float omc = 1.0f - f.cos_t;
    const float omc2 = omc * omc;
    const float refl_p = r0 + (1.0f - r0) * omc2 * omc2 * omc;
    f.do_refl = cannot || f.u[5] < refl_p;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      f.inner[c] = f.d[c] + f.cos_t * f.nf[c];
      f.pp[c] = f.eta * f.inner[c];
    }
    f.px = 1.0f - dot3(f.pp, f.pp);
    f.par = sqrtf(fmaxf(f.px, 1e-12f));
#pragma unroll
    for (int c = 0; c < 3; ++c)
      f.g[c] = f.do_refl ? f.rf[c] : f.pp[c] - f.par * f.nf[c];
    normalize_or(f.g, f.nf, f.gn2, f.gm, f.ginv, f.gdeg, f.sd);
  } else {
    const float zl = 1.0f - 2.0f * f.u[0];
    const float rl = sqrtf(fmaxf(1.0f - zl * zl, 0.0f));
    const float phl = kTwoPi * f.u[1];
    float sl, cl;
    sincosf(phl, &sl, &cl);
    f.l[0] = f.nf[0] + rl * cl;
    f.l[1] = f.nf[1] + rl * sl;
    f.l[2] = f.nf[2] + zl;
    normalize_or(f.l, f.nf, f.ln2, f.lm, f.linv, f.ldeg, f.sd);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) f.at[c] = f.is_diel ? 1.0f : f.alb[c];
  f.surv0 = scattered;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    f.nt[c] = f.surv0 ? f.tp[c] * f.at[c] : f.tp[c];
    f.no[c] = f.p[c];
    f.nd[c] = f.surv0 ? f.sd[c] : f.d[c];
    f.rad[c] = 0.0f;
  }
  f.surv = f.surv0;
  f.boost = false;
  if (rr_on) {
    f.m1 = fmaxf(f.nt[0], f.nt[1]);
    f.m2 = fmaxf(f.m1, f.nt[2]);
    f.q1 = fmaxf(0.05f, f.m2);
    f.qq = fminf(1.0f, f.q1);
    f.surv = f.surv0 && !(f.do_rr && f.u[6] >= f.qq);
    f.boost = f.do_rr && f.surv;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) f.ntp[c] = f.boost ? f.nt[c] / f.qq : f.nt[c];
}

// d/dx of inv = rsqrt(max(x, floor)) (ops/bounce.py:_rsqrt_adj).
__device__ __forceinline__ float rsqrt_adj(float g_inv, float inv, float m,
                                           float x, float floor) {
  return g_inv * (-0.5f * (inv / m)) * wmax(x, floor);
}

// Cotangents of (o, d, tp, a9, sky6) from those of (o', d', tp', rad) for
// an alive lane: ops/bounce.py:bounce_tile_adjoint.
__device__ void bounce_adjoint(const Bounce& f, bool rr_on,
                               const float* ct_o, const float* ct_d,
                               const float* ct_tp, const float* ct_rad,
                               float* g_o, float* g_d, float* g_tp,
                               float* g_a9, float* g_sky) {
  float g_nt[3] = {ct_tp[0], ct_tp[1], ct_tp[2]};
  if (rr_on && f.boost) {
    // nt' = nt / q, q = clip(max3(nt), 0.05, 1).
    float g_q = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      g_q = g_q + (-g_nt[c] * f.nt[c]) * (1.0f / (f.qq * f.qq));
      g_nt[c] = g_nt[c] / f.qq;
    }
    const float g_q1 = g_q * wmin(f.q1, 1.0f);
    const float g_m2 = g_q1 * wmax(f.m2, 0.05f);
    const float g_m1 = g_m2 * wmax(f.m1, f.nt[2]);
    g_nt[2] = g_nt[2] + g_m2 * wmax(f.nt[2], f.m1);
    g_nt[0] = g_nt[0] + g_m1 * wmax(f.nt[0], f.nt[1]);
    g_nt[1] = g_nt[1] + g_m1 * wmax(f.nt[1], f.nt[0]);
  }
  if (!f.hit) {
    // Miss: radiance tp * sky(d), everything else passes through.
    float g_sk[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      g_tp[c] = g_nt[c] + ct_rad[c] * f.sk[c];
      g_sk[c] = ct_rad[c] * f.tp[c];
      const float g_w = g_sk[c] * f.s01;
      g_sky[c + 3] = g_w;
      g_sky[c] = g_sk[c] - g_w;
      g_o[c] = ct_o[c];
      g_d[c] = ct_d[c];
    }
    const float g_s01 = g_sk[0] * f.skw[0] + g_sk[1] * f.skw[1] +
                        g_sk[2] * f.skw[2];
    g_d[1] = g_d[1] + 0.5f * g_s01;
#pragma unroll
    for (int j = 0; j < 9; ++j) g_a9[j] = 0.0f;
    return;
  }

  // Throughput and attenuation.
  float g_alb[3], g_sd[3], g_p[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    g_tp[c] = f.surv0 ? g_nt[c] * f.at[c] : g_nt[c];
    const float g_at = f.surv0 ? g_nt[c] * f.tp[c] : 0.0f;
    g_alb[c] = f.is_diel ? 0.0f : g_at;
    g_sky[c] = 0.0f;
    g_sky[c + 3] = 0.0f;
    g_o[c] = 0.0f;
    g_d[c] = f.surv0 ? 0.0f : ct_d[c];
    g_sd[c] = f.surv0 ? ct_d[c] : 0.0f;
    g_p[c] = ct_o[c];
  }

  // Scatter: the lane's material only.
  float g_nf[3] = {0.0f, 0.0f, 0.0f};
  float g_rf[3] = {0.0f, 0.0f, 0.0f};
  float g_dnf = 0.0f, g_fz = 0.0f, g_io = 0.0f;
  if (f.is_metal) {
    float g_m[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) g_m[c] = g_sd[c] * f.minv;
    const float g_mn2 =
        rsqrt_adj(dot3(g_sd, f.m), f.minv, f.mm, f.mn2, 1e-20f);
#pragma unroll
    for (int c = 0; c < 3; ++c) g_m[c] = g_m[c] + 2.0f * (g_mn2 * f.m[c]);
    if (f.mdeg) {
#pragma unroll
      for (int c = 0; c < 3; ++c) g_nf[c] = g_sd[c];
    } else {
      const float g_bs =
          (g_m[0] * f.cm + g_m[1] * f.sm) * f.rm + g_m[2] * f.zm;
      g_fz = g_bs * f.bs0;
#pragma unroll
      for (int c = 0; c < 3; ++c) g_rf[c] = g_m[c];
    }
  } else if (f.is_diel) {
    float g_g[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) g_g[c] = g_sd[c] * f.ginv;
    const float g_gn2 =
        rsqrt_adj(dot3(g_sd, f.g), f.ginv, f.gm, f.gn2, 1e-20f);
#pragma unroll
    for (int c = 0; c < 3; ++c) g_g[c] = g_g[c] + 2.0f * (g_gn2 * f.g[c]);
    if (f.gdeg) {
#pragma unroll
      for (int c = 0; c < 3; ++c) g_nf[c] = g_sd[c];
    } else if (f.do_refl) {
#pragma unroll
      for (int c = 0; c < 3; ++c) g_rf[c] = g_g[c];
    } else {
      // Refraction: g = eta (d + cos_t nf) - par nf.
      const float g_par = -dot3(g_g, f.nf);
      const float g_px =
          g_par * ((1.0f / f.par) * 0.5f) * wmax(f.px, 1e-12f);
      float g_pp[3], g_in[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) g_pp[c] = g_g[c] + 2.0f * ((-g_px) * f.pp[c]);
      const float g_eta = dot3(g_pp, f.inner);
#pragma unroll
      for (int c = 0; c < 3; ++c) g_in[c] = g_pp[c] * f.eta;
      const float g_cos = dot3(g_in, f.nf);
      g_dnf = -(g_cos * wmin(-f.dnf, 1.0f));
      g_io = f.front ? (-g_eta) * (1.0f / (f.io * f.io)) : g_eta;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        g_nf[c] = -(g_g[c] * f.par) + g_in[c] * f.cos_t;
        g_d[c] = g_d[c] + g_in[c];
      }
    }
  } else {
    float g_l[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) g_l[c] = g_sd[c] * f.linv;
    const float g_ln2 =
        rsqrt_adj(dot3(g_sd, f.l), f.linv, f.lm, f.ln2, 1e-20f);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      g_l[c] = g_l[c] + 2.0f * (g_ln2 * f.l[c]);
      g_nf[c] = f.ldeg ? g_sd[c] : g_l[c];
    }
  }

  // Mirror direction rf = d - two_dn nf, two_dn = 2 (d . nf).
  const float g_two_dn = -dot3(g_rf, f.nf);
  g_dnf = g_dnf + 2.0f * g_two_dn;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    g_d[c] = g_d[c] + g_rf[c];
    g_nf[c] = g_nf[c] - g_rf[c] * f.two_dn;
  }
  float g_n[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    g_d[c] = g_d[c] + g_dnf * f.nf[c];
    g_nf[c] = g_nf[c] + g_dnf * f.d[c];
    g_n[c] = g_nf[c] * f.fsign;
  }

  // Normal: face-forward plane normal on plane lanes, else normalized
  // (p - c) / r.
  float g_c[3], g_r = 0.0f;
  if (f.pm) {
#pragma unroll
    for (int c = 0; c < 3; ++c) g_c[c] = f.psgn * g_n[c];
  } else {
    float g_n0[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) g_n0[c] = g_n[c] * f.ninv;
    const float g_ninv = dot3(g_n, f.n0);
    const float g_sn = (-g_ninv) * (1.0f / (f.sn * f.sn));
    const float g_nn = g_sn * ((1.0f / f.sn) * 0.5f);
    float g_rn = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) g_n0[c] = g_n0[c] + 2.0f * (g_nn * f.n0[c]);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      g_rn = g_rn + (-g_n0[c] * f.q[c]) * (1.0f / (f.r * f.r));
    g_r = g_rn;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float g_q = g_n0[c] / f.r;
      g_p[c] = g_p[c] + g_q;
      g_c[c] = 0.0f - g_q;
    }
  }

  // Hit point p = o + t d.
  const float g_t = dot3(g_p, f.d);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    g_o[c] = g_o[c] + g_p[c];
    g_d[c] = g_d[c] + g_p[c] * f.t;
  }

  if (f.pm) {
    // t = (-(o . n) - k) / (d . n); the normal n is not a parameter, its
    // slots' cotangents are dropped by the caller.
    const float g_num = g_t / f.den_s;
    const float g_den =
        f.live_d ? ((-g_t) * f.num) * (1.0f / (f.den_s * f.den_s)) : 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      g_d[c] = g_d[c] + g_den * f.c[c];
      g_c[c] = g_c[c] + g_den * f.d[c];
      g_o[c] = g_o[c] + (-g_num) * f.c[c];
      g_c[c] = g_c[c] + (-g_num) * f.o[c];
    }
    g_r = g_r + (-g_num);
  } else {
    // Sphere t = near ? tc - sq : tc + sq.
    const float g_sq = f.use_near ? -g_t : g_t;
    const float g_disc =
        g_sq * ((1.0f / f.sq) * 0.5f) * wmax(f.disc, 1e-12f);
    const float g_tc = g_t + 2.0f * (g_disc * f.tc);
    g_r = g_r + 2.0f * (g_disc * f.r);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float g_oc = 2.0f * ((-g_disc) * f.oc[c]) + g_tc * f.d[c];
      g_d[c] = g_d[c] + g_tc * f.oc[c];
      g_c[c] = g_c[c] + g_oc;
      g_o[c] = g_o[c] - g_oc;
    }
  }
  g_a9[0] = g_c[0];
  g_a9[1] = g_c[1];
  g_a9[2] = g_c[2];
  g_a9[3] = g_r;
  g_a9[4] = g_alb[0];
  g_a9[5] = g_alb[1];
  g_a9[6] = g_alb[2];
  g_a9[7] = g_fz;
  g_a9[8] = g_io;
}

// The winner's 9 attributes and material for index bi: a sphere slot, the
// ground plane (unit normal, offset, albedo; fuzz 0, ior 1), or a miss
// (the scan's defaults: r = 1, ior = 1, the rest 0).
__device__ __forceinline__ void winner_attrs(const SphereTables& t,
                                             const float* pl, int bi,
                                             float* w, int& mat) {
  if (bi == kPlaneIdx) {
#pragma unroll
    for (int j = 0; j < 7; ++j) w[j] = pl[j];
    w[7] = 0.0f;
    w[8] = 1.0f;
    mat = kLambertian;
  } else if (bi >= 0) {
    const float4 g = t.geo[bi], a = t.att[bi];
    const float2 a2 = t.att2[bi];
    w[0] = g.x; w[1] = g.y; w[2] = g.z; w[3] = g.w;
    w[4] = a.x; w[5] = a.y; w[6] = a.z; w[7] = a.w;
    w[8] = a2.x;
    mat = static_cast<int>(a2.y);
  } else {
    w[0] = w[1] = w[2] = 0.0f;
    w[3] = 1.0f;
    w[4] = w[5] = w[6] = w[7] = 0.0f;
    w[8] = 1.0f;
    mat = kLambertian;
  }
}

struct Consts {
  float sky[6], pl[7], cam[19];
};

// consts: sky lo/hi 0:6, plane 6:13 (normal, offset, albedo), camera 13:32.
__device__ __forceinline__ void load_consts(const float* __restrict__ src,
                                            Consts& k) {
#pragma unroll
  for (int i = 0; i < 6; ++i) k.sky[i] = src[i];
#pragma unroll
  for (int i = 0; i < 7; ++i) k.pl[i] = src[6 + i];
#pragma unroll
  for (int i = 0; i < 19; ++i) k.cam[i] = src[13 + i];
}

__device__ __forceinline__ uint32_t lane_pixel(const int* __restrict__ ids,
                                               int n_pix, int n_lanes, int kb,
                                               int lane) {
  long long pos = static_cast<long long>(kb) * n_lanes + lane;
  if (pos > n_pix - 1) pos = n_pix - 1;  // overflow positions repeat the last
  return static_cast<uint32_t>(ids[pos]);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) regen_kernel(
    const int* __restrict__ pixel_ids, int n_pix, int n_lanes, int n_banks,
    const float* __restrict__ tab, int n_spheres,
    const float* __restrict__ consts, int use_plane, uint32_t k0, uint32_t k1,
    uint32_t sample_offset, int n_samples, int max_depth, int width,
    float inv_w, float inv_h, float t_min, float t_max, int rr_start_depth,
    int n_iter, const int* __restrict__ idx_in, float* __restrict__ out_rad,
    float* __restrict__ out_cnt, float* __restrict__ resf,
    int* __restrict__ resi, int* __restrict__ packed) {
  extern __shared__ float4 smem[];
  const SphereTables tabs = load_sphere_tables(smem, tab, n_spheres);
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  Consts k;
  load_consts(consts, k);
  const size_t L = static_cast<size_t>(n_lanes);
  const size_t plane_stride = static_cast<size_t>(n_iter) * L;
  auto fp = [&](int plane, int it) -> float& {
    return resf[plane * plane_stride + static_cast<size_t>(it) * L + lane];
  };
  auto ip = [&](int plane, int it) -> int& {
    return resi[plane * plane_stride + static_cast<size_t>(it) * L + lane];
  };
  const bool rr_on = rr_start_depth != 0;

  int kb = 0, s = 0, b = 0;
  bool alive = false;
  float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 1.0f};
  float tp[3] = {1.0f, 1.0f, 1.0f}, acc[3] = {0.0f, 0.0f, 0.0f};
  uint32_t pix = 0;
  int word = 0;
  int it = 0;
  for (; it < n_iter; ++it) {
    const bool regen = !alive && kb < n_banks;
    if (!alive && !regen) break;  // every bank done: the rest is dead
    const uint32_t c1b = (sample_offset + static_cast<uint32_t>(s)) << 8;
    if (regen) {
      // Next sample (or the next bank's pixel): a fresh camera ray.
      pix = lane_pixel(pixel_ids, n_pix, n_lanes, kb, lane);
      const float xf = static_cast<float>(pix % static_cast<uint32_t>(width));
      const float yf = static_cast<float>(pix / static_cast<uint32_t>(width));
      camera_ray(k.cam, k0, k1, pix, c1b, xf, yf, inv_w, inv_h, o[0], o[1],
                 o[2], d[0], d[1], d[2]);
      tp[0] = tp[1] = tp[2] = 1.0f;
      b = 0;
      alive = true;
    }
    if (MODE != kModeIdx) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        fp(c, it) = o[c];
        fp(3 + c, it) = d[c];
        fp(6 + c, it) = tp[c];
      }
      fp(kFAlive, it) = 1.0f;
      fp(kFRegen, it) = regen ? 1.0f : 0.0f;
      ip(kIKb, it) = kb;
      ip(kIS, it) = s;
      ip(kIB, it) = b;
    }
    const int field = it % 3;
    int bi;
    if (MODE == kModeRefwd) {
      // The recorded winner instead of the scan.
      if (field == 0) word = idx_in[static_cast<size_t>(it / 3) * L + lane];
      bi = ((word >> (kIdxBits * field)) & kIdxMask) - 1;
    } else {
      float bt = t_max;
      bi = closest_hit(tabs.geo, n_spheres, o[0], o[1], o[2], d[0], d[1],
                       d[2], t_min, bt);
      float tpl, sgn;
      if (use_plane && plane_wins(k.pl, o[0], o[1], o[2], d[0], d[1], d[2],
                                  t_min, bt, tpl, sgn))
        bi = kPlaneIdx;
    }
    Bounce f;
    float w[9];
    winner_attrs(tabs, k.pl, bi, w, f.mat);
    if (MODE == kModeIdx) {
      const int v = bi + 1;
      word = field == 0 ? v : word + v * (1 << (kIdxBits * field));
      if (field == 2) packed[static_cast<size_t>(it / 3) * L + lane] = word;
    } else {
      ip(kIIdx, it) = bi;
      ip(kIMat, it) = f.mat;
#pragma unroll
      for (int j = 0; j < 9; ++j) fp(kFAttr + j, it) = w[j];
    }

    // The hard bounce.
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      f.o[c] = o[c];
      f.d[c] = d[c];
      f.tp[c] = tp[c];
      f.c[c] = w[c];
      f.alb[c] = w[4 + c];
    }
    f.r = w[3];
    f.fz = w[7];
    f.io = w[8];
    f.hit = bi >= 0;
    f.pm = use_plane && bi == kPlaneIdx;
    f.do_rr = b >= rr_start_depth;
    bounce_uniforms(k0, k1, pix, c1b, static_cast<uint32_t>(b), f.u);
    bounce_forward(f, k.sky, t_min, t_max, rr_on);
    const bool surv = f.surv && b + 1 < max_depth;
    if (!f.hit) {
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[c] = acc[c] + f.rad[c];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c] = f.no[c];
      d[c] = f.nd[c];
      tp[c] = f.ntp[c];
    }
    if (surv) {
      ++b;
    } else if (++s >= n_samples) {
      // The bank's last sample ended: its pixel's sum is complete.
      const long long pos = static_cast<long long>(kb) * n_lanes + lane;
      if (MODE != kModeRefwd && pos < n_pix) {
#pragma unroll
        for (int c = 0; c < 3; ++c) out_rad[3 * pos + c] = acc[c];
      }
      acc[0] = acc[1] = acc[2] = 0.0f;
      s = 0;
      ++kb;
    }
    alive = surv;
  }
  if (MODE != kModeRefwd) out_cnt[lane] = static_cast<float>(it);
  // Iterations after the lane's end read as dead.
  for (; it < n_iter; ++it) {
    if (MODE == kModeIdx) {
      const int field = it % 3;
      if (field == 0) word = 0;
      if (field == 2) packed[static_cast<size_t>(it / 3) * L + lane] = word;
    } else {
      fp(kFAlive, it) = 0.0f;
      ip(kIIdx, it) = -1;
    }
  }
}

__global__ void __launch_bounds__(kThreads) regen_bwd_kernel(
    const int* __restrict__ pixel_ids, int n_pix, int n_lanes, int n_banks,
    const float* __restrict__ consts, int use_plane, uint32_t k0, uint32_t k1,
    uint32_t sample_offset, int n_iter, float t_min, float t_max,
    int rr_start_depth, const float* __restrict__ resf,
    const int* __restrict__ resi, const float* __restrict__ ct_rad,
    float* __restrict__ ct_planes, float* __restrict__ partials) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  Consts k;
  load_consts(consts, k);
  const size_t L = static_cast<size_t>(n_lanes);
  const size_t plane_stride = static_cast<size_t>(n_iter) * L;
  auto fp = [&](int plane, int it) -> float {
    return resf[plane * plane_stride + static_cast<size_t>(it) * L + lane];
  };
  auto ip = [&](int plane, int it) -> int {
    return resi[plane * plane_stride + static_cast<size_t>(it) * L + lane];
  };
  auto ct = [&](int j, int it) -> float& {
    return ct_planes[j * plane_stride + static_cast<size_t>(it) * L + lane];
  };
  const bool rr_on = rr_start_depth != 0;

  float co[3] = {0.0f, 0.0f, 0.0f}, cd[3] = {0.0f, 0.0f, 0.0f};
  float ctp[3] = {0.0f, 0.0f, 0.0f};
  float sky_part[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float pl_part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int it = n_iter - 1; it >= 0; --it) {
    if (!(fp(kFAlive, it) > 0.0f)) {
      // Dead iteration: the carried cotangents pass through.
#pragma unroll
      for (int j = 0; j < 9; ++j) ct(j, it) = 0.0f;
      continue;
    }
    Bounce f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      f.o[c] = fp(c, it);
      f.d[c] = fp(3 + c, it);
      f.tp[c] = fp(6 + c, it);
      f.c[c] = fp(kFAttr + c, it);
      f.alb[c] = fp(kFAttr + 4 + c, it);
    }
    f.r = fp(kFAttr + 3, it);
    f.fz = fp(kFAttr + 7, it);
    f.io = fp(kFAttr + 8, it);
    const int kb = ip(kIKb, it), s = ip(kIS, it), b = ip(kIB, it);
    const int idx = ip(kIIdx, it);
    f.mat = ip(kIMat, it);
    f.hit = idx >= 0;
    f.pm = use_plane && idx == kPlaneIdx;
    f.do_rr = b >= rr_start_depth;
    // The lane's bank: its pixel (for the uniforms) and radiance cotangent.
    const uint32_t pix = lane_pixel(pixel_ids, n_pix, n_lanes, kb, lane);
    const long long pos = static_cast<long long>(kb) * n_lanes + lane;
    float ctr[3] = {0.0f, 0.0f, 0.0f};
    if (pos < n_pix) {
#pragma unroll
      for (int c = 0; c < 3; ++c) ctr[c] = ct_rad[3 * pos + c];
    }
    const uint32_t c1b = (sample_offset + static_cast<uint32_t>(s)) << 8;
    bounce_uniforms(k0, k1, pix, c1b, static_cast<uint32_t>(b), f.u);
    bounce_forward(f, k.sky, t_min, t_max, rr_on);
    float g_o[3], g_d[3], g_tp[3], g_a9[9], g_sky[6];
    bounce_adjoint(f, rr_on, co, cd, ctp, ctr, g_o, g_d, g_tp, g_a9, g_sky);
#pragma unroll
    for (int j = 0; j < 9; ++j) ct(j, it) = f.hit ? g_a9[j] : 0.0f;
#pragma unroll
    for (int c = 0; c < 6; ++c) sky_part[c] = sky_part[c] + g_sky[c];
    if (f.pm) {
      // Plane offset = the r slot; albedo 1:1; the normal slots dropped.
#pragma unroll
      for (int j = 0; j < 4; ++j) pl_part[j] = pl_part[j] + g_a9[3 + j];
    }
    // A chain's camera ray starts here: the prior chain's final state has
    // no consumers, so the carried cotangents restart from zero.
    const bool regen = fp(kFRegen, it) > 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      co[c] = regen ? 0.0f : g_o[c];
      cd[c] = regen ? 0.0f : g_d[c];
      ctp[c] = regen ? 0.0f : g_tp[c];
    }
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) partials[c * L + lane] = sky_part[c];
#pragma unroll
  for (int j = 0; j < 4; ++j) partials[(6 + j) * L + lane] = pl_part[j];
}

template <int MODE>
cudaError_t launch_regen(const void* pixel_ids, int n_pix, int n_lanes,
                         int n_banks, const void* tab, int n_spheres,
                         const void* consts, int use_plane, uint32_t k0,
                         uint32_t k1, uint32_t sample_offset, int n_samples,
                         int max_depth, int width, float inv_w, float inv_h,
                         float t_min, float t_max, int rr_start_depth,
                         int n_iter, const void* idx_in, void* out_rad,
                         void* out_cnt, void* resf, void* resi, void* packed,
                         cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n_spheres) * kSmemPerSphere;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        regen_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  regen_kernel<MODE><<<blocks, kThreads, smem, stream>>>(
      static_cast<const int*>(pixel_ids), n_pix, n_lanes, n_banks,
      static_cast<const float*>(tab), n_spheres,
      static_cast<const float*>(consts), use_plane, k0, k1, sample_offset,
      n_samples, max_depth, width, inv_w, inv_h, t_min, t_max, rr_start_depth,
      n_iter, static_cast<const int*>(idx_in), static_cast<float*>(out_rad),
      static_cast<float*>(out_cnt), static_cast<float*>(resf),
      static_cast<int*>(resi), static_cast<int*>(packed));
  return cudaGetLastError();
}

}  // namespace
}  // namespace spt

// Recording forward (mode 0: the 25 planes, 1: packed winner indices) or
// re-forward from packed indices (mode 2), on the caller's stream.
// Returns cudaGetLastError() (0 = launched).
extern "C" int spt_regen_forward(
    const void* pixel_ids, int n_pix, int n_lanes, int n_banks,
    const void* tab, int n_spheres, const void* consts, int use_plane,
    unsigned int k0, unsigned int k1, unsigned int sample_offset,
    int n_samples, int max_depth, int width, float inv_w, float inv_h,
    float t_min, float t_max, int rr_start_depth, int n_iter, int mode,
    const void* idx_in, void* out_rad, void* out_cnt, void* resf, void* resi,
    void* packed, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPT_ARGS                                                           \
  pixel_ids, n_pix, n_lanes, n_banks, tab, n_spheres, consts, use_plane, k0, \
      k1, sample_offset, n_samples, max_depth, width, inv_w, inv_h, t_min,   \
      t_max, rr_start_depth, n_iter, idx_in, out_rad, out_cnt, resf, resi,   \
      packed, st
  cudaError_t err;
  switch (mode) {
    case spt::kModeFull: err = spt::launch_regen<spt::kModeFull>(SPT_ARGS); break;
    case spt::kModeIdx: err = spt::launch_regen<spt::kModeIdx>(SPT_ARGS); break;
    case spt::kModeRefwd: err = spt::launch_regen<spt::kModeRefwd>(SPT_ARGS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPT_ARGS
  return static_cast<int>(err);
}

// Backward over one chunk's residual planes, on the caller's stream.
extern "C" int spt_regen_backward(
    const void* pixel_ids, int n_pix, int n_lanes, int n_banks,
    const void* consts, int use_plane, unsigned int k0, unsigned int k1,
    unsigned int sample_offset, int n_iter, float t_min, float t_max,
    int rr_start_depth, const void* resf, const void* resi,
    const void* ct_rad, void* ct_planes, void* partials, void* stream) {
  const int blocks = (n_lanes + spt::kThreads - 1) / spt::kThreads;
  spt::regen_bwd_kernel<<<blocks, spt::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pixel_ids), n_pix, n_lanes, n_banks,
      static_cast<const float*>(consts), use_plane, k0, k1, sample_offset,
      n_iter, t_min, t_max, rr_start_depth, static_cast<const float*>(resf),
      static_cast<const int*>(resi), static_cast<const float*>(ct_rad),
      static_cast<float*>(ct_planes), static_cast<float*>(partials));
  return static_cast<int>(cudaGetLastError());
}
