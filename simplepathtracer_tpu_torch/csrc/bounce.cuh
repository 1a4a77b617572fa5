// One differentiable bounce and its hand-written adjoint, as CUDA device
// code shared by the gradient kernels (grad_regen.cu: the regeneration
// kernels; grad.cu: the per-bounce fused kernels).  Counterpart of the JAX
// package's ops/pallas_grad.py:bounce_tile and its in-kernel jax.vjp:
// bounce_forward / bounce_adjoint mirror the plain PyTorch
// ops/bounce.py:_forward / bounce_tile_adjoint line by line, and
// soft_forward / soft_adjoint mirror _soft_forward / _soft_adjoint there.
//
// Everything here has internal linkage (an unnamed namespace, templates),
// so each kernel source that includes it compiles its own copy: the
// library builds one object per source without relocatable device code.
//
// Numerics: as common.cuh (--fmad=false, IEEE sqrt and division).  Where
// the plain version divides a constant by a tensor, PyTorch computes
// reciprocal(x) * c; the code below does the same.

#pragma once

#include "common.cuh"

namespace spt {
namespace {

constexpr int kIdxBits = 10;
constexpr int kIdxMask = (1 << kIdxBits) - 1;
constexpr int kPlaneIdx = kIdxMask - 1;  // winner code of a ground-plane hit
// Soft, plane won the crossing coin: the blocker slot holds the loser.
constexpr int kPlaneCrossIdx = kIdxMask - 2;
// Variants: hard, soft silhouettes, soft silhouettes with a ground plane.
constexpr int kHard = 0;
constexpr int kSoft = 1;
constexpr int kSoftPlane = 2;
constexpr float kSilR0 = 8.0f;
constexpr float kPFloor = 1e-2f;  // SIL_P_FLOOR

__device__ __forceinline__ bool is_plane_code(int idx) {
  return idx >= kPlaneCrossIdx;
}

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
  // soft: the winner's silhouette scale, capped sqrt and raw root
  float sw, capped, t_raw;
};

// The dielectric's Schlick terms from eta and cos_t: total internal
// reflection, r0 = ((1 - eta) / (1 + eta))^2 and reflect_prob = r0 +
// (1 - r0) (1 - cos_t)^5 with its intermediates (the forward and the
// SIL_FRESNEL adjoint compute them alike).
struct Schlick {
  bool cannot;
  float r0s, r0, omc, omc2, refl_p;
};

__device__ __forceinline__ Schlick schlick(float eta, float cos_t) {
  Schlick s;
  const float sin2 = fmaxf(1.0f - cos_t * cos_t, 0.0f);
  s.cannot = eta * eta * sin2 > 1.0f;
  s.r0s = (1.0f - eta) / (1.0f + eta);
  s.r0 = s.r0s * s.r0s;
  s.omc = 1.0f - cos_t;
  s.omc2 = s.omc * s.omc;
  s.refl_p = s.r0 + (1.0f - s.r0) * s.omc2 * s.omc2 * s.omc;
  return s;
}

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

// The winner's hit reconstruction up to its raw root t_raw: soft
// silhouettes cap the sqrt's derivative at the band scale sw (value
// (exact - capped) + capped, as ops/intersect.py:grad_capped_sqrt).
template <int V>
__device__ __forceinline__ void hit_root(Bounce& f, float t_min,
                                         float sil_c) {
#pragma unroll
  for (int c = 0; c < 3; ++c) f.oc[c] = f.c[c] - f.o[c];
  f.tc = dot3(f.oc, f.d);
  const float oc2 = dot3(f.oc, f.oc);
  f.disc = f.r * f.r - (oc2 - f.tc * f.tc);
  const float dmax = fmaxf(f.disc, 1e-12f);
  if constexpr (V != kHard) {
    f.sw = (f.r * f.r) * sil_c / (kSilR0 + fabsf(f.r));
    f.capped = sqrtf(dmax + f.sw);
    f.sq = (sqrtf(dmax) - f.capped) + f.capped;
  } else {
    f.sq = sqrtf(dmax);
  }
  const float t_near = f.tc - f.sq;
  f.use_near = t_near > t_min;
  f.t_raw = f.use_near ? t_near : f.tc + f.sq;
}

template <int V>
__device__ void bounce_forward(Bounce& f, const float* sky, float t_min,
                               float t_max, bool rr_on, float sil_c) {
  f.s01 = 0.5f * (f.d[1] + 1.0f);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    f.skw[c] = sky[c + 3] - sky[c];
    f.sk[c] = sky[c] + f.skw[c] * f.s01;
  }
  if constexpr (V != kHard) {
    // Soft: the root on every lane (a miss lane's default winner too),
    // as the plain version computes it; t_max on a miss.
    hit_root<V>(f, t_min, sil_c);
    f.t = t_max;
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
  // Hit rebuilt from the winner's attributes (soft: clamped to t_min, a
  // coin-validated marginal candidate hits at t_min, never behind).
  if constexpr (V == kHard) {
    hit_root<V>(f, t_min, sil_c);
    f.t = f.t_raw;
  } else {
    f.t = fmaxf(f.t_raw, t_min);
  }
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
    const Schlick sc = schlick(f.eta, f.cos_t);
    f.do_refl = sc.cannot || f.u[5] < sc.refl_p;
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

// d min(a, b) / da on the clip's upper bound and d max on its lower:
// x_c = min(max(x, -30), 30) (ops/bounce.py:_clip30 / _clip_adj).
__device__ __forceinline__ float clip_adj(float g, float m, float x) {
  return (g * wmin(m, 30.0f)) * wmax(x, -30.0f);
}

// Cotangent of x through sig = 1 / (1 + e), e = exp(-x).
__device__ __forceinline__ float sig_adj(float g, float sig, float e) {
  return (g * (sig * sig)) * e;
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// Soft constants: f32(softness), f32(softness * 8) (the silhouette
// scale's factor), f32(softness * 0.1) (the validity scale), and 1 where
// the detached Schlick-coin ratio (intersect.SIL_FRESNEL) is on, else 0.
struct SoftK {
  float soft, sil_c, sigv, fresnel;
};

// Cotangents of (cos_t, eta) through a dielectric hit's attenuation
// p / stop_grad(p), p = max(p_evt, floor), p_evt = reflect_prob on a
// reflection (1 under total internal reflection), else 1 - reflect_prob,
// from its cotangent g_att (ops/bounce.py:_fresnel_adjoint).
__device__ __forceinline__ void fresnel_adjoint(const Bounce& f, float g_att,
                                                float& g_cos, float& g_eta) {
  const Schlick sc = schlick(f.eta, f.cos_t);
  const float pevt = f.do_refl ? (sc.cannot ? 1.0f : sc.refl_p) : 1.0f - sc.refl_p;
  const float pf = fmaxf(pevt, kPFloor);
  const float g_pevt = (g_att / pf) * wmax(pevt, kPFloor);
  const float g_rp = f.do_refl ? (sc.cannot ? 0.0f : g_pevt) : -g_pevt;
  const float omr0 = 1.0f - sc.r0;
  const float a1 = omr0 * sc.omc2;
  const float a2 = a1 * sc.omc2;
  const float g_a2 = g_rp * sc.omc;
  float g_omc = g_rp * a2;
  const float g_a1 = g_a2 * sc.omc2;
  const float g_omc2 = g_a2 * a1 + g_a1 * omr0;
  const float g_r0 = g_rp - g_a1 * sc.omc2;
  g_omc = g_omc + 2.0f * (g_omc2 * sc.omc);
  const float g_r0s = 2.0f * (g_r0 * sc.r0s);
  const float den = 1.0f + f.eta;
  g_eta = -(g_r0s / den) + ((-g_r0s) * (1.0f - f.eta)) * (1.0f / (den * den));
  g_cos = -g_omc;
}

// Cotangent of r through silhouette_scale = ((r r) c) / (R0 + |r|).
__device__ __forceinline__ float scale_adj(float g, float r, const SoftK& k) {
  const float num = (r * r) * k.sil_c;
  const float den = kSilR0 + fabsf(r);
  const float g_num = g / den;
  const float g_den = ((-g) * num) * (1.0f / (den * den));
  return 2.0f * ((g_num * k.sil_c) * r) + g_den * sign_of(r);
}

// Cotangent of r through crossing_scale = ((soft |r|) R0) / (R0 + |r|).
__device__ __forceinline__ float xscale_adj(float g, float r,
                                            const SoftK& k) {
  const float a = fabsf(r);
  const float num = (k.soft * a) * kSilR0;
  const float den = kSilR0 + a;
  const float g_num = g / den;
  const float g_den = ((-g) * num) * (1.0f / (den * den));
  return ((g_num * kSilR0) * k.soft + g_den) * sign_of(r);
}

__device__ __forceinline__ float crossing_scale(float r, const SoftK& k) {
  const float a = fabsf(r);
  return k.soft * a * kSilR0 / (kSilR0 + a);
}

// The soft ratio's intermediates (ops/bounce.py:_soft_forward).
struct Soft {
  // winner opacity We and validity Ve
  float sw1, xr, xm, ew, w, we, v1, vr, vm, ev, v, ve;
  bool wm;
  // blocker
  float bc[3], br, ocb[3], tcb, discb, sb, sb1, xbr, xbm, eb, mb, sqb;
  float vb1, vbr, vbm, evb, vbv, wb, vb, mw, mv, pout, den1, den;
  bool use_nb, bval, fb;
  // crossing factor (plane scenes)
  float den4s, num4, sxw1, qsn, qsr, qsm, eqs, qs, cappedb, t_raw_bx;
  float sxb1, qpn, qpr, qpm, eqp, qp, qf;
  bool live4, qsel, use_nbx, cl;
};

// den = max(We Ve - [fb] min(We, Wb) min(Ve, Vb), floor) * qf for an alive
// lane after bounce_forward (ops/bounce.py:_soft_forward).  pl: the unit
// normal and offset of the plane (kSoftPlane).
template <int V>
__device__ void soft_forward(const Bounce& f, Soft& s, const SoftK& k,
                             bool cross_loser, const float* pl, float t_min,
                             float t_max) {
  s.sw1 = f.sw + 1e-12f;
  s.xr = f.disc / s.sw1;
  s.xm = fmaxf(s.xr, -30.0f);
  s.ew = expf(-fminf(s.xm, 30.0f));
  s.w = 1.0f / (1.0f + s.ew);
  s.wm = f.hit && !f.pm;
  s.we = s.wm ? s.w : 1.0f;
  s.v1 = k.sigv + 1e-12f;
  s.vr = (f.t_raw - t_min) / s.v1;
  s.vm = fmaxf(s.vr, -30.0f);
  s.ev = expf(-fminf(s.vm, 30.0f));
  s.v = 1.0f / (1.0f + s.ev);
  s.ve = s.wm ? s.v : 1.0f;
  // Blocker.
#pragma unroll
  for (int c = 0; c < 3; ++c) s.ocb[c] = s.bc[c] - f.o[c];
  s.tcb = dot3(s.ocb, f.d);
  const float ocb2 = dot3(s.ocb, s.ocb);
  s.discb = s.br * s.br - (ocb2 - s.tcb * s.tcb);
  s.sb = (s.br * s.br) * k.sil_c / (kSilR0 + fabsf(s.br));
  s.sb1 = s.sb + 1e-12f;
  s.xbr = s.discb / s.sb1;
  s.xbm = fmaxf(s.xbr, -30.0f);
  s.eb = expf(-fminf(s.xbm, 30.0f));
  s.mb = 1.0f / (1.0f + s.eb);
  const float dmaxb = fmaxf(s.discb, 1e-12f);
  s.sqb = sqrtf(dmaxb);
  const float tnb = s.tcb - s.sqb;
  s.use_nb = tnb > t_min;
  const float t_raw_b = s.use_nb ? tnb : s.tcb + s.sqb;
  const float t_b = fmaxf(t_raw_b, t_min);
  s.vb1 = k.sigv + 1e-12f;
  s.vbr = (t_raw_b - t_min) / s.vb1;
  s.vbm = fmaxf(s.vbr, -30.0f);
  s.evb = expf(-fminf(s.vbm, 30.0f));
  s.vbv = 1.0f / (1.0f + s.evb);
  const bool front = V == kSoftPlane ? s.bval && !cross_loser : s.bval;
  s.fb = front && t_b < f.t;
  s.wb = s.fb ? s.mb : 0.0f;
  s.vb = s.fb ? s.vbv : 1.0f;
  s.mw = fminf(s.we, s.wb);
  s.mv = fminf(s.ve, s.vb);
  const float blk = s.fb ? s.mw * s.mv : 0.0f;
  s.pout = s.we * s.ve - blk;
  s.den1 = fmaxf(s.pout, kPFloor);
  s.den = s.den1;
  if constexpr (V == kSoftPlane) {
    const float den4 = f.d[0] * pl[0] + f.d[1] * pl[1] + f.d[2] * pl[2];
    s.live4 = fabsf(den4) > 1e-8f;
    s.den4s = s.live4 ? den4 : 1.0f;
    s.num4 = -(f.o[0] * pl[0] + f.o[1] * pl[1] + f.o[2] * pl[2]) - pl[3];
    const float tpl4 = s.num4 / s.den4s;
    const bool pl_ok = s.live4 && tpl4 > t_min && tpl4 < t_max;
    // Sphere winner: P(sphere beats plane).
    s.sxw1 = crossing_scale(f.r, k) + 1e-12f;
    s.qsn = tpl4 - f.t;
    s.qsr = s.qsn / s.sxw1;
    s.qsm = fmaxf(s.qsr, -30.0f);
    s.eqs = expf(-fminf(s.qsm, 30.0f));
    s.qs = 1.0f / (1.0f + s.eqs);
    s.qsel = f.hit && !f.pm && pl_ok;
    const float qf = s.qsel ? s.qs : 1.0f;
    // Crossing loser: P(plane beats it), from its capped-sqrt clamped t.
    s.cappedb = sqrtf(dmaxb + s.sb);
    const float sqbx = (s.sqb - s.cappedb) + s.cappedb;
    const float tnbx = s.tcb - sqbx;
    s.use_nbx = tnbx > t_min;
    s.t_raw_bx = s.use_nbx ? tnbx : s.tcb + sqbx;
    const float tbx = fmaxf(s.t_raw_bx, t_min);
    s.sxb1 = crossing_scale(s.br, k) + 1e-12f;
    s.qpn = tbx - f.t;
    s.qpr = s.qpn / s.sxb1;
    s.qpm = fmaxf(s.qpr, -30.0f);
    s.eqp = expf(-fminf(s.qpm, 30.0f));
    s.qp = 1.0f / (1.0f + s.eqp);
    s.cl = s.bval && cross_loser && f.pm;
    s.qf = s.cl ? s.qp : qf;
    s.den = s.den1 * s.qf;
  }
}

// What the soft ratio's adjoint hands back (ops/bounce.py:_soft_adjoint).
struct SoftCt {
  float disc, traw, t, sw, sxw, o[3], d[3], blk4[4], pk;
};

// Reverse of soft_forward from the ratio's cotangent g_srat.
template <int V>
__device__ void soft_adjoint(const Bounce& f, const Soft& s, const SoftK& k,
                             const float* pl, float g_srat, float t_min,
                             SoftCt& a) {
  const float g_den = g_srat / s.den;
  float g_den1 = g_den, g_qp = 0.0f, g_qs = 0.0f;
  if constexpr (V == kSoftPlane) {
    g_den1 = g_den * s.qf;
    const float g_qf = g_den * s.den1;
    g_qp = s.cl ? g_qf : 0.0f;
    g_qs = s.qsel && !s.cl ? g_qf : 0.0f;
  }
  const float g_pout = g_den1 * wmax(s.pout, kPFloor);
  float g_we = g_pout * s.ve;
  float g_ve = g_pout * s.we;
  const float g_blk = -g_pout;
  const float g_mw = s.fb ? g_blk * s.mv : 0.0f;
  const float g_mv = s.fb ? g_blk * s.mw : 0.0f;
  g_we = g_we + g_mw * wmin(s.we, s.wb);
  const float g_wb = g_mw * wmin(s.wb, s.we);
  g_ve = g_ve + g_mv * wmin(s.ve, s.vb);
  const float g_vb = g_mv * wmin(s.vb, s.ve);
  // Winner opacity and validity.
  const float g_xr = clip_adj(sig_adj(s.wm ? g_we : 0.0f, s.w, s.ew), s.xm, s.xr);
  a.disc = g_xr / s.sw1;
  a.sw = ((-g_xr) * f.disc) * (1.0f / (s.sw1 * s.sw1));
  const float g_vr = clip_adj(sig_adj(s.wm ? g_ve : 0.0f, s.v, s.ev), s.vm, s.vr);
  a.traw = g_vr / s.v1;
  // Blocker opacity and validity.
  const float g_xbr =
      clip_adj(sig_adj(s.fb ? g_wb : 0.0f, s.mb, s.eb), s.xbm, s.xbr);
  float g_discb = g_xbr / s.sb1;
  float g_sb = ((-g_xbr) * s.discb) * (1.0f / (s.sb1 * s.sb1));
  const float g_vbr =
      clip_adj(sig_adj(s.fb ? g_vb : 0.0f, s.vbv, s.evb), s.vbm, s.vbr);
  const float g_trb = g_vbr / s.vb1;
  float g_tcb = g_trb;
  const float g_sqb = s.use_nb ? -g_trb : g_trb;
  float g_dmaxb = g_sqb * ((1.0f / s.sqb) * 0.5f);
  float g_sxb = 0.0f;
  a.t = 0.0f;
  a.sxw = 0.0f;
  a.pk = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) a.o[c] = a.d[c] = 0.0f;
  if constexpr (V == kSoftPlane) {
    // Crossing loser: q_p = sigmoid(clip((t_bx - t) / sigma_x(r_b))).
    const float g_qpr = clip_adj(sig_adj(g_qp, s.qp, s.eqp), s.qpm, s.qpr);
    const float g_qpn = g_qpr / s.sxb1;
    g_sxb = ((-g_qpr) * s.qpn) * (1.0f / (s.sxb1 * s.sxb1));
    a.t = a.t - g_qpn;
    const float g_trbx = g_qpn * wmax(s.t_raw_bx, t_min);
    g_tcb = g_tcb + g_trbx;
    const float g_inb =
        (s.use_nbx ? -g_trbx : g_trbx) * ((1.0f / s.cappedb) * 0.5f);
    g_sb = g_sb + g_inb;
    g_dmaxb = g_dmaxb + g_inb;
    // Sphere winner: q_s = sigmoid(clip((t_pl - t) / sigma_x(r))).
    const float g_qsr = clip_adj(sig_adj(g_qs, s.qs, s.eqs), s.qsm, s.qsr);
    const float g_qsn = g_qsr / s.sxw1;
    a.sxw = ((-g_qsr) * s.qsn) * (1.0f / (s.sxw1 * s.sxw1));
    a.t = a.t - g_qsn;
    // t_pl = (-(o . n) - k) / (d . n); n is not a parameter.
    const float g_num4 = g_qsn / s.den4s;
    const float g_den4 =
        s.live4 ? ((-g_qsn) * s.num4) * (1.0f / (s.den4s * s.den4s)) : 0.0f;
    a.pk = -g_num4;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a.o[c] = (-g_num4) * pl[c];
      a.d[c] = g_den4 * pl[c];
    }
  }
  g_discb = g_discb + g_dmaxb * wmax(s.discb, 1e-12f);
  a.blk4[3] = (2.0f * (g_discb * s.br) + scale_adj(g_sb, s.br, k)) +
              xscale_adj(g_sxb, s.br, k);
  g_tcb = g_tcb + 2.0f * (g_discb * s.tcb);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float g_ocb = 2.0f * ((-g_discb) * s.ocb[c]) + g_tcb * f.d[c];
    a.d[c] = a.d[c] + g_tcb * s.ocb[c];
    a.o[c] = a.o[c] - g_ocb;
    a.blk4[c] = g_ocb;
  }
}

// Cotangents of (o, d, tp, a9, sky6) -- soft: and of the blocker's 4
// attributes and the plane offset (in sa) -- from those of (o', d', tp',
// rad) for an alive lane: ops/bounce.py:bounce_tile_adjoint.
template <int V>
__device__ void bounce_adjoint(const Bounce& f, bool rr_on,
                               const float* ct_o, const float* ct_d,
                               const float* ct_tp, const float* ct_rad,
                               float* g_o, float* g_d, float* g_tp,
                               float* g_a9, float* g_sky, const Soft& s,
                               const SoftK& k, const float* pl, float t_min,
                               SoftCt& sa) {
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
    if constexpr (V != kHard) {
      // A miss lane's ratio still depends on a front blocker.
      soft_adjoint<V>(f, s, k, pl,
                      g_tp[0] * f.tp[0] + g_tp[1] * f.tp[1] + g_tp[2] * f.tp[2],
                      t_min, sa);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        g_o[c] = g_o[c] + sa.o[c];
        g_d[c] = g_d[c] + sa.d[c];
      }
    }
    return;
  }

  // Throughput and attenuation.
  float g_alb[3], g_sd[3], g_p[3], g_at[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    g_tp[c] = f.surv0 ? g_nt[c] * f.at[c] : g_nt[c];
    g_at[c] = f.surv0 ? g_nt[c] * f.tp[c] : 0.0f;
    g_alb[c] = f.is_diel ? 0.0f : g_at[c];
    g_sky[c] = 0.0f;
    g_sky[c + 3] = 0.0f;
    g_o[c] = 0.0f;
    g_d[c] = f.surv0 ? 0.0f : ct_d[c];
    g_sd[c] = f.surv0 ? ct_d[c] : 0.0f;
    g_p[c] = ct_o[c];
  }
  if constexpr (V != kHard) {
    // tp enters scaled by den / stop_grad(den) == 1: the ratio's cotangent.
    soft_adjoint<V>(f, s, k, pl,
                    g_tp[0] * f.tp[0] + g_tp[1] * f.tp[1] + g_tp[2] * f.tp[2],
                    t_min, sa);
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
    if constexpr (V != kHard) {
      if (k.fresnel != 0.0f) {
        // SIL_FRESNEL: the Schlick-coin ratio, shared by the three channels.
        float g_cos_f, g_eta_f;
        fresnel_adjoint(f, (g_at[0] + g_at[1]) + g_at[2], g_cos_f, g_eta_f);
        g_dnf = g_dnf + (-(g_cos_f * wmin(-f.dnf, 1.0f)));
        g_io = g_io + (f.front ? (-g_eta_f) * (1.0f / (f.io * f.io)) : g_eta_f);
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
  float g_t = dot3(g_p, f.d);
  if constexpr (V != kHard) g_t = g_t + sa.t;
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
    // Sphere t = near ? tc - sq : tc + sq (soft: clamped to t_min, and the
    // sqrt's derivative capped).
    float g_traw = g_t;
    if constexpr (V != kHard) g_traw = g_t * wmax(f.t_raw, t_min) + sa.traw;
    const float g_sq = f.use_near ? -g_traw : g_traw;
    float g_disc;
    if constexpr (V != kHard) {
      const float g_in = g_sq * ((1.0f / f.capped) * 0.5f);
      g_disc = g_in * wmax(f.disc, 1e-12f) + sa.disc;
      g_r = g_r + (scale_adj(g_in + sa.sw, f.r, k) + xscale_adj(sa.sxw, f.r, k));
    } else {
      g_disc = g_sq * ((1.0f / f.sq) * 0.5f) * wmax(f.disc, 1e-12f);
    }
    const float g_tc = g_traw + 2.0f * (g_disc * f.tc);
    g_r = g_r + 2.0f * (g_disc * f.r);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float g_oc = 2.0f * ((-g_disc) * f.oc[c]) + g_tc * f.d[c];
      g_d[c] = g_d[c] + g_tc * f.oc[c];
      g_c[c] = g_c[c] + g_oc;
      g_o[c] = g_o[c] - g_oc;
    }
  }
  if constexpr (V != kHard) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      g_o[c] = g_o[c] + sa.o[c];
      g_d[c] = g_d[c] + sa.d[c];
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
  if (is_plane_code(bi)) {
#pragma unroll
    for (int j = 0; j < 7; ++j) w[j] = pl[j];
    w[7] = 0.0f;
    w[8] = 1.0f;
    mat = kLambertian;
  } else {
    sphere_attrs(t, bi, w, mat);
  }
}

// The blocker's cx cy cz r by index (zeros for none).
__device__ __forceinline__ void blocker_attrs(const SphereTables& t, int qi,
                                              float* b) {
  if (qi >= 0) {
    const float4 g = t.geo[qi];
    b[0] = g.x; b[1] = g.y; b[2] = g.z; b[3] = g.w;
  } else {
    b[0] = b[1] = b[2] = b[3] = 0.0f;
  }
}

}  // namespace
}  // namespace spt
