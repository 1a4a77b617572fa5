// Regeneration gradient kernels for Hopper (sm_90a): the recording forward
// (two modes), the scan-free re-forward and the backward, hard and with
// two-sided soft silhouettes.
//
// Replace the TPU kernels of the JAX package's ops/pallas_grad_regen.py:
//   regen_kernel<kModeFull, V>   _regen_fwd_kernel, emit_full=True
//   regen_kernel<kModeIdx, V>    _regen_fwd_kernel, emit_idx_only=True
//   regen_kernel<kModeRefwd, V>  _regen_refwd_kernel
//   regen_bwd_kernel<V>          _regen_bwd_kernel
// V = kHard, kSoft (soft silhouettes) or kSoftPlane (soft with a ground
// plane: the crossing coin), so the hard instantiations compile as before.
// Together with ops/pallas_grad.py:bounce_tile (the physics all four share)
// and its jax.vjp, which CUDA does not have: the adjoint below is written
// by hand and mirrors the plain PyTorch ops/bounce.py:bounce_tile_adjoint
// line by line (soft_forward / soft_adjoint mirror _soft_forward /
// _soft_adjoint there).
//
// What they compute.  Lane l of the banked layout (ops/persistent.py:
// bank_geometry) serves the pixels at positions l + k * n_lanes, k <
// n_banks, each for n_samples samples; a lane whose path ends starts the
// next sample (or the next bank's pixel) in the next iteration.  Iteration
// `it` of a lane is one bounce.  The forward records, per iteration, the
// 25 residual planes of the JAX package (entry o, d, tp; alive, regen;
// bank kb, sample s, bounce b; winner idx, material and its 9 attributes;
// soft: the blocker's index and cx cy cz r) or, in idx mode, only the
// winner index packed three to a word (10 bits of idx + 1 each; soft: a
// second plane of blocker indices).  The re-forward replays the same state
// evolution with the sphere scan replaced by the recorded indices, and so
// emits the planes the full forward would have.  The backward walks a
// lane's iterations in reverse with the carried (o, d, tp) cotangents,
// writes the 9 winner attribute cotangents per iteration (soft: and the
// blocker's 4; bucketed into the table by csrc/bucket.cu) and sums the
// lane's sky (6) and plane (4) cotangents.
//
// Soft silhouettes.  The scan (common.cuh:closest_hit_soft) reads its
// per-sphere thresholds from the table the host computed once
// (ops/grad_regen.py:regen_call), and the plane crossing coin records its
// outcome in the winner code: kPlaneCrossIdx marks a plane win whose
// blocker slot holds the crossing loser.  So the backward knows each
// blocker's role without replaying a coin (the JAX kernels replay them
// with thresholds they recompute, which can disagree with the forward's).
// The detached ratio den / stop_grad(den) is 1 in value, so the forward
// kernels compute only what changes values (the capped-sqrt root and its
// clamp to t_min); the backward computes den and its adjoint.
//
// Design.  One thread per lane; ray state in registers.  Planes are
// [n_iter, n_lanes] (iteration-major), so a warp's stores coalesce.  A
// lane's live iterations are 0 .. count - 1 (it regenerates at once until
// its banks are done), so the forward breaks out of its loop there and
// marks the rest dead (alive 0, idx and bidx -1, packed words 0); the
// backward skips dead iterations and writes their cotangents as 0.  Sphere
// tables sit in shared memory (common.cuh); the re-forward reads its
// winner and blocker by index there instead of the TPU's one-hot matrix
// product.  Per-lane partials are written once and summed by the host, so
// every result is deterministic.
//
// Bound.  The recording forward is bound by the sphere scan's FP32 work,
// as the persistent kernel (20 operations per sphere test; the soft scan
// ~30); the re-forward and backward do O(1) work per iteration and are
// bound by the planes they write and read (25 planes out; 25 in and 9 out;
// soft: 30 out; 30 in and 13 out).
//
// Numerics.  --fmad=false (cuda_build.py) and IEEE sqrt / division: every
// operation rounds as the PyTorch elementwise op of the plain versions
// (ops/grad_regen.py, ops/bounce.py), so the kernels match them bit for
// bit.  Where the plain version divides a constant by a tensor, PyTorch
// computes reciprocal(x) * c; the code below does the same.  logf and expf
// are the CUDA math library's, as PyTorch's log and exp on the card.

#include "common.cuh"

namespace spt {
namespace {

constexpr int kThreads = 128;
constexpr int kIdxBits = 10;
constexpr int kIdxMask = (1 << kIdxBits) - 1;
constexpr int kPlaneIdx = kIdxMask - 1;  // winner code of a ground-plane hit
// Soft, plane won the crossing coin: the blocker slot holds the loser.
constexpr int kPlaneCrossIdx = kIdxMask - 2;
constexpr int kModeFull = 0;
constexpr int kModeIdx = 1;
constexpr int kModeRefwd = 2;
// Variants: hard, soft silhouettes, soft silhouettes with a ground plane.
constexpr int kHard = 0;
constexpr int kSoft = 1;
constexpr int kSoftPlane = 2;
// f32 residual planes: 0-2 o, 3-5 d, 6-8 tp, 9 alive, 10 regen, 11-19 the
// winner's cx cy cz r ar ag ab fuzz ior; soft: 20-23 the blocker's cx cy cz
// r.  i32: 0 kb, 1 s, 2 b, 3 idx, 4 mat; soft: 5 the blocker's index.
constexpr int kFAlive = 9;
constexpr int kFRegen = 10;
constexpr int kFAttr = 11;
constexpr int kFBlk = 20;
constexpr int kIKb = 0, kIS = 1, kIB = 2, kIIdx = 3, kIMat = 4, kIBlk = 5;
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

// Soft constants (consts 32:35): f32(softness), f32(softness * 8) (the
// silhouette scale's factor), f32(softness * 0.1) (the validity scale).
struct SoftK {
  float soft, sil_c, sigv;
};

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

struct Consts {
  float sky[6], pl[7], cam[19];
  SoftK soft;
};

// consts: sky lo/hi 0:6, plane 6:13 (normal, offset, albedo), camera 13:32,
// soft constants 32:35 (SoftK; zeros when hard).
__device__ __forceinline__ void load_consts(const float* __restrict__ src,
                                            Consts& k) {
#pragma unroll
  for (int i = 0; i < 6; ++i) k.sky[i] = src[i];
#pragma unroll
  for (int i = 0; i < 7; ++i) k.pl[i] = src[6 + i];
#pragma unroll
  for (int i = 0; i < 19; ++i) k.cam[i] = src[13 + i];
  k.soft.soft = src[32];
  k.soft.sil_c = src[33];
  k.soft.sigv = src[34];
}

__device__ __forceinline__ uint32_t lane_pixel(const int* __restrict__ ids,
                                               int n_pix, int n_lanes, int kb,
                                               int lane) {
  long long pos = static_cast<long long>(kb) * n_lanes + lane;
  if (pos > n_pix - 1) pos = n_pix - 1;  // overflow positions repeat the last
  return static_cast<uint32_t>(ids[pos]);
}

template <int MODE, int V>
__global__ void __launch_bounds__(kThreads) regen_kernel(
    const int* __restrict__ pixel_ids, int n_pix, int n_lanes, int n_banks,
    const float* __restrict__ tab, int n_spheres,
    const float* __restrict__ consts, int use_plane, uint32_t k0, uint32_t k1,
    uint32_t sample_offset, int n_samples, int max_depth, int width,
    float inv_w, float inv_h, float t_min, float t_max, int rr_start_depth,
    int n_iter, const float* __restrict__ soft_tab,
    const int* __restrict__ idx_in, float* __restrict__ out_rad,
    float* __restrict__ out_cnt, float* __restrict__ resf,
    int* __restrict__ resi, int* __restrict__ packed) {
  constexpr bool kSoftV = V != kHard;
  extern __shared__ float4 smem[];
  const SphereTables tabs = load_sphere_tables(smem, tab, n_spheres);
  const float4* soft = nullptr;
  if constexpr (kSoftV) {
    // After geo, att (n float4 each) and att2 (n float2; n is a multiple
    // of 4).
    soft = load_soft_table(smem + 2 * n_spheres + n_spheres / 2, soft_tab,
                           n_spheres);
  }
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  Consts k;
  load_consts(consts, k);
  const size_t L = static_cast<size_t>(n_lanes);
  const size_t plane_stride = static_cast<size_t>(n_iter) * L;
  // Packed words: winners, then (soft) blockers, [n_iter / 3, n_lanes] each.
  const size_t word_stride = static_cast<size_t>(n_iter / 3) * L;
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
  int word = 0, bword = 0;
  int prev = -1;  // soft: the chain's previous sphere winner
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
      prev = -1;
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
    Bounce f;
    // Soft: the acceptance coin u[7] is read by the scan.
    if constexpr (kSoftV) bounce_uniforms(k0, k1, pix, c1b, static_cast<uint32_t>(b), f.u);
    const int field = it % 3;
    int bi, qi = -1;
    if (MODE == kModeRefwd) {
      // The recorded winner (and blocker) instead of the scan.
      const size_t w = static_cast<size_t>(it / 3) * L + lane;
      if (field == 0) {
        word = idx_in[w];
        if constexpr (kSoftV) bword = idx_in[word_stride + w];
      }
      bi = ((word >> (kIdxBits * field)) & kIdxMask) - 1;
      if constexpr (kSoftV) qi = ((bword >> (kIdxBits * field)) & kIdxMask) - 1;
    } else if constexpr (kSoftV) {
      // Acceptance coin u[7]; crossing (ux) and validity (uv) coins in
      // slot 128 + b.
      float ux, uv;
      uniforms(k0, k1, pix, c1b | (128u + static_cast<uint32_t>(b)), ux, uv);
      float bt;
      closest_hit_soft(tabs.geo, soft, n_spheres, o[0], o[1], o[2], d[0],
                       d[1], d[2], t_min, t_max, silhouette_logit(f.u[7]),
                       silhouette_logit(uv), prev, bt, bi, qi);
      if constexpr (V == kSoftPlane) {
        // Plane-vs-sphere crossing coin: the sphere beats the plane iff
        // t_s < t_p + logit(ux) * sigma_x(r_s); a plane win over a sphere
        // less than 30 sigma_x behind stashes that sphere as the blocker.
        const float denom = d[0] * k.pl[0] + d[1] * k.pl[1] + d[2] * k.pl[2];
        const float num = -(o[0] * k.pl[0] + o[1] * k.pl[1] + o[2] * k.pl[2] + k.pl[3]);
        const bool live = fabsf(denom) > 1e-8f;
        const float tpl = num / (live ? denom : 1.0f);
        const float pre_r = bi >= 0 ? tabs.geo[bi].w : 1.0f;
        const float sigx = crossing_scale(pre_r, k.soft);
        const float thr_x = silhouette_logit(ux) * sigx;
        const bool wins = live && tpl > t_min && tpl < t_max &&
                          !(bi >= 0 && bt < tpl + thr_x);
        const bool steal = wins && bi >= 0 && bt - tpl < 30.0f * sigx;
        if (steal) qi = bi;
        if (wins) bi = steal ? kPlaneCrossIdx : kPlaneIdx;
      }
    } else {
      float bt = t_max;
      bi = closest_hit(tabs.geo, n_spheres, o[0], o[1], o[2], d[0], d[1],
                       d[2], t_min, bt);
      float tpl, sgn;
      if (use_plane && plane_wins(k.pl, o[0], o[1], o[2], d[0], d[1], d[2],
                                  t_min, bt, tpl, sgn))
        bi = kPlaneIdx;
    }
    float w[9];
    winner_attrs(tabs, k.pl, bi, w, f.mat);
    float blk[4];
    if constexpr (kSoftV) blocker_attrs(tabs, qi, blk);
    if (MODE == kModeIdx) {
      const int v = bi + 1;
      word = field == 0 ? v : word + v * (1 << (kIdxBits * field));
      if constexpr (kSoftV) {
        const int bv = qi + 1;
        bword = field == 0 ? bv : bword + bv * (1 << (kIdxBits * field));
      }
      if (field == 2) {
        const size_t wpos = static_cast<size_t>(it / 3) * L + lane;
        packed[wpos] = word;
        if constexpr (kSoftV) packed[word_stride + wpos] = bword;
      }
    } else {
      ip(kIIdx, it) = bi;
      ip(kIMat, it) = f.mat;
#pragma unroll
      for (int j = 0; j < 9; ++j) fp(kFAttr + j, it) = w[j];
      if constexpr (kSoftV) {
        ip(kIBlk, it) = qi;
#pragma unroll
        for (int j = 0; j < 4; ++j) fp(kFBlk + j, it) = blk[j];
      }
    }

    // The bounce (soft: its values; the detached ratio is 1).
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
    if constexpr (kSoftV) {
      f.pm = V == kSoftPlane && is_plane_code(bi);
    } else {
      f.pm = use_plane && bi == kPlaneIdx;
    }
    f.do_rr = b >= rr_start_depth;
    if constexpr (!kSoftV) bounce_uniforms(k0, k1, pix, c1b, static_cast<uint32_t>(b), f.u);
    bounce_forward<V>(f, k.sky, t_min, t_max, rr_on, k.soft.sil_c);
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
    if constexpr (kSoftV) prev = f.hit && !f.pm ? bi : -1;
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
      if (field == 0) {
        word = 0;
        if constexpr (kSoftV) bword = 0;
      }
      if (field == 2) {
        const size_t wpos = static_cast<size_t>(it / 3) * L + lane;
        packed[wpos] = word;
        if constexpr (kSoftV) packed[word_stride + wpos] = bword;
      }
    } else {
      fp(kFAlive, it) = 0.0f;
      ip(kIIdx, it) = -1;
      if constexpr (kSoftV) ip(kIBlk, it) = -1;
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads) regen_bwd_kernel(
    const int* __restrict__ pixel_ids, int n_pix, int n_lanes, int n_banks,
    const float* __restrict__ consts, int use_plane, uint32_t k0, uint32_t k1,
    uint32_t sample_offset, int n_iter, float t_min, float t_max,
    int rr_start_depth, const float* __restrict__ resf,
    const int* __restrict__ resi, const float* __restrict__ ct_rad,
    float* __restrict__ ct_planes, float* __restrict__ partials) {
  constexpr bool kSoftV = V != kHard;
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
  const bool plane_on = V == kSoftPlane || (V == kHard && use_plane);
  constexpr int kCt = kSoftV ? 13 : 9;

  float co[3] = {0.0f, 0.0f, 0.0f}, cd[3] = {0.0f, 0.0f, 0.0f};
  float ctp[3] = {0.0f, 0.0f, 0.0f};
  float sky_part[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float pl_part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int it = n_iter - 1; it >= 0; --it) {
    if (!(fp(kFAlive, it) > 0.0f)) {
      // Dead iteration: the carried cotangents pass through.
#pragma unroll
      for (int j = 0; j < kCt; ++j) ct(j, it) = 0.0f;
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
    f.pm = plane_on && is_plane_code(idx);
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
    bounce_forward<V>(f, k.sky, t_min, t_max, rr_on, k.soft.sil_c);
    Soft sf;
    SoftCt sa;
    if constexpr (kSoftV) {
      // The blocker and its role (recorded by the forward).
      sf.bval = ip(kIBlk, it) >= 0;
#pragma unroll
      for (int c = 0; c < 3; ++c) sf.bc[c] = fp(kFBlk + c, it);
      sf.br = fp(kFBlk + 3, it);
      soft_forward<V>(f, sf, k.soft, idx == kPlaneCrossIdx, k.pl, t_min,
                      t_max);
    }
    float g_o[3], g_d[3], g_tp[3], g_a9[9], g_sky[6];
    bounce_adjoint<V>(f, rr_on, co, cd, ctp, ctr, g_o, g_d, g_tp, g_a9,
                      g_sky, sf, k.soft, k.pl, t_min, sa);
#pragma unroll
    for (int j = 0; j < 9; ++j) ct(j, it) = f.hit ? g_a9[j] : 0.0f;
    if constexpr (kSoftV) {
#pragma unroll
      for (int j = 0; j < 4; ++j) ct(9 + j, it) = sf.bval ? sa.blk4[j] : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) sky_part[c] = sky_part[c] + g_sky[c];
    // The offset also moves the crossing coin's probability on sphere-win
    // lanes.
    if constexpr (V == kSoftPlane) pl_part[0] = pl_part[0] + sa.pk;
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

template <int MODE, int V>
cudaError_t launch_regen(const void* pixel_ids, int n_pix, int n_lanes,
                         int n_banks, const void* tab, int n_spheres,
                         const void* consts, int use_plane, uint32_t k0,
                         uint32_t k1, uint32_t sample_offset, int n_samples,
                         int max_depth, int width, float inv_w, float inv_h,
                         float t_min, float t_max, int rr_start_depth,
                         int n_iter, const void* soft_tab, const void* idx_in,
                         void* out_rad, void* out_cnt, void* resf, void* resi,
                         void* packed, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n_spheres) *
                      (kSmemPerSphere + (V != kHard ? sizeof(float4) : 0));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        regen_kernel<MODE, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  regen_kernel<MODE, V><<<blocks, kThreads, smem, stream>>>(
      static_cast<const int*>(pixel_ids), n_pix, n_lanes, n_banks,
      static_cast<const float*>(tab), n_spheres,
      static_cast<const float*>(consts), use_plane, k0, k1, sample_offset,
      n_samples, max_depth, width, inv_w, inv_h, t_min, t_max, rr_start_depth,
      n_iter, static_cast<const float*>(soft_tab),
      static_cast<const int*>(idx_in), static_cast<float*>(out_rad),
      static_cast<float*>(out_cnt), static_cast<float*>(resf),
      static_cast<int*>(resi), static_cast<int*>(packed));
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_regen_variant(int variant, const void* pixel_ids,
                                 int n_pix, int n_lanes, int n_banks,
                                 const void* tab, int n_spheres,
                                 const void* consts, int use_plane,
                                 uint32_t k0, uint32_t k1,
                                 uint32_t sample_offset, int n_samples,
                                 int max_depth, int width, float inv_w,
                                 float inv_h, float t_min, float t_max,
                                 int rr_start_depth, int n_iter,
                                 const void* soft_tab, const void* idx_in,
                                 void* out_rad, void* out_cnt, void* resf,
                                 void* resi, void* packed,
                                 cudaStream_t stream) {
#define SPT_ARGS                                                           \
  pixel_ids, n_pix, n_lanes, n_banks, tab, n_spheres, consts, use_plane, k0, \
      k1, sample_offset, n_samples, max_depth, width, inv_w, inv_h, t_min,   \
      t_max, rr_start_depth, n_iter, soft_tab, idx_in, out_rad, out_cnt,     \
      resf, resi, packed, stream
  switch (variant) {
    case kHard: return launch_regen<MODE, kHard>(SPT_ARGS);
    case kSoft: return launch_regen<MODE, kSoft>(SPT_ARGS);
    case kSoftPlane: return launch_regen<MODE, kSoftPlane>(SPT_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef SPT_ARGS
}

// The kernel variant: hard, soft, or soft with a ground plane.
int variant_of(float softness, int use_plane) {
  if (!(softness > 0.0f)) return kHard;
  return use_plane ? kSoftPlane : kSoft;
}

}  // namespace
}  // namespace spt

// Recording forward (mode 0: the residual planes, 1: packed indices) or
// re-forward from packed indices (mode 2), on the caller's stream.
// softness > 0 selects the soft-silhouette variant (soft_tab: the scan's
// [n_spheres, 4] table).  Returns cudaGetLastError() (0 = launched).
extern "C" int spt_regen_forward(
    const void* pixel_ids, int n_pix, int n_lanes, int n_banks,
    const void* tab, int n_spheres, const void* consts, int use_plane,
    unsigned int k0, unsigned int k1, unsigned int sample_offset,
    int n_samples, int max_depth, int width, float inv_w, float inv_h,
    float t_min, float t_max, int rr_start_depth, int n_iter, int mode,
    float softness, const void* soft_tab, const void* idx_in, void* out_rad,
    void* out_cnt, void* resf, void* resi, void* packed, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int variant = spt::variant_of(softness, use_plane);
#define SPT_ARGS                                                           \
  variant, pixel_ids, n_pix, n_lanes, n_banks, tab, n_spheres, consts,     \
      use_plane, k0, k1, sample_offset, n_samples, max_depth, width, inv_w, \
      inv_h, t_min, t_max, rr_start_depth, n_iter, soft_tab, idx_in,        \
      out_rad, out_cnt, resf, resi, packed, st
  cudaError_t err;
  switch (mode) {
    case spt::kModeFull: err = spt::launch_regen_variant<spt::kModeFull>(SPT_ARGS); break;
    case spt::kModeIdx: err = spt::launch_regen_variant<spt::kModeIdx>(SPT_ARGS); break;
    case spt::kModeRefwd: err = spt::launch_regen_variant<spt::kModeRefwd>(SPT_ARGS); break;
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
    int rr_start_depth, float softness, const void* resf, const void* resi,
    const void* ct_rad, void* ct_planes, void* partials, void* stream) {
  const int blocks = (n_lanes + spt::kThreads - 1) / spt::kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPT_ARGS                                                             \
  static_cast<const int*>(pixel_ids), n_pix, n_lanes, n_banks,               \
      static_cast<const float*>(consts), use_plane, k0, k1, sample_offset,   \
      n_iter, t_min, t_max, rr_start_depth, static_cast<const float*>(resf), \
      static_cast<const int*>(resi), static_cast<const float*>(ct_rad),      \
      static_cast<float*>(ct_planes), static_cast<float*>(partials)
  switch (spt::variant_of(softness, use_plane)) {
    case spt::kHard:
      spt::regen_bwd_kernel<spt::kHard><<<blocks, spt::kThreads, 0, st>>>(SPT_ARGS);
      break;
    case spt::kSoft:
      spt::regen_bwd_kernel<spt::kSoft><<<blocks, spt::kThreads, 0, st>>>(SPT_ARGS);
      break;
    default:
      spt::regen_bwd_kernel<spt::kSoftPlane><<<blocks, spt::kThreads, 0, st>>>(SPT_ARGS);
      break;
  }
#undef SPT_ARGS
  return static_cast<int>(cudaGetLastError());
}
