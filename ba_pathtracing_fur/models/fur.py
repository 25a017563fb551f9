"""Hair-fiber scattering: Marschner R/TT/TRT and d'Eon energy-conserving
lobes, as (a) the reference's stateful multi-bounce cylinder-walk automaton
and (b) a closed-form single-pass lobe sum.

Parity targets:
  * automaton   — MarschnerHairBSDF::localSample (Bsdf.cpp:465-769) and
                  DEonHairBSDF::localSample (Bsdf.cpp:784-1051). The walk is
                  a 3-state machine over MATFLAG_CYLINDER_T/TR_BOUNCE flag
                  bits carried in the wavefront ray state — the analog of
                  the reference's per-ray mat_flags (Bsdf.h:21-22).
  * closed form — SimpleCPURaytracer::shadeMarschnerHair
                  (Simple_CPU_Raytracer.cpp:451-760); single pass, no state,
                  differentiable-friendly (used by the Whitted renderer and
                  the gradient path).

The reference randomizes lobe shift/width per *evaluation* from U[5,10]°
(Bsdf.cpp:485-489) — non-reproducible by design. Here they are the material
parameters hair_alpha (≈-7.5°) / hair_beta (≈7.5°), exactly the fur
parameters pixel gradients flow to (SURVEY §7).

Deliberate reference quirks reproduced (SURVEY §7 "hard parts (e)"):
  * Marschner variant feeds DEGREE-valued alpha/beta straight into radian
    math (gaussians and glm::rotate) — kept, it defines the look.
  * The row-vector * rotation-matrix product (`vec4(v) * rotate(θ)`)
    rotates by -θ; we negate accordingly.
  * d'Eon's M uses MSVC `_j0` (Bessel J0, not the paper's I0) and mixed
    radians()/degrees() wrappers (Bsdf.cpp:993-995) — kept.
  * TRT lobe ×10 boost (Bsdf.cpp:661) — kept.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core import sampling as sp, vecmath as vm
from ..scene.types import (
    BSDF_DEON_HAIR, BSDF_MARSCHNER_HAIR,
    MATFLAG_CYLINDER_T_BOUNCE, MATFLAG_CYLINDER_TR_BOUNCE,
    MATFLAG_SPECULAR_BOUNCE,
)
from .bsdf import BsdfSample, MatParams

_EPS = 1e-6


def bessel_j0(x):
    """Bessel function of the first kind, order 0 (Abramowitz & Stegun 9.4)."""
    x = jnp.asarray(x)
    ax = jnp.abs(x)
    # Each branch's input is clamped into its own validity domain so the
    # UNSELECTED branch never overflows: jnp.where's VJP multiplies the
    # branch's internal partials, and an inf there turns 0-cotangents into NaNs.
    # |x| < 8: rational approximation
    y = jnp.minimum(x * x, 64.0)
    p1 = (57568490574.0 + y * (-13362590354.0 + y * (651619640.7
          + y * (-11214424.18 + y * (77392.33017 + y * -184.9052456)))))
    q1 = (57568490411.0 + y * (1029532985.0 + y * (9494680.718
          + y * (59272.64853 + y * (267.8532712 + y)))))
    small = p1 / q1
    # |x| >= 8: asymptotic
    ax_l = jnp.maximum(ax, 8.0)
    z = 8.0 / ax_l
    y2 = z * z
    xx = ax_l - 0.785398164
    p2 = (1.0 + y2 * (-0.1098628627e-2 + y2 * (0.2734510407e-4
          + y2 * (-0.2073370639e-5 + y2 * 0.2093887211e-6))))
    q2 = (-0.1562499995e-1 + y2 * (0.1430488765e-3 + y2 * (-0.6911147651e-5
          + y2 * (0.7621095161e-6 + y2 * -0.934935152e-7))))
    large = jnp.sqrt(0.636619772 / ax_l) * (jnp.cos(xx) * p2 - z * jnp.sin(xx) * q2)
    return jnp.where(ax < 8.0, small, large)


def _to_cyl(x, fu, fv, fw):
    """World → Marschner cylinder space: the reference passes axes in
    (V, U, W) order (Bsdf.cpp:482), so component 0 is along the FIBER AXIS."""
    return jnp.stack([vm.dot(x, fv), vm.dot(x, fu), vm.dot(x, fw)], axis=-1)


def _theta(cyl):
    """Angle against the fiber's normal plane (Bsdf.cpp:511).

    hypot has a NaN gradient at (0,0) — floor the radicand instead."""
    r = jnp.sqrt(jnp.maximum(cyl[..., 0] ** 2 + cyl[..., 2] ** 2, 1e-20))
    return jnp.arctan2(r, cyl[..., 1])


def _phi(cyl):
    # arctan2's VJP divides by x^2+y^2 — guard the (0,0) point
    x, y = cyl[..., 0], cyl[..., 1]
    degenerate = (jnp.abs(x) < 1e-12) & (jnp.abs(y) < 1e-12)
    return jnp.arctan2(x, jnp.where(degenerate, 1.0, y))


def _bravais(ior, gamma_i):
    """Virtual (Bravais) indices (Bsdf.cpp:542-545)."""
    cg = jnp.cos(gamma_i)
    cg_safe = jnp.where(jnp.abs(cg) < _EPS, _EPS, cg)
    x1 = jnp.sqrt(jnp.maximum(ior * ior - jnp.sin(gamma_i) ** 2, _EPS))
    return x1 / cg_safe, ior * ior * cg_safe / x1



def _clip1(x):
    """clip to (-1, 1) exclusive: arcsin/arccos have infinite derivative at
    the closed boundary, which turns into NaN through jnp.where VJPs."""
    return jnp.clip(x, -1.0 + 1e-6, 1.0 - 1e-6)

def _safe_div(a, b):
    return a / jnp.where(jnp.abs(b) < _EPS, jnp.where(b < 0, -_EPS, _EPS), b)


class HairSample(NamedTuple):
    reflectance: jnp.ndarray  # [R,3]
    wo: jnp.ndarray  # [R,3]
    pdf: jnp.ndarray  # [R]
    flags: jnp.ndarray  # [R] int32
    theta_i: jnp.ndarray  # [R] stored for the hair shader (Bsdf.cpp:516)


# ---------------------------------------------------------------------------
# Marschner automaton
# ---------------------------------------------------------------------------

def _marschner_R(mp, nin, n, fu, fv, fw, in_cyl):
    """First-hit R path (Bsdf.cpp:672-736)."""
    alpha = mp.hair_alpha  # degrees fed raw into radian math (parity quirk)
    beta = mp.hair_beta
    nf = vm.faceforward(n, -nin, n)
    wo = vm.reflect(-nin, nf)
    # vec4(v) * rotate(alpha) == rotate by -alpha
    wo = vm.rotate_about_axis(wo, fv, -alpha)
    out_cyl = _to_cyl(wo, fu, fv, fw)

    theta_i = _theta(in_cyl)
    theta_r = _theta(out_cyl)
    theta_h = 0.5 * (theta_r + theta_i)
    theta_d = 0.5 * (theta_r - theta_i)
    pdf = sp.normal_gauss_pdf(theta_h - alpha, 0.0, beta)

    gamma_i = vm.angle_between(nin, vm.normalize(n))
    h = jnp.sin(gamma_i)
    dh_dphi = jnp.abs(_safe_div(-2.0, jnp.sqrt(jnp.maximum(1.0 - h * h, _EPS))))
    b1, b2 = _bravais(mp.ior, gamma_i)
    fresnel = sp.dielectric_fresnel(gamma_i, b1, b2)
    n_r = 0.5 * fresnel * dh_dphi
    scat = pdf * n_r / jnp.maximum(jnp.cos(theta_d) ** 2, _EPS)
    refl = jnp.broadcast_to(scat[:, None], nin.shape)
    flags = jnp.full(nin.shape[0], MATFLAG_SPECULAR_BOUNCE, jnp.int32)
    return refl, wo, pdf, flags, theta_i


def _marschner_first_transmit(mp, nin, n, want_trt):
    """First-hit TT/TRT entry: refract into the fiber (Bsdf.cpp:738-766)."""
    nf = vm.faceforward(n, -nin, n)
    wo = vm.refract(-nin, nf, (1.0 / mp.ior)[:, None])
    flag = jnp.where(want_trt, MATFLAG_CYLINDER_TR_BOUNCE, MATFLAG_CYLINDER_T_BOUNCE)
    return jnp.zeros_like(nin), wo, jnp.ones(nin.shape[0]), flag.astype(jnp.int32), jnp.zeros(nin.shape[0])


def _marschner_TT_exit(mp, nin, n, fu, fv, fw, in_cyl):
    """Second-wall TT exit (Bsdf.cpp:492-567)."""
    alpha = mp.hair_alpha
    beta = mp.hair_beta
    nf = vm.faceforward(n, -nin, n)
    wo = vm.refract(-nin, nf, 1.0)
    wo = vm.rotate_about_axis(wo, fv, alpha / 2.0)  # ref angle -alpha/2, row-vec quirk
    out_cyl = _to_cyl(wo, fu, fv, fw)

    theta_i = _theta(in_cyl)
    theta_r = _theta(out_cyl)
    theta_h = 0.5 * (theta_r + theta_i)
    theta_d = 0.5 * (theta_r - theta_i)
    pdf = sp.normal_gauss_pdf(theta_h + alpha / 2.0, 0.0, beta / 2.0)

    gamma_i = vm.angle_between(nin, vm.normalize(n))
    b1, b2 = _bravais(mp.ior, gamma_i)
    c = jnp.arcsin(_clip1(1.0 / b1))
    h = jnp.sin(gamma_i)
    pi = jnp.pi
    denom = _safe_div(1.0, jnp.sqrt(jnp.maximum(1.0 - h * h, _EPS))) * (
        -(24.0 * c / pi ** 3) * gamma_i ** 2 + (6.0 * c / pi - 2.0)
    )
    dh_dphi = _safe_div(1.0, jnp.abs(denom))
    fresnel = sp.dielectric_fresnel(gamma_i, b1, b2)
    cos_gamma_t = -2.0 * jnp.cos(jnp.arcsin(_clip1(h / b1)))
    new_sigma = mp.diffuse / jnp.maximum(jnp.cos(theta_r), _EPS)[:, None]
    att = ((1.0 - fresnel) ** 2)[:, None] * jnp.exp(new_sigma * cos_gamma_t[:, None])
    n_tt = 0.5 * att * dh_dphi[:, None]
    refl = pdf[:, None] * n_tt / jnp.maximum(jnp.cos(theta_d) ** 2, _EPS)[:, None]
    flags = jnp.zeros(nin.shape[0], jnp.int32)
    return refl, wo, pdf, flags, theta_i


def _marschner_TR_step(nin, n):
    """Internal reflection on the second wall (Bsdf.cpp:573-580)."""
    nf = vm.faceforward(n, -nin, n)
    wo = vm.reflect(-nin, nf)
    flags = jnp.full(
        nin.shape[0],
        MATFLAG_CYLINDER_TR_BOUNCE | MATFLAG_CYLINDER_T_BOUNCE | MATFLAG_SPECULAR_BOUNCE,
        jnp.int32,
    )
    return jnp.zeros_like(nin), wo, jnp.ones(nin.shape[0]), flags, jnp.zeros(nin.shape[0])


def _marschner_TRT_exit(mp, nin, n, fu, fv, fw, in_cyl):
    """Final TRT exit through the first wall (Bsdf.cpp:581-662)."""
    alpha = mp.hair_alpha
    beta = mp.hair_beta
    nf = vm.faceforward(n, -nin, n)
    wo = vm.refract(-nin, nf, 1.0)
    wo = vm.rotate_about_axis(wo, fv, 3.0 * alpha / 2.0)  # ref -3a/2, row-vec quirk
    out_cyl = _to_cyl(wo, fu, fv, fw)

    theta_i = _theta(in_cyl)
    theta_r = _theta(out_cyl)
    theta_h = 0.5 * (theta_r + theta_i)
    theta_d = 0.5 * (theta_r - theta_i)
    pdf = sp.normal_gauss_pdf(theta_h + 3.0 * alpha / 2.0, 0.0, 2.0 * beta)

    gamma_i = vm.angle_between(nin, vm.normalize(n))
    b1, b2 = _bravais(mp.ior, gamma_i)
    c = jnp.arcsin(_clip1(1.0 / b1))
    h = jnp.sin(gamma_i)
    pi = jnp.pi
    denom = _safe_div(1.0, jnp.sqrt(jnp.maximum(1.0 - h * h, _EPS))) * (
        -(48.0 * c / pi ** 3) * gamma_i ** 2 + (12.0 * c / pi - 2.0)
    )
    dh_dphi = _safe_div(1.0, jnp.abs(denom))
    fresnel = sp.dielectric_fresnel(gamma_i, b1, b2)
    gamma_t = jnp.arcsin(_clip1(h / b1))
    cos_gamma_t = jnp.cos(gamma_t)
    fresnel_exit = sp.dielectric_fresnel(gamma_t, 1.0 / b1, 1.0 / b2)
    new_sigma = mp.diffuse / jnp.maximum(jnp.cos(theta_r), _EPS)[:, None]
    att = ((1.0 - fresnel) ** 2 * fresnel_exit)[:, None] * \
        jnp.exp(new_sigma * (-2.0 * cos_gamma_t)[:, None]) ** 2
    n_trt = 0.5 * att * dh_dphi[:, None]
    refl = 10.0 * pdf[:, None] * n_trt / jnp.maximum(jnp.cos(theta_d) ** 2, _EPS)[:, None]
    flags = jnp.zeros(nin.shape[0], jnp.int32)
    return refl, wo, pdf, flags, theta_i


def marschner_sample(mp: MatParams, wi, n, fu, fv, fw, flags, p_choice) -> HairSample:
    """Full Marschner automaton step; `p_choice` in {0,1,2} picks R/TT/TRT at
    first hit (the reference hardcodes 0, Bsdf.cpp:669 — pass zeros for
    parity)."""
    nin = vm.normalize(wi)
    in_cyl = _to_cyl(nin, fu, fv, fw)

    t_set = (flags & MATFLAG_CYLINDER_T_BOUNCE) != 0
    tr_set = (flags & MATFLAG_CYLINDER_TR_BOUNCE) != 0
    state_tt = t_set & ~tr_set
    state_tr_pending = tr_set & ~t_set
    state_trt_exit = tr_set & t_set

    r_res = _marschner_R(mp, nin, n, fu, fv, fw, in_cyl)
    enter_res = _marschner_first_transmit(mp, nin, n, p_choice == 2)
    tt_res = _marschner_TT_exit(mp, nin, n, fu, fv, fw, in_cyl)
    tr_res = _marschner_TR_step(nin, n)
    trt_res = _marschner_TRT_exit(mp, nin, n, fu, fv, fw, in_cyl)

    first = p_choice == 0
    def pick(field):
        r, e, tt, tr, trt = (x[field] if isinstance(field, int) else x for x in
                             (r_res, enter_res, tt_res, tr_res, trt_res))
        return r, e, tt, tr, trt

    def sel(i):
        r, e, tt, tr, trt = (res[i] for res in (r_res, enter_res, tt_res, tr_res, trt_res))
        expand = r.ndim > 1
        def w(m, a, b):
            return jnp.where(m[:, None] if expand else m, a, b)
        first_hit = w(first, r, e)
        out = w(state_tt, tt, w(state_tr_pending, tr, w(state_trt_exit, trt, first_hit)))
        return out

    return HairSample(
        reflectance=sel(0), wo=sel(1), pdf=sel(2),
        flags=sel(3).astype(jnp.int32), theta_i=sel(4),
    )


# ---------------------------------------------------------------------------
# d'Eon automaton
# ---------------------------------------------------------------------------

def _deon_M(v, theta_i, theta_r, radians_quirk):
    """d'Eon Eq. 7 M term (Bsdf.cpp:835-839 / 992-997).

    radians_quirk=True reproduces the R-path's stray radians()/degrees()
    wrappers; False is the TT/TRT form.
    """
    v_safe = jnp.maximum(v, _EPS)
    if radians_quirk:
        x = jnp.radians(1.0 / v_safe)
        scale = jnp.degrees(v_safe)
    else:
        x = 1.0 / v_safe
        scale = v_safe
    # csch(x)/(2v) * e^s computed in log space: sinh(1/v) overflows f32 for
    # small v and its cosh-valued derivative turns the VJP into inf/inf NaNs.
    # log(csch(x)) = log 2 - x - log1p(-e^(-2x))
    s = jnp.sin(-theta_i) * jnp.sin(theta_r) / scale
    x_pos = jnp.maximum(x, _EPS)
    log_m = -x_pos - jnp.log1p(-jnp.exp(-2.0 * x_pos)) - jnp.log(v_safe) + s
    bes = bessel_j0(jnp.cos(-theta_i) * jnp.cos(theta_r) / scale)
    return jnp.exp(jnp.minimum(log_m, 80.0)) * bes


def _deon_detector(phi, stddev_deg):
    """Gaussian detector, d'Eon Eq. 11 with k = -10..10 (Bsdf.cpp:860-862)."""
    acc = 0.0
    for k in range(-10, 11):
        acc = acc + sp.normal_gauss_pdf(phi - 2.0 * jnp.pi * k, 0.0, stddev_deg)
    return acc


def deon_sample(mp: MatParams, wi, n, fu, fv, fw, flags, p_choice) -> HairSample:
    """DEonHairBSDF::localSample parity (Bsdf.cpp:784-1051)."""
    nin = vm.normalize(wi)
    in_cyl = _to_cyl(nin, fu, fv, fw)
    alpha = jnp.radians(mp.hair_alpha)
    beta = jnp.radians(mp.hair_beta)
    ior = mp.ior

    t_set = (flags & MATFLAG_CYLINDER_T_BOUNCE) != 0
    tr_set = (flags & MATFLAG_CYLINDER_TR_BOUNCE) != 0
    state_tt = t_set & ~tr_set
    state_tr_pending = tr_set & ~t_set
    state_trt_exit = tr_set & t_set
    first = p_choice == 0

    theta_i_in = _theta(in_cyl)
    phi_i = _phi(in_cyl)
    gamma_i = vm.angle_between(nin, vm.normalize(n))
    h = jnp.sin(gamma_i)
    nf = vm.faceforward(n, -nin, n)

    # --- R path
    wo_r = vm.rotate_about_axis(vm.reflect(-nin, nf), fv, -alpha)
    out_cyl_r = _to_cyl(wo_r, fu, fv, fw)
    theta_r_r = _theta(out_cyl_r)
    m_r = _deon_M(beta * beta, theta_i_in, theta_r_r, radians_quirk=True)
    phi_r_r = _phi(out_cyl_r)
    d_r = 0.25 * jnp.abs(jnp.cos(phi_r_r - phi_i / 2.0))  # quirk kept (Bsdf.cpp:1006)
    fres_r = sp.dielectric_fresnel(
        0.5 * jnp.arccos(_clip1(vm.dot(nin, vm.normalize(wo_r)))), 1.0, ior)
    refl_r = jnp.broadcast_to((m_r * 0.5 * fres_r * d_r)[:, None], nin.shape)
    pdf_r = m_r

    # --- first-hit TT/TRT entry
    wo_enter = vm.refract(-nin, nf, (1.0 / ior)[:, None])
    flag_enter = jnp.where(p_choice == 2, MATFLAG_CYLINDER_TR_BOUNCE,
                           MATFLAG_CYLINDER_T_BOUNCE).astype(jnp.int32)

    # --- TT exit
    wo_tt = vm.rotate_about_axis(vm.refract(-nin, nf, 1.0), fv, alpha / 2.0)
    out_cyl_tt = _to_cyl(wo_tt, fu, fv, fw)
    theta_r_tt = _theta(out_cyl_tt)
    theta_d_tt = 0.5 * (theta_r_tt - theta_i_in)
    m_tt = _deon_M((beta / 2.0) ** 2, theta_i_in, theta_r_tt, radians_quirk=False)
    phi_tt = _phi(out_cyl_tt) - phi_i
    cos_td = jnp.cos(theta_d_tt)
    bravais = jnp.sqrt(jnp.maximum(ior * ior - jnp.sin(theta_d_tt) ** 2, _EPS)) / \
        jnp.maximum(cos_td, _EPS)
    d_tt = _deon_detector(phi_tt, jnp.degrees(beta / 2.0))
    fres_tt = sp.dielectric_fresnel(jnp.arccos(_clip1(cos_td * jnp.cos(gamma_i))), ior, 1.0)
    cos_2gt = jnp.cos(2.0 * jnp.arcsin(_clip1(h / bravais)))
    sigma_tt = mp.diffuse / jnp.maximum(jnp.cos(theta_r_tt), _EPS)[:, None]
    att_tt = ((1.0 - fres_tt) ** 2)[:, None] * jnp.exp(-2.0 * sigma_tt * (1.0 + cos_2gt)[:, None])
    refl_tt = m_tt[:, None] * 0.5 * att_tt * d_tt[:, None]
    pdf_tt = m_tt

    # --- TR internal reflection step
    wo_tr = vm.reflect(-nin, nf)
    flags_tr = jnp.full(nin.shape[0],
                        MATFLAG_CYLINDER_TR_BOUNCE | MATFLAG_CYLINDER_T_BOUNCE | MATFLAG_SPECULAR_BOUNCE,
                        jnp.int32)

    # --- TRT exit
    wo_trt = vm.rotate_about_axis(vm.refract(-nin, nf, 1.0), fv, 3.0 * alpha / 2.0)
    out_cyl_trt = _to_cyl(wo_trt, fu, fv, fw)
    theta_r_trt = _theta(out_cyl_trt)
    theta_d_trt = 0.5 * (theta_r_trt - theta_i_in)
    m_trt = _deon_M((beta * 2.0) ** 2, theta_i_in, theta_r_trt, radians_quirk=False)
    phi_trt = _phi(out_cyl_trt) - phi_i
    cos_td2 = jnp.cos(theta_d_trt)
    bravais2 = jnp.sqrt(jnp.maximum(ior * ior - jnp.sin(theta_d_trt) ** 2, _EPS)) / \
        jnp.maximum(cos_td2, _EPS)
    d_trt = _deon_detector(phi_trt, jnp.degrees(beta * 2.0))
    fres_trt = sp.dielectric_fresnel(jnp.arccos(_clip1(cos_td2 * jnp.cos(gamma_i))), ior, 1.0)
    cos_2gt2 = jnp.cos(2.0 * jnp.arcsin(_clip1(h / bravais2)))
    sigma_trt = mp.diffuse / jnp.maximum(jnp.cos(theta_r_trt), _EPS)[:, None]
    att_trt = ((1.0 - fres_trt) ** 2 * fres_trt)[:, None] * \
        jnp.exp(-2.0 * sigma_trt * (1.0 + cos_2gt2)[:, None]) ** 2
    refl_trt = m_trt[:, None] * 0.5 * att_trt * d_trt[:, None]
    pdf_trt = m_trt

    zero3 = jnp.zeros_like(nin)
    ones = jnp.ones(nin.shape[0])
    zeros_i = jnp.zeros(nin.shape[0], jnp.int32)

    def w3(m, a, b):
        return jnp.where(m[:, None], a, b)

    first_refl = w3(first, refl_r, zero3)
    first_wo = w3(first, wo_r, wo_enter)
    first_pdf = jnp.where(first, pdf_r, 1.0)
    first_flags = jnp.where(first, MATFLAG_SPECULAR_BOUNCE, flag_enter).astype(jnp.int32)

    refl = w3(state_tt, refl_tt, w3(state_tr_pending, zero3, w3(state_trt_exit, refl_trt, first_refl)))
    wo = w3(state_tt, wo_tt, w3(state_tr_pending, wo_tr, w3(state_trt_exit, wo_trt, first_wo)))
    pdf = jnp.where(state_tt, pdf_tt, jnp.where(state_tr_pending, 1.0,
          jnp.where(state_trt_exit, pdf_trt, first_pdf)))
    fl = jnp.where(state_tt, zeros_i, jnp.where(state_tr_pending, flags_tr,
         jnp.where(state_trt_exit, zeros_i, first_flags)))
    theta_i = theta_i_in
    return HairSample(refl, wo, pdf, fl.astype(jnp.int32), theta_i)


def sample_hair(mp: MatParams, wi, n, fu, fv, fw, flags, p_choice) -> HairSample:
    """Dispatch Marschner vs d'Eon per ray."""
    m = marschner_sample(mp, wi, n, fu, fv, fw, flags, p_choice)
    d = deon_sample(mp, wi, n, fu, fv, fw, flags, p_choice)
    is_deon = mp.bsdf_id == BSDF_DEON_HAIR
    return HairSample(
        reflectance=jnp.where(is_deon[:, None], d.reflectance, m.reflectance),
        wo=jnp.where(is_deon[:, None], d.wo, m.wo),
        pdf=jnp.where(is_deon, d.pdf, m.pdf),
        flags=jnp.where(is_deon, d.flags, m.flags).astype(jnp.int32),
        theta_i=jnp.where(is_deon, d.theta_i, m.theta_i),
    )


# ---------------------------------------------------------------------------
# Closed-form single-pass Marschner (Whitted / differentiable path)
# ---------------------------------------------------------------------------

def hair_tangent(normal):
    """Tangent construction of the Whitted fur shader
    (Simple_CPU_Raytracer.cpp:470-472): larger of n×z, n×y."""
    c1 = jnp.cross(normal, jnp.array([0.0, 0.0, 1.0]))
    c2 = jnp.cross(normal, jnp.array([0.0, 1.0, 0.0]))
    use1 = vm.length(c1) > vm.length(c2)
    return vm.normalize(jnp.where(use1[..., None], c1, c2))


class ClosedFormLobes(NamedTuple):
    scat_r: jnp.ndarray  # [R,3]
    scat_tt: jnp.ndarray
    scat_trt: jnp.ndarray
    sin_theta_i: jnp.ndarray  # [R]


def marschner_closed_form(
    mp: MatParams,
    ray_dir,  # [R,3] incoming ray direction (toward the surface)
    normal,  # [R,3] hit normal
    fiber_axis,  # [R,3] cone V axis (rotation axis for lobe tilts)
    t_normal,  # [R,3] normal at the TT second-wall hit
    tr_normal,  # [R,3] normal at the TRT first-wall re-hit
) -> ClosedFormLobes:
    """Single-pass R+TT+TRT lobes (Simple_CPU_Raytracer.cpp:451-746).

    The caller supplies the second/third wall normals (the reference traces
    the accel structure for them, :575-585; the differentiable path computes
    them analytically on the same cone).
    """
    nin = vm.normalize(ray_dir)
    tangent = hair_tangent(normal)
    alpha = mp.hair_alpha  # degrees-as-radians parity quirk
    beta = mp.hair_beta
    ior = mp.ior

    sin_theta_i = vm.dot(nin, tangent)
    theta_i = jnp.arcsin(_clip1(sin_theta_i))
    in_plane = vm.normalize(nin - sin_theta_i[:, None] * tangent)
    nf = vm.faceforward(normal, -nin, normal)

    def lobe_angles(out_ray):
        outn = vm.normalize(out_ray)
        sin_tr = vm.dot(outn, tangent)
        theta_r = jnp.arcsin(_clip1(sin_tr))
        out_plane = vm.normalize(outn - sin_tr[:, None] * tangent)
        # the reference clamps only the +1 side (glm acos NaNs below -1 the
        # same way); clamp both for f32 robustness
        phi = jnp.arccos(_clip1(vm.dot(out_plane, in_plane)))
        return theta_r, phi

    # ---- R lobe (:506-563)
    out_r = vm.rotate_about_axis(vm.reflect(-nin, nf), fiber_axis, -alpha)
    theta_r, phi = lobe_angles(out_r)
    theta_h = 0.5 * (theta_r + theta_i)
    theta_d = 0.5 * (theta_r - theta_i)
    m_r = sp.normal_gauss_pdf(theta_h - jnp.radians(alpha), 0.0, beta)
    h_r = jnp.sin(phi) * -0.5
    gamma_r = jnp.arcsin(_clip1(h_r))
    dh_dphi_r = jnp.abs(_safe_div(-2.0, jnp.sqrt(jnp.maximum(1.0 - h_r * h_r, _EPS))))
    b1, b2 = _bravais(ior, gamma_r)
    fr = sp.dielectric_fresnel(jnp.cos(gamma_r), b1, b2)
    fr = jnp.where(fr == 1.0, 0.0, fr)  # fresnel==1 → 0 hack (:551)
    n_r = 0.5 * fr * dh_dphi_r
    scat_r = (m_r * n_r / jnp.maximum(jnp.cos(theta_d) ** 2, _EPS))[:, None] * \
        jnp.ones_like(nin)

    # ---- TT lobe (:570-646)
    t_dir = vm.refract(-nin, nf, (1.0 / ior)[:, None])
    t_nf = vm.faceforward(t_normal, -vm.normalize(t_dir), t_normal)
    out_tt = vm.refract(-vm.normalize(t_dir), t_nf, 1.0)
    out_tt = vm.rotate_about_axis(out_tt, fiber_axis, alpha / 2.0)
    theta_r_tt, phi_tt = lobe_angles(out_tt)
    theta_h_tt = 0.5 * (theta_r_tt + theta_i)
    theta_d_tt = 0.5 * (theta_r_tt - theta_i)
    m_tt = sp.normal_gauss_pdf(theta_h_tt - jnp.radians(-alpha / 2.0), 0.0, beta / 2.0)
    a_inv = 1.0 / ior
    nenner = jnp.sqrt(jnp.maximum(
        1.0 + a_inv ** 2 - 2.0 * a_inv * jnp.sign(phi_tt) * jnp.sin(phi_tt / 2.0), _EPS))
    h_tt = jnp.sign(phi_tt) * jnp.cos(phi_tt / 2.0) / nenner
    gamma_tt = jnp.arcsin(_clip1(h_tt))
    b1t, b2t = _bravais(ior, gamma_tt)
    c_tt = jnp.arcsin(_clip1(1.0 / b1t))
    pi = jnp.pi
    denom_tt = _safe_div(1.0, jnp.sqrt(jnp.maximum(1.0 - h_tt * h_tt, _EPS))) * (
        -(24.0 * c_tt / pi ** 3) * gamma_tt ** 2 + (6.0 * c_tt / pi - 2.0))
    dh_dphi_tt = _safe_div(1.0, jnp.abs(denom_tt))
    f_tt = sp.dielectric_fresnel(jnp.cos(gamma_tt), b1t, b2t)
    f_tt = jnp.where(f_tt == 1.0, 0.0, f_tt)
    cos_gamma_t = 2.0 * jnp.cos(jnp.arcsin(_clip1(h_tt / b1t)))
    sigma = mp.diffuse / jnp.maximum(jnp.cos(theta_r_tt), _EPS)[:, None]
    att_tt = ((1.0 - f_tt) ** 2)[:, None] * jnp.exp(sigma * cos_gamma_t[:, None])
    n_tt = 0.5 * att_tt * dh_dphi_tt[:, None]
    scat_tt = m_tt[:, None] * n_tt / jnp.maximum(jnp.cos(theta_d_tt) ** 2, _EPS)[:, None]

    # ---- TRT lobe (:654-745)
    tr_dir = vm.reflect(-vm.normalize(t_dir), t_nf)
    tr_nf = vm.faceforward(tr_normal, -vm.normalize(tr_dir), tr_normal)
    out_trt = vm.refract(-vm.normalize(tr_dir), tr_nf, _clip1(ior)[:, None])
    out_trt = vm.rotate_about_axis(out_trt, fiber_axis, 3.0 * alpha / 2.0)
    theta_r_trt, phi_trt = lobe_angles(out_trt)
    theta_h_trt = 0.5 * (theta_r_trt + theta_i)
    theta_d_trt = 0.5 * (theta_r_trt - theta_i)
    m_trt = sp.normal_gauss_pdf(theta_h_trt - jnp.radians(-3.0 * alpha / 2.0), 0.0, 2.0 * beta)
    gamma_trt = vm.angle_between(nin, vm.normalize(normal))
    h_trt = jnp.sin(gamma_trt)
    b1r, b2r = _bravais(ior, gamma_trt)
    c_trt = jnp.arcsin(_clip1(1.0 / b1r))
    denom_trt = _safe_div(1.0, jnp.sqrt(jnp.maximum(1.0 - h_trt * h_trt, _EPS))) * (
        -(48.0 * c_trt / pi ** 3) * gamma_trt ** 2 + (12.0 * c_trt / pi - 2.0))
    dh_dphi_trt = _safe_div(1.0, jnp.abs(denom_trt))
    f_trt = sp.dielectric_fresnel(jnp.cos(gamma_trt), b1r, b2r)
    f_trt = jnp.where(f_trt == 1.0, 0.0, f_trt)
    gamma_t2 = jnp.arcsin(_clip1(h_trt / b1r))
    cos_gamma_t2 = jnp.cos(gamma_t2)
    f_exit = sp.dielectric_fresnel(cos_gamma_t2, 1.0 / b1r, 1.0 / b2r)
    sigma2 = mp.diffuse / jnp.maximum(jnp.cos(theta_r_trt), _EPS)[:, None]
    att_trt = ((1.0 - f_trt) ** 2 * f_exit)[:, None] * \
        jnp.exp(sigma2 * (-2.0 * cos_gamma_t2)[:, None]) ** 2
    n_trt = 0.5 * att_trt * dh_dphi_trt[:, None]
    scat_trt = m_trt[:, None] * n_trt / jnp.maximum(jnp.cos(theta_d_trt) ** 2, _EPS)[:, None]

    # degenerate configurations (out ray parallel to the tangent, zero
    # refract vectors at exact grazing) produce non-finite lobe values in
    # f32; they carry no energy — scrub to 0
    def finite(x):
        return jnp.where(jnp.isfinite(x), x, 0.0)

    return ClosedFormLobes(finite(scat_r), finite(scat_tt), finite(scat_trt),
                           sin_theta_i)
