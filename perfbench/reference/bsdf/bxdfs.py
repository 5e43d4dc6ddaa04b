"""BxDF lobe library, shading space y-up (counterpart of
``mcrt_tpu/bsdf/bxdfs.py``): shading-space trig, Fresnel dielectric /
conductor / Schlick, Lambertian, Oren-Nayar, Fresnel-blend,
roughness->alpha, Trowbridge-Reitz and Beckmann microfacet D/Λ/G,
Torrance-Sparrow reflection/transmission and the wh samplers.  Branch-free:
invalid configurations give zeros through masks."""
from __future__ import annotations

import math

import torch

from ..core import math as m

INV_PI = 1.0 / math.pi
TROWBRIDGE_REITZ = 0
BECKMANN = 1


def cos_theta(w):
    return w[..., 1]


def abs_cos_theta(w):
    return torch.abs(w[..., 1])


def cos2_theta(w):
    return w[..., 1] * w[..., 1]


def sin2_theta(w):
    return m.fmax(1.0 - cos2_theta(w), 0.0)


def _dsqrt(x, eps: float = 1e-18):
    """sqrt with a bounded derivative at 0 (value shifted by <= 1e-9)."""
    return torch.sqrt(m.fmax(x, eps))


def sin_theta(w):
    return _dsqrt(sin2_theta(w))


def tan_theta(w):
    return m.safe_div(sin_theta(w), cos_theta(w))


def tan2_theta(w):
    return m.safe_div(sin2_theta(w), cos2_theta(w))


def cos_phi(w):
    s = sin_theta(w)
    return torch.where(s == 0.0, 1.0, m.fclip(
        w[..., 0] / torch.where(s == 0.0, 1.0, s), -1.0, 1.0))


def sin_phi(w):
    s = sin_theta(w)
    return torch.where(s == 0.0, 0.0, m.fclip(
        w[..., 2] / torch.where(s == 0.0, 1.0, s), -1.0, 1.0))


def same_hemisphere(w, wp):
    return w[..., 1] * wp[..., 1] > 0.0


def reflect_local(wo):
    """Mirror about the +y shading normal."""
    return torch.stack([-wo[..., 0], wo[..., 1], -wo[..., 2]], dim=-1)


def refract_local(wo, eta_i_over_t):
    """Refract wo about ±y; returns (wi, total internal reflection mask)."""
    cos_i = cos_theta(wo)
    n_y = torch.where(cos_i >= 0.0, 1.0, -1.0)
    cos_i_abs = torch.abs(cos_i)
    sin2_i = m.fmax(1.0 - cos_i_abs * cos_i_abs, 0.0)
    sin2_t = eta_i_over_t * eta_i_over_t * sin2_i
    tir = sin2_t >= 1.0
    cos_t = _dsqrt(1.0 - sin2_t)
    y_axis = torch.stack([torch.zeros_like(n_y), torch.ones_like(n_y),
                          torch.zeros_like(n_y)], dim=-1)
    wi = -eta_i_over_t[..., None] * wo + (
        (eta_i_over_t * cos_i_abs - cos_t) * n_y)[..., None] * y_axis
    return m.normalize(wi), tir


def fresnel_dielectric(cos_theta_i, eta_i, eta_t):
    """Exact dielectric Fresnel; a negative cos_theta_i swaps the etas."""
    entering = cos_theta_i > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(m.fclip(cos_theta_i, -1.0, 1.0))
    sin_i = _dsqrt(1.0 - ci * ci)
    sin_t = ei / et * sin_i
    tir = sin_t >= 1.0
    ct = _dsqrt(1.0 - sin_t * sin_t)
    r_parl = m.safe_div(et * ci - ei * ct, et * ci + ei * ct)
    r_perp = m.safe_div(ei * ci - et * ct, ei * ci + et * ct)
    f = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(tir, 1.0, f)


def fresnel_conductor(cos_theta_i, eta, k):
    """Conductor Fresnel with per-channel eta/k (..., 3)."""
    ci = m.fclip(torch.abs(cos_theta_i), 0.0, 1.0)[..., None]
    cos2 = ci * ci
    sin2 = 1.0 - cos2
    eta2 = eta * eta
    k2 = k * k
    t0 = eta2 - k2 - sin2
    a2b2 = _dsqrt(t0 * t0 + 4.0 * eta2 * k2)
    t1 = a2b2 + cos2
    a = _dsqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * ci
    rs = m.safe_div(t1 - t2, t1 + t2)
    t3 = cos2 * a2b2 + sin2 * sin2
    t4 = t2 * sin2
    rp = rs * m.safe_div(t3 - t4, t3 + t4)
    return 0.5 * (rp + rs)


def fresnel_schlick(cos_theta_i, f0):
    c = m.fclip(1.0 - torch.abs(cos_theta_i), 0.0, 1.0)
    return f0 + (1.0 - f0) * (c ** 5)[..., None]


def lambertian_f(albedo):
    return albedo * INV_PI


def fresnel_blend_f(rd, rs, alpha, wo, wi, dist: int = TROWBRIDGE_REITZ):
    """Ashikhmin-Shirley coupled diffuse + Schlick-Fresnel specular blend."""
    ci = abs_cos_theta(wi)
    co = abs_cos_theta(wo)
    wh = wi + wo
    wh_len = _dsqrt(m.length_sq(wh), 1e-24)
    ok = (ci > 0) & (co > 0) & (wh_len > 1e-12) & same_hemisphere(wo, wi)
    wh_n = wh * m.safe_div(torch.ones_like(wh_len), wh_len)[..., None]
    diff = ((28.0 / (23.0 * math.pi)) * rd * (1.0 - rs)
            * ((1.0 - (1.0 - 0.5 * ci) ** 5) * (1.0 - (1.0 - 0.5 * co) ** 5))[..., None])
    d = mf_d(wh_n, alpha, dist)
    denom = 4.0 * torch.abs(m.dot(wi, wh_n)) * torch.maximum(ci, co)
    spec = m.safe_div(d, denom)[..., None] * fresnel_schlick(m.dot(wi, wh_n), rs)
    return torch.where(ok[..., None], diff + spec, 0.0)


def oren_nayar_f(albedo, sigma_deg, wo, wi):
    """Oren-Nayar; sigma in degrees."""
    sigma = torch.deg2rad(torch.as_tensor(sigma_deg, dtype=torch.float32))
    s2 = sigma * sigma
    a = 1.0 - s2 / (2.0 * (s2 + 0.33))
    b = 0.45 * s2 / (s2 + 0.09)
    sin_ti = sin_theta(wi)
    sin_to = sin_theta(wo)
    cos_diff = cos_phi(wi) * cos_phi(wo) + sin_phi(wi) * sin_phi(wo)
    max_cos = m.fmax(cos_diff, 0.0)
    abs_ci = abs_cos_theta(wi)
    abs_co = abs_cos_theta(wo)
    sin_a = torch.where(abs_ci > abs_co, sin_to, sin_ti)
    tan_b = torch.where(abs_ci > abs_co, m.safe_div(sin_ti, abs_ci),
                        m.safe_div(sin_to, abs_co))
    return albedo * (INV_PI * (a + b * max_cos * sin_a * tan_b))[..., None]


def roughness_to_alpha(roughness):
    """PBRT-style remap."""
    x = torch.log(m.fmax(roughness, 1e-3))
    return (1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x ** 3
            + 0.000640711 * x ** 4)


def tr_d(wh, alpha):
    """Trowbridge-Reitz (GGX) NDF."""
    t2 = tan2_theta(wh)
    c4 = cos2_theta(wh) ** 2
    a2 = alpha * alpha
    e = t2 / a2
    denom = math.pi * a2 * c4 * (1.0 + e) ** 2
    d = m.safe_div(torch.ones_like(denom), denom)
    return torch.where(torch.isfinite(t2), d, 0.0)


def tr_lambda(w, alpha):
    t = torch.abs(tan_theta(w))
    a2t2 = (alpha * t) ** 2
    lam = 0.5 * (-1.0 + torch.sqrt(1.0 + a2t2))
    return torch.where(torch.isfinite(t), lam, 0.0)


def beckmann_d(wh, alpha):
    t2 = tan2_theta(wh)
    c4 = cos2_theta(wh) ** 2
    a2 = alpha * alpha
    d = m.safe_div(torch.exp(-t2 / a2), math.pi * a2 * c4)
    return torch.where(torch.isfinite(t2), d, 0.0)


def beckmann_lambda(w, alpha):
    t = torch.abs(tan_theta(w))
    a = m.safe_div(torch.ones_like(t), alpha * t)
    lam = torch.where(a >= 1.6, 0.0,
                      m.safe_div(1.0 - 1.259 * a + 0.396 * a * a,
                                 3.535 * a + 2.181 * a * a))
    return torch.where(torch.isfinite(t), lam, 0.0)


def mf_d(wh, alpha, dist: int = TROWBRIDGE_REITZ):
    return tr_d(wh, alpha) if dist == TROWBRIDGE_REITZ else beckmann_d(wh, alpha)


def mf_lambda(w, alpha, dist: int = TROWBRIDGE_REITZ):
    return tr_lambda(w, alpha) if dist == TROWBRIDGE_REITZ else beckmann_lambda(w, alpha)


def mf_g1(w, alpha, dist: int = TROWBRIDGE_REITZ):
    return 1.0 / (1.0 + mf_lambda(w, alpha, dist))


def mf_g(wo, wi, alpha, dist: int = TROWBRIDGE_REITZ):
    return 1.0 / (1.0 + mf_lambda(wo, alpha, dist) + mf_lambda(wi, alpha, dist))


def mf_sample_wh(wo, u2, alpha, dist: int = TROWBRIDGE_REITZ):
    """Sample the full NDF (not the VNDF), flipped into wo's hemisphere."""
    phi = 2.0 * math.pi * u2[..., 1]
    if dist == TROWBRIDGE_REITZ:
        t2 = alpha * alpha * m.safe_div(u2[..., 0], 1.0 - u2[..., 0])
    else:
        t2 = -alpha * alpha * torch.log(torch.clamp_min(1.0 - u2[..., 0], 1e-20))
    ct = 1.0 / torch.sqrt(1.0 + t2)
    st = torch.sqrt(m.fmax(1.0 - ct * ct, 0.0))
    wh = m.spherical_direction(st, ct, phi)
    return torch.where(same_hemisphere(wo, wh)[..., None], wh, -wh)


def mf_pdf_wh(wo, wh, alpha, dist: int = TROWBRIDGE_REITZ):
    """pdf of mf_sample_wh in the half-vector measure: D(wh)|cosθ_h|."""
    return mf_d(wh, alpha, dist) * abs_cos_theta(wh)


def microfacet_reflection_f(r, alpha, eta_a, eta_b, wo, wi,
                            dist: int = TROWBRIDGE_REITZ):
    """Torrance-Sparrow reflection with dielectric Fresnel; (..., 3)."""
    ci = abs_cos_theta(wi)
    co = abs_cos_theta(wo)
    wh = wi + wo
    wh_len = _dsqrt(m.length_sq(wh), 1e-24)
    ok = (ci > 0) & (co > 0) & (wh_len > 1e-12) & same_hemisphere(wo, wi)
    wh_n = wh * m.safe_div(torch.ones_like(wh_len), wh_len)[..., None]
    f_cos = m.dot(wi, torch.where(wh_n[..., 1:2] < 0.0, -wh_n, wh_n))
    fr = fresnel_dielectric(f_cos, eta_a, eta_b)
    val = (mf_d(wh_n, alpha, dist) * mf_g(wo, wi, alpha, dist) * fr) * m.safe_div(
        torch.ones_like(ci), 4.0 * ci * co)
    return torch.where(ok[..., None], r * val[..., None], 0.0)


def microfacet_reflection_pdf(wo, wi, alpha, dist: int = TROWBRIDGE_REITZ):
    wh = wi + wo
    wh_len = _dsqrt(m.length_sq(wh), 1e-24)
    ok = same_hemisphere(wo, wi) & (wh_len > 1e-12)
    wh_n = wh * m.safe_div(torch.ones_like(wh_len), wh_len)[..., None]
    pdf = m.safe_div(mf_pdf_wh(wo, wh_n, alpha, dist), 4.0 * torch.abs(m.dot(wo, wh_n)))
    return torch.where(ok, pdf, 0.0)


def microfacet_transmission_f(t_col, alpha, eta_a, eta_b, wo, wi,
                              radiance_mode: bool = True,
                              dist: int = TROWBRIDGE_REITZ):
    """Rough dielectric transmission."""
    ci = cos_theta(wi)
    co = cos_theta(wo)
    ok = (ci * co < 0.0) & (torch.abs(ci) > 1e-8) & (torch.abs(co) > 1e-8)
    eta = torch.where(co > 0.0, eta_b / eta_a, eta_a / eta_b)
    wh = m.normalize(wo + wi * eta[..., None])
    wh = torch.where(wh[..., 1:2] < 0.0, -wh, wh)
    sq_denom = m.dot(wo, wh) + eta * m.dot(wi, wh)
    fr = fresnel_dielectric(m.dot(wo, wh), eta_a, eta_b)
    factor = 1.0 / eta if radiance_mode else torch.ones_like(eta)
    val = ((1.0 - fr) * mf_d(wh, alpha, dist) * mf_g(wo, wi, alpha, dist)
           * torch.abs(m.safe_div(
               eta * eta * torch.abs(m.dot(wi, wh)) * torch.abs(m.dot(wo, wh))
               * factor * factor,
               ci * co * sq_denom * sq_denom)))
    return torch.where(ok[..., None], t_col * val[..., None], 0.0)


def microfacet_transmission_pdf(wo, wi, alpha, eta_a, eta_b,
                                dist: int = TROWBRIDGE_REITZ):
    ci = cos_theta(wi)
    co = cos_theta(wo)
    ok = ci * co < 0.0
    eta = torch.where(co > 0.0, eta_b / eta_a, eta_a / eta_b)
    wh = m.normalize(wo + wi * eta[..., None])
    sq_denom = m.dot(wo, wh) + eta * m.dot(wi, wh)
    dwh_dwi = torch.abs(m.safe_div(eta * eta * m.dot(wi, wh), sq_denom * sq_denom))
    return torch.where(ok, mf_pdf_wh(wo, wh, alpha, dist) * dwh_dwi, 0.0)
