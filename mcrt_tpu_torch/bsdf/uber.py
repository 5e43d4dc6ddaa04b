"""Uber-BSDF: masked lobe mixture eval / pdf / sample (counterpart of
``mcrt_tpu/bsdf/uber.py``).

Five lobes: Lambertian (or its Fresnel-blend replacement), Torrance-Sparrow
glossy reflection, specular reflection (dielectric or conductor Fresnel),
specular transmission and opacity pass-through.  Every lobe is evaluated on
every lane and masked; lobe sampling picks uniformly among the present lobes
with u.x remapped to [0, 1).  The static scene-wide ``used`` mask skips
lobes no material carries.

Differentiability: ``sample(..., detach=True)``, the default, is the
detached estimator of inverse rendering: the sampled direction and the
non-delta mixture pdf carry no gradient, the BSDF value ``f`` (and the
delta lobes' weights) stay attached, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import math as m
from ..core.types import TensorRecord, device_constant
from ..sampling import samplers as smp
from . import bxdfs as bx

N_LOBES = 5
LOBE_DIFFUSE = 0
LOBE_GLOSSY = 1
LOBE_SPEC_REFL = 2
LOBE_SPEC_TRANS = 3
LOBE_PASSTHROUGH = 4
U_COND = 5
U_BLEND = 6

# The lobe pick reads the 5-bit code of a lane's lobe masks (bit k: lobe k is
# present) in two int32 tables, so it takes no scan over the masks: entry b
# of _POPCOUNT is the number of lobes code b holds, entry 5 b + c of
# _NTH_LOBE the index of its c-th lobe from 0 (0 where it has no c-th lobe).
_LOBE_BITS = tuple(1 << k for k in range(N_LOBES))
_POPCOUNT = tuple(b.bit_count() for b in range(1 << N_LOBES))
_NTH_LOBE = tuple(([k for k in range(N_LOBES) if b >> k & 1] + [0] * N_LOBES)[c]
                  for b in range(1 << N_LOBES) for c in range(N_LOBES))


@dataclass
class UberBSDF(TensorRecord):
    """Per-lane material properties after texture modulation."""

    diffuse: torch.Tensor  # (N, 3)
    glossy: torch.Tensor  # (N, 3)
    kr: torch.Tensor  # (N, 3)
    kt: torch.Tensor  # (N, 3)
    passthrough: torch.Tensor  # (N, 3) = 1 - opacity
    alpha: torch.Tensor  # (N,) microfacet alpha
    eta: torch.Tensor  # (N,) interior IOR (exterior 1)
    conductor_eta: torch.Tensor  # (N, 3)
    conductor_k: torch.Tensor  # (N, 3) any > 0 => conductor Fresnel
    rs_blend: torch.Tensor  # (N, 3) any > 0 => Fresnel blend
    dist: int = bx.TROWBRIDGE_REITZ
    used: tuple = (True,) * 7

    def is_fresnel_blend(self):
        return torch.any(self.rs_blend > 0.0, dim=-1)

    def is_conductor(self):
        return torch.any(self.conductor_k > 0.0, dim=-1)

    def lobe_masks(self):
        """(N, 5) bool: which lobes are present."""
        f = torch.zeros(self.alpha.shape, dtype=torch.bool, device=self.alpha.device)
        u = self.used
        return torch.stack([
            torch.any(self.diffuse > 0.0, -1) if u[LOBE_DIFFUSE] else f,
            torch.any(self.glossy > 0.0, -1) if u[LOBE_GLOSSY] else f,
            torch.any(self.kr > 0.0, -1) if u[LOBE_SPEC_REFL] else f,
            torch.any(self.kt > 0.0, -1) if u[LOBE_SPEC_TRANS] else f,
            torch.any(self.passthrough > 0.0, -1) if u[LOBE_PASSTHROUGH] else f,
        ], dim=-1)

    def num_lobes(self):
        return torch.sum(self.lobe_masks().to(torch.int32), dim=-1)

    def has_non_delta(self):
        msk = self.lobe_masks()
        return msk[..., LOBE_DIFFUSE] | msk[..., LOBE_GLOSSY]

    def is_pure_specular(self):
        return ~self.has_non_delta() & (self.num_lobes() > 0)


@dataclass
class BSDFSample(TensorRecord):
    wi: torch.Tensor  # (N, 3) shading space
    f: torch.Tensor  # (N, 3)
    pdf: torch.Tensor  # (N,)
    is_specular: torch.Tensor  # (N,)
    is_transmission: torch.Tensor  # (N,)
    valid: torch.Tensor  # (N,)


def _eta_for(wo_y, eta):
    """(eta_i, eta_t) ordered by which side wo is on (exterior IOR 1)."""
    ones = torch.ones_like(eta)
    entering = wo_y > 0.0
    return torch.where(entering, ones, eta), torch.where(entering, eta, ones)


def evaluate(bsdf: UberBSDF, wo: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """Sum of the non-delta lobes (reflection only)."""
    refl = bx.same_hemisphere(wo, wi)
    zero3 = torch.zeros_like(bsdf.diffuse)
    if bsdf.used[LOBE_DIFFUSE]:
        f_diff = bx.lambertian_f(bsdf.diffuse)
        if bsdf.used[U_BLEND]:
            f_blend = bx.fresnel_blend_f(bsdf.diffuse, bsdf.rs_blend, bsdf.alpha,
                                         wo, wi, bsdf.dist)
            f_diff = torch.where(bsdf.is_fresnel_blend()[..., None], f_blend, f_diff)
    else:
        f_diff = zero3
    f_gloss = (bx.microfacet_reflection_f(
        bsdf.glossy, bsdf.alpha, torch.ones_like(bsdf.eta), bsdf.eta, wo, wi,
        bsdf.dist) if bsdf.used[LOBE_GLOSSY] else zero3)
    msk = bsdf.lobe_masks()
    f = (torch.where(msk[..., LOBE_DIFFUSE, None], f_diff, 0.0)
         + torch.where(msk[..., LOBE_GLOSSY, None], f_gloss, 0.0))
    return torch.where(refl[..., None], f, 0.0)


def pdf(bsdf: UberBSDF, wo: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """Mixture pdf averaged over the present lobes; delta lobes give 0."""
    msk = bsdf.lobe_masks()
    num = torch.clamp_min(bsdf.num_lobes(), 1).to(torch.float32)
    refl = bx.same_hemisphere(wo, wi)
    zero = torch.zeros_like(bsdf.alpha)
    p_diff = (smp.cosine_hemisphere_pdf(bx.cos_theta(wi))
              if bsdf.used[LOBE_DIFFUSE] else zero)
    p_gloss = (bx.microfacet_reflection_pdf(wo, wi, bsdf.alpha, bsdf.dist)
               if bsdf.used[LOBE_GLOSSY] else zero)
    p = (torch.where(msk[..., LOBE_DIFFUSE] & refl, p_diff, 0.0)
         + torch.where(msk[..., LOBE_GLOSSY] & refl, p_gloss, 0.0))
    return p / num


def lobe_code(msk: torch.Tensor) -> torch.Tensor:
    """(N,) int32: the (N, 5) lobe masks as a 5-bit code, bit k for lobe k."""
    bits = device_constant(_LOBE_BITS, msk.device, torch.int32)
    return torch.sum(msk * bits, dim=-1, dtype=torch.int32)


def nth_lobe(code: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N,) int32: the index of each code's ``c``-th lobe, counting from 0;
    0 where it has none, as where ``c`` is -1."""
    # 5 code + c is -1 only for code 0 and c = -1: clamped onto entry 0, a 0
    index = torch.add(c, code, alpha=N_LOBES).clamp_min_(0)
    return device_constant(_NTH_LOBE, code.device, torch.int32).index_select(0, index)


def pick_lobe(msk: torch.Tensor, u: torch.Tensor):
    """One lobe a lane, uniform among the present ones of the (N, 5) masks
    ``msk`` by ``u`` in [0, 1): (lobe, the number of lobes present as int32,
    the same as float32 and at least 1).  A lane with no lobe picks lobe 0."""
    code = lobe_code(msk)
    num_i = device_constant(_POPCOUNT, code.device, torch.int32).index_select(0, code)
    num = torch.clamp_min(num_i, 1).to(torch.float32)
    c = torch.minimum((u * num).to(torch.int32), num_i - 1)
    return nth_lobe(code, c), num_i, num


def sample(bsdf: UberBSDF, wo: torch.Tensor, u3: torch.Tensor,
           detach: bool = True) -> BSDFSample:
    """Sample the lobe mixture.  u3[..., 0] picks the lobe (and is
    remapped); the rest drive the per-lobe direction sample.  With
    ``detach`` the sampled ``wi`` and the non-delta pdf are cut from the
    graph (the JAX package's ``stop_gradient``), so only ``f`` carries
    parameter gradients."""
    lobe, num_i, num = pick_lobe(bsdf.lobe_masks(), u3[..., 0])
    # every lobe samples its direction from the two fresh uniforms
    u2b = torch.stack([u3[..., 1], u3[..., 2]], dim=-1)

    eta_i, eta_t = _eta_for(bx.cos_theta(wo), bsdf.eta)
    u = bsdf.used
    zero3 = torch.zeros_like(wo)
    no = torch.zeros(wo.shape[:-1], dtype=torch.bool, device=wo.device)

    if u[LOBE_DIFFUSE]:
        wi_d = smp.cosine_hemisphere(u2b)
        flip = device_constant((1.0, -1.0, 1.0), wo.device)
        wi_d = torch.where((bx.cos_theta(wo) < 0.0)[..., None], wi_d * flip, wi_d)
    else:
        wi_d = zero3
    if u[LOBE_GLOSSY]:
        wh = bx.mf_sample_wh(wo, u2b, bsdf.alpha, bsdf.dist)
        wi_g = m.normalize(-wo + 2.0 * m.dot3(wo, wh) * wh)
        gloss_ok = bx.same_hemisphere(wo, wi_g)
    else:
        wi_g, gloss_ok = zero3, no
    wi_r = bx.reflect_local(wo) if u[LOBE_SPEC_REFL] else zero3
    if u[LOBE_SPEC_TRANS]:
        wi_t, tir = bx.refract_local(wo, eta_i / eta_t)
    else:
        wi_t, tir = zero3, no
    wi_p = -wo

    def pick(lb):
        return (lobe == lb)[..., None]

    wi = torch.where(pick(LOBE_DIFFUSE), wi_d, torch.where(
        pick(LOBE_GLOSSY), wi_g, torch.where(
            pick(LOBE_SPEC_REFL), wi_r, torch.where(pick(LOBE_SPEC_TRANS), wi_t, wi_p))))
    if detach:
        wi = wi.detach()

    is_spec = (lobe == LOBE_SPEC_REFL) | (lobe == LOBE_SPEC_TRANS) | (lobe == LOBE_PASSTHROUGH)
    abs_ci = m.fmax(bx.abs_cos_theta(wi), 1e-8)

    if u[LOBE_SPEC_REFL] or u[LOBE_SPEC_TRANS]:
        fr_r = bx.fresnel_dielectric(bx.cos_theta(wo), torch.ones_like(bsdf.eta), bsdf.eta)
    else:
        fr_r = torch.zeros_like(bsdf.eta)
    if u[LOBE_SPEC_REFL]:
        fr_r3 = fr_r[..., None]
        if u[U_COND]:
            fr_cond = bx.fresnel_conductor(bx.cos_theta(wo), bsdf.conductor_eta,
                                           bsdf.conductor_k)
            fr_r3 = torch.where(bsdf.is_conductor()[..., None], fr_cond, fr_r3)
        f_specr = bsdf.kr * fr_r3 / abs_ci[..., None]
    else:
        f_specr = zero3
    if u[LOBE_SPEC_TRANS]:
        eta_scale = (eta_i / eta_t) ** 2
        f_spect = bsdf.kt * ((1.0 - fr_r) * eta_scale / abs_ci)[..., None]
        f_spect = torch.where(tir[..., None], 0.0, f_spect)
    else:
        f_spect = zero3
    f_pass = bsdf.passthrough / abs_ci[..., None] if u[LOBE_PASSTHROUGH] else zero3

    f_nd = evaluate(bsdf, wo, wi)
    pdf_nd = pdf(bsdf, wo, wi)
    if detach:
        pdf_nd = pdf_nd.detach()
    f = torch.where(pick(LOBE_SPEC_REFL), f_specr, torch.where(
        pick(LOBE_SPEC_TRANS), f_spect, torch.where(pick(LOBE_PASSTHROUGH), f_pass, f_nd)))
    pdf_out = torch.where(is_spec, 1.0 / num, pdf_nd)

    valid = (num_i > 0) & (pdf_out > 0.0)
    valid = valid & torch.where(lobe == LOBE_GLOSSY, gloss_ok, True)
    valid = valid & torch.where(lobe == LOBE_SPEC_TRANS, ~tir, True)
    is_trans = bx.cos_theta(wi) * bx.cos_theta(wo) < 0.0
    return BSDFSample(
        wi=wi, f=torch.where(valid[..., None], f, 0.0),
        pdf=torch.where(valid, pdf_out, 0.0), is_specular=is_spec,
        is_transmission=is_trans, valid=valid,
    )


def has_non_delta(bsdf: UberBSDF) -> torch.Tensor:
    return bsdf.has_non_delta()
