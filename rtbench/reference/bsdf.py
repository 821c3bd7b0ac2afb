"""BSDF library: GGX specular (VNDF-sampled), Lambert diffuse, glass delta
(restir.wgsl:160-371; `tpu_raytracer/ops/bsdf.py`).

RNG draws per lane follow the reference exactly: a glass lane draws once
(reflect or refract), a non-glass lane three times (lobe, then u1, u2).
Integer powers are multiplied in the order of JAX's `integer_pow`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import rng, vec3
from .vec3 import V3, ipow

PI = float(np.float32(np.pi))


def fresnel_schlick(f0: V3, v_dot_h):
    c5 = ipow(torch.clamp(1.0 - v_dot_h, 0.0, 1.0), 5)
    return f0 + (1.0 - f0) * c5


def reflectance(cosine, ref_idx):
    """Schlick dielectric reflectance (restir.wgsl:175-180)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * ipow(1.0 - cosine, 5)


def ndf_ggx(n_dot_h, roughness):
    a = roughness * roughness
    a2 = a * a
    d = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    # a2 = 0 and d = 0 (delta lobe at the grazing peak) must give 0
    return a2 / torch.clamp(PI * d * d, min=1e-20)


def g1_ggx(n_dot_v, roughness):
    a2 = roughness * roughness
    return 2.0 * n_dot_v / torch.clamp(
        n_dot_v + torch.sqrt(a2 + (1.0 - a2) * n_dot_v * n_dot_v), min=1e-12)


def geometry_smith(n_dot_l, n_dot_v, roughness):
    return g1_ggx(n_dot_l, roughness) * g1_ggx(n_dot_v, roughness)


def sample_ggx_vndf(wo_local: V3, roughness, u1, u2) -> V3:
    """Visible-NDF sampling in local z-up space (restir.wgsl:202-216)."""
    alpha = roughness * roughness
    vh = vec3.normalize(V3(alpha * wo_local.x, alpha * wo_local.y,
                           wo_local.z))
    lensq = vh.x * vh.x + vh.y * vh.y
    pos_len = lensq > 0.0
    inv_len = torch.where(
        pos_len, 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20)), 0.0)
    t1 = V3(torch.where(pos_len, -vh.y * inv_len, 1.0),
            torch.where(pos_len, vh.x * inv_len, 0.0),
            torch.zeros_like(inv_len))
    t2 = vec3.cross(vh, t1)
    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh.z)
    p2_lerp = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) \
        + s * p2
    nh = (t1 * p1 + t2 * p2_lerp
          + vh * torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2_lerp * p2_lerp,
                                        min=0.0)))
    return vec3.normalize(V3(alpha * nh.x, alpha * nh.y,
                             torch.clamp(nh.z, min=0.0)))


def _mix_f0(base_color: V3, metallic):
    return 0.04 + (base_color - 0.04) * metallic


def _spec_diff_probability(base_color: V3, metallic, ffnormal: V3, wo: V3):
    """Fresnel-luminance lobe probability (restir.wgsl:328-334)."""
    f_view = fresnel_schlick(_mix_f0(base_color, metallic),
                             torch.clamp(vec3.dot(ffnormal, wo), min=0.0))
    lum_spec = vec3.luminance(f_view)
    lum_diff = vec3.luminance(base_color * (1.0 - metallic))
    return torch.clamp(lum_spec / (lum_spec + lum_diff + 1e-4), 0.001, 0.999)


def eval_pdf(normal: V3, wi: V3, wo: V3, mat, base_color: V3):
    """restir.wgsl:249-276. 0 for glass (delta) and invalid configs."""
    n_dot_l = vec3.dot(normal, wi)
    n_dot_v = vec3.dot(normal, wo)
    prob_spec = _spec_diff_probability(base_color, mat["metallic"], normal,
                                       wo)
    h = vec3.normalize(wi + wo)
    n_dot_h = torch.clamp(vec3.dot(normal, h), min=0.0)
    d = ndf_ggx(n_dot_h, mat["roughness"])
    g1 = g1_ggx(torch.clamp(n_dot_v, min=1e-6), mat["roughness"])
    pdf_spec = (d * g1) / torch.clamp(4.0 * n_dot_v, min=1e-6)
    pdf_diff = torch.clamp(n_dot_l, min=0.0) / PI
    pdf = prob_spec * pdf_spec + (1.0 - prob_spec) * pdf_diff
    invalid = (mat["transmission"] > 0.01) | (n_dot_l <= 0.0) \
        | (n_dot_v <= 0.0)
    return torch.where(invalid, 0.0, pdf)


def eval_bsdf(normal: V3, wi: V3, wo: V3, mat, base_color: V3) -> V3:
    """restir.wgsl:278-305. 0 for glass and invalid configs."""
    n_dot_l = vec3.dot(normal, wi)
    n_dot_v = vec3.dot(normal, wo)
    h = vec3.normalize(wi + wo)
    n_dot_h = torch.clamp(vec3.dot(normal, h), min=0.0)
    h_dot_v = torch.clamp(vec3.dot(h, wo), min=0.0)
    f0 = _mix_f0(base_color, mat["metallic"])

    d = ndf_ggx(n_dot_h, mat["roughness"])
    g = geometry_smith(torch.clamp(n_dot_l, min=1e-6),
                       torch.clamp(n_dot_v, min=1e-6), mat["roughness"])
    f = fresnel_schlick(f0, h_dot_v)
    specular = (f * (d * g)) / torch.clamp(4.0 * n_dot_l * n_dot_v, min=1e-3)
    kd = (1.0 - f) * (1.0 - mat["metallic"])
    diffuse = kd * base_color / PI

    invalid = (mat["transmission"] > 0.01) | (n_dot_l <= 0.0) \
        | (n_dot_v <= 0.0)
    return vec3.where(invalid, 0.0, diffuse + specular)


def sample_bsdf(state, wo: V3, ffnormal: V3, front_face, mat,
                base_color: V3, active):
    """restir.wgsl:307-371. Returns (state, dict(wi, pdf, weight,
    is_delta)). Lanes with `active` False draw nothing."""
    is_glass = mat["transmission"] > 0.01

    # glass delta lobe
    state, r_glass = rng.rand_if(state, is_glass & active)
    refraction_ratio = torch.where(front_face, 1.0 / mat["ior"], mat["ior"])
    cos_theta = torch.clamp(vec3.dot(wo, ffnormal), max=1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    cannot_refract = refraction_ratio * sin_theta > 1.0
    do_reflect = cannot_refract | (
        reflectance(cos_theta, refraction_ratio) > r_glass)
    wi_glass = vec3.where(do_reflect, vec3.reflect(-wo, ffnormal),
                          vec3.refract(-wo, ffnormal, refraction_ratio))

    # unified PBR stochastic lobe
    prob_spec = _spec_diff_probability(base_color, mat["metallic"], ffnormal,
                                       wo)
    not_glass = ~is_glass & active
    state, r_lobe = rng.rand_if(state, not_glass)
    state, r1 = rng.rand_if(state, not_glass)
    state, r2 = rng.rand_if(state, not_glass)
    pick_spec = r_lobe < prob_spec

    tangent, bitangent = vec3.orthonormal_basis(ffnormal)
    wo_local = vec3.to_local(tangent, bitangent, ffnormal, wo)
    wm_local = sample_ggx_vndf(wo_local, mat["roughness"], r1, r2)
    wm = vec3.to_world(tangent, bitangent, ffnormal, wm_local)
    wi_spec = vec3.reflect(-wo, wm)

    # diffuse: ffnormal + unit sphere sample (the same r1, r2)
    z = r1 * 2.0 - 1.0
    a = r2 * (2.0 * PI)
    rxy = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    unit = V3(rxy * torch.cos(a), rxy * torch.sin(a), z)
    wi_diff = vec3.normalize(ffnormal + unit)

    wi_pbr = vec3.where(pick_spec, wi_spec, wi_diff)
    n_dot_l = vec3.dot(ffnormal, wi_pbr)
    n_dot_v = vec3.dot(ffnormal, wo)
    valid = (n_dot_l > 0.0) & (n_dot_v > 0.0)

    bsdf_val = eval_bsdf(ffnormal, wi_pbr, wo, mat, base_color)
    pdf = eval_pdf(ffnormal, wi_pbr, wo, mat, base_color)
    weight_pbr = vec3.where(
        valid & (pdf > 0.0),
        (bsdf_val * n_dot_l) / torch.clamp(pdf, min=1e-20), 0.0)

    return state, {
        "wi": vec3.where(is_glass, wi_glass, wi_pbr),
        "pdf": torch.where(is_glass, 0.0, torch.where(valid, pdf, 0.0)),
        "weight": vec3.where(is_glass, base_color, weight_pbr),
        "is_delta": is_glass,
    }
