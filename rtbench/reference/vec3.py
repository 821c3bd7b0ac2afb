"""Component-major 3-vectors for the wavefront.

Port of `tpu_raytracer/utils/vec3.py`: a `V3` holds three [R] tensors (or
scalars), and every helper keeps the reference's operation order per
element (dot products sum as ``(x + y) + z``), so results match the JAX
package up to the ulps of its transcendental functions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

EPS = 1e-6


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def of(a) -> V3:
    """[..., 3] tensor -> V3 of [...] components."""
    return V3(a[..., 0], a[..., 1], a[..., 2])


def arr(v: V3):
    """V3 -> [..., 3] tensor."""
    return torch.stack([v.x, v.y, v.z], dim=-1)


def cat(a: V3, b: V3) -> V3:
    return V3(torch.cat([a.x, b.x]), torch.cat([a.y, b.y]),
              torch.cat([a.z, b.z]))


def dot(a: V3, b: V3):
    return (a.x * b.x + a.y * b.y) + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def length(v: V3):
    return torch.sqrt(torch.clamp(dot(v, v), min=0.0))


def normalize(v: V3) -> V3:
    return v / torch.clamp(length(v), min=EPS)


def reflect(v: V3, n: V3) -> V3:
    return v - n * (2.0 * dot(v, n))


def refract(v: V3, n: V3, eta) -> V3:
    """WGSL refract; zero vector on total internal reflection."""
    cos_i = -dot(v, n)
    sin2_t = eta * eta * (1.0 - cos_i * cos_i)
    k = 1.0 - sin2_t
    tir = k < 0.0
    k = torch.clamp(k, min=0.0)
    out = v * eta + n * (eta * cos_i - torch.sqrt(k))
    return where(tir, 0.0, out)


def where(m, a, b) -> V3:
    """torch.where per component; a and b may be V3s or scalars."""
    ax, ay, az = (a.x, a.y, a.z) if isinstance(a, V3) else (a, a, a)
    bx, by, bz = (b.x, b.y, b.z) if isinstance(b, V3) else (b, b, b)
    return V3(torch.where(m, ax, bx), torch.where(m, ay, by),
              torch.where(m, az, bz))


def luminance(c: V3):
    """Rec. 709 luminance (restir.wgsl:742-744)."""
    return c.x * 0.2126 + c.y * 0.7152 + c.z * 0.0722


def vmax(v: V3):
    return torch.maximum(torch.maximum(v.x, v.y), v.z)


def all_leq_zero(v: V3):
    return (v.x <= 0.0) & (v.y <= 0.0) & (v.z <= 0.0)


def sign_pm(x):
    """+1 where x >= 0, else -1 (the reference's `where(x >= 0, 1, -1)`)."""
    return torch.where(x >= 0.0, 1.0, -1.0)


def oct_decode(ex, ey) -> V3:
    nz = 1.0 - torch.abs(ex) - torch.abs(ey)
    t = torch.clamp(-nz, min=0.0)
    nx = ex + torch.where(ex >= 0.0, -t, t)
    ny = ey + torch.where(ey >= 0.0, -t, t)
    return normalize(V3(nx, ny, nz))


def oct_encode(n: V3):
    """-> (ex, ey) [R] components."""
    l1 = torch.clamp(torch.abs(n.x) + torch.abs(n.y) + torch.abs(n.z),
                     min=EPS)
    rx = n.x / l1
    ry = n.y / l1
    fold = n.z < 0.0
    ex = torch.where(fold, (1.0 - torch.abs(ry)) * sign_pm(rx), rx)
    ey = torch.where(fold, (1.0 - torch.abs(rx)) * sign_pm(ry), ry)
    return ex, ey


def orthonormal_basis(n: V3):
    """Branchless ONB (restir.wgsl:161-168)."""
    sign = sign_pm(n.z)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    tangent = V3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    bitangent = V3(b, sign + n.y * n.y * a, -n.y)
    return tangent, bitangent


def to_world(tangent: V3, bitangent: V3, n: V3, v_local: V3) -> V3:
    return tangent * v_local.x + bitangent * v_local.y + n * v_local.z


def to_local(tangent: V3, bitangent: V3, n: V3, v_world: V3) -> V3:
    return V3(dot(v_world, tangent), dot(v_world, bitangent),
              dot(v_world, n))


def ipow(x, n: int):
    """x ** n for a positive int n, multiplied in the order JAX's
    `integer_pow` uses (binary exponentiation), so rounding matches."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc
