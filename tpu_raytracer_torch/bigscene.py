"""The big scene past the BVH walk's cap, its ray sets, and the walk's
step statistics: `chip_smoke.py` phase 23 checks K8 on the scene and
rays, and `bvh_variants.py` runs all three.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.scenes import PI
from .scene.builder import SceneBuilder
from .scene.geometry import create_plane, create_sphere
from .scene.material import Material
from .utils.math3d import rotation_x, scale, translation


def big_scene(dev, subdiv, xs, brute_max=None):
    """scripts/ucb_bigscene.py:30-48's scene: the floor, the quad light and
    an icosphere of subdivision `subdiv` (20 x 4^subdiv triangles) at each
    x of `xs`, flattened (instancing off), with the cap `brute_max`."""
    b = SceneBuilder()
    plane_id = b.add_mesh(create_plane())
    mat = b.add_material(Material((0.73, 0.73, 0.73, 1.0)))
    body = b.add_material(Material((0.8, 0.7, 0.5, 1.0)).roughness(0.4))
    b.add_instance(plane_id, mat, translation([0, -1, 0]) @ scale(2.0))
    b.register_quad_light(
        plane_id, translation([0, 0.99, 0]) @ rotation_x(PI) @ scale(0.5),
        [1.0, 1.0, 1.0], 10.0)
    sphere = b.add_mesh(create_sphere(subdiv))
    for tx in xs:
        b.add_instance(sphere, body,
                       translation([tx, -0.5, 0.0]) @ scale(0.42))
    return b.build(dev, instancing="off", brute_max=brute_max)


def walk_rays(dev, n):
    """scripts/ucb_bigscene.py:64-75's ray sets of n rays (seed 0):
    incoherent, from uniform points in [-0.9, 0.9]^3 in normal
    directions, and coherent, from (0, 0.2, 2.5) through a jittered grid
    toward -z; each ([3, n] o, [3, n] d, t_min 1e-3, t_max 100)."""
    rng = np.random.default_rng(0)
    ro_i = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    rd_i = rng.standard_normal((n, 3)).astype(np.float32)
    px = rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32)
    rd_c = np.stack([px[:, 0], px[:, 1] - 0.3, np.full(n, -1.0, np.float32)],
                    axis=1)
    ro_c = np.broadcast_to(np.float32([0.0, 0.2, 2.5]), (n, 3))
    t_min = torch.full((n,), 1e-3, device=dev)
    t_max = torch.full((n,), 100.0, device=dev)
    out = {}
    for name, o, d in (("incoherent", ro_i, rd_i), ("coherent", ro_c, rd_c)):
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
        o, d = (torch.from_numpy(np.ascontiguousarray(x.T, np.float32))
                .to(dev) for x in (o, d))
        out[name] = (o, d, t_min, t_max)
    return out


def step_stats(counted) -> dict:
    """The walk's steps per ray from `trace_plain(count=True)`: mean, p99
    and max; the mean over warps (32 lanes in call order) of each warp's
    longest lane over the mean lane; the box misses (jumps) per ray, mean
    and max."""
    steps = (counted["box_steps"] + counted["tri_steps"]).double()
    jumps = counted["jumps"].double()
    pad = -steps.numel() % 32
    warps = torch.cat([steps, steps.new_zeros(pad)]).view(-1, 32)
    mean = float(steps.mean())
    return {"mean": mean,
            "p99": float(torch.quantile(steps, 0.99)),
            "max": int(steps.max()),
            "warp_max_over_mean": float(warps.max(1).values.mean()) / mean,
            "jumps_mean": float(jumps.mean()), "jumps_max": int(jumps.max())}


def stats_text(st: dict) -> str:
    return (f"steps/ray mean {st['mean']:.2f}, p99 {st['p99']:.0f}, max "
            f"{st['max']}, warp max/mean {st['warp_max_over_mean']:.2f}, "
            f"jumps/ray mean {st['jumps_mean']:.2f}, max {st['jumps_max']}")
