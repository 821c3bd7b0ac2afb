"""The procedural meshes of the published scenes (fast-raytracing-wgpu
src/geometry.rs): plane, cube, icosphere and crystal, as the reference
uploads them (positions, octahedral normals, uvs, tangent4, a triangle
list). A frozen copy of the definitions, so that a scene's input does
not change with the program.
"""

from __future__ import annotations

import numpy as np


def _mesh(positions, oct_normals, uvs, tangents, indices) -> dict:
    return {"positions": positions, "oct_normals": oct_normals, "uvs": uvs,
            "tangents": tangents, "indices": indices}


def oct_encode_np(n: np.ndarray) -> np.ndarray:
    """Octahedral encode, numpy version of geometry.rs:56-76."""
    n = np.asarray(n, np.float32)
    single = n.ndim == 1
    n = np.atleast_2d(n)
    l1 = np.abs(n[:, 0]) + np.abs(n[:, 1]) + np.abs(n[:, 2])
    l1 = np.maximum(l1, 1e-20)
    res = n[:, :2] / l1[:, None]
    x, y = res[:, 0], res[:, 1]
    sign_x = np.where(x >= 0.0, 1.0, -1.0).astype(np.float32)
    sign_y = np.where(y >= 0.0, 1.0, -1.0).astype(np.float32)
    folded = np.stack([(1.0 - np.abs(y)) * sign_x, (1.0 - np.abs(x)) * sign_y], axis=-1)
    out = np.where((n[:, 2] < 0.0)[:, None], folded, res).astype(np.float32)
    return out[0] if single else out


def create_plane() -> dict:
    positions = np.array(
        [[-0.5, 0.0, 0.5], [0.5, 0.0, 0.5], [-0.5, 0.0, -0.5], [0.5, 0.0, -0.5]],
        np.float32,
    )
    n = oct_encode_np([0.0, 1.0, 0.0])
    oct_normals = np.tile(n, (4, 1)).astype(np.float32)
    uvs = np.array([[0, 1], [1, 1], [0, 0], [1, 0]], np.float32)
    tangents = np.tile(np.array([1.0, 0.0, 0.0, 1.0], np.float32), (4, 1))
    indices = np.array([0, 1, 2, 2, 1, 3], np.uint32)
    return _mesh(positions, oct_normals, uvs, tangents, indices)


def create_cube() -> dict:
    sides = [
        # (normal, tangent4, v0, v1, v2, v3) — geometry.rs:126-175
        ([0, 0, 1], [1, 0, 0, 1],
         [-0.5, -0.5, 0.5], [0.5, -0.5, 0.5], [0.5, 0.5, 0.5], [-0.5, 0.5, 0.5]),
        ([0, 0, -1], [-1, 0, 0, 1],
         [0.5, -0.5, -0.5], [-0.5, -0.5, -0.5], [-0.5, 0.5, -0.5], [0.5, 0.5, -0.5]),
        ([0, 1, 0], [1, 0, 0, 1],
         [-0.5, 0.5, 0.5], [0.5, 0.5, 0.5], [0.5, 0.5, -0.5], [-0.5, 0.5, -0.5]),
        ([0, -1, 0], [1, 0, 0, 1],
         [-0.5, -0.5, -0.5], [0.5, -0.5, -0.5], [0.5, -0.5, 0.5], [-0.5, -0.5, 0.5]),
        ([1, 0, 0], [0, 0, -1, 1],
         [0.5, -0.5, 0.5], [0.5, -0.5, -0.5], [0.5, 0.5, -0.5], [0.5, 0.5, 0.5]),
        ([-1, 0, 0], [0, 0, 1, 1],
         [-0.5, -0.5, -0.5], [-0.5, -0.5, 0.5], [-0.5, 0.5, 0.5], [-0.5, 0.5, -0.5]),
    ]
    positions, oct_normals, uvs, tangents, indices = [], [], [], [], []
    face_uvs = [[0, 1], [1, 1], [1, 0], [0, 0]]
    v_idx = 0
    for normal, tangent, *verts in sides:
        enc = oct_encode_np(normal)
        for v, uv in zip(verts, face_uvs):
            positions.append(v)
            oct_normals.append(enc)
            uvs.append(uv)
            tangents.append(tangent)
        indices += [v_idx, v_idx + 1, v_idx + 2, v_idx, v_idx + 2, v_idx + 3]
        v_idx += 4
    return _mesh(
        np.array(positions, np.float32), np.array(oct_normals, np.float32),
        np.array(uvs, np.float32), np.array(tangents, np.float32),
        np.array(indices, np.uint32),
    )


def create_sphere(subdivisions: int) -> dict:
    """Icosphere, radius 0.5 (geometry.rs:222-346)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    base = [
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ]
    positions: list = []
    for p in base:
        n = np.asarray(p, np.float64)
        n = n / np.linalg.norm(n)
        positions.append(n * 0.5)

    faces = [
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ]

    cache: dict = {}

    def midpoint(a: int, b: int) -> int:
        key = (a, b) if a < b else (b, a)
        if key in cache:
            return cache[key]
        mid = (positions[a] + positions[b]) * 0.5
        n = mid / np.linalg.norm(mid)
        positions.append(n * 0.5)
        idx = len(positions) - 1
        cache[key] = idx
        return idx

    for _ in range(subdivisions):
        new_faces = []
        for v1, v2, v3 in faces:
            a = midpoint(v1, v2)
            b = midpoint(v2, v3)
            c = midpoint(v3, v1)
            new_faces += [[v1, a, c], [v2, b, a], [v3, c, b], [a, b, c]]
        faces = new_faces

    pos = np.array(positions, np.float32)
    normals = pos / np.linalg.norm(pos, axis=1, keepdims=True)
    oct_normals = oct_encode_np(normals)
    uvs = np.zeros((len(pos), 2), np.float32)
    tangents = np.tile(np.array([1.0, 0.0, 0.0, 1.0], np.float32), (len(pos), 1))
    indices = np.array(faces, np.uint32).reshape(-1)
    return _mesh(pos, oct_normals, uvs, tangents, indices)


def create_crystal() -> dict:
    """Flat-shaded octahedral prism (geometry.rs:350-434)."""
    top_tip = np.array([0.0, 1.0, 0.0])
    top_ring = [np.array(p, np.float64) for p in
                [[0.3, 0.5, 0.3], [-0.3, 0.5, 0.3], [-0.3, 0.5, -0.3], [0.3, 0.5, -0.3]]]
    bottom_ring = [np.array(p, np.float64) for p in
                   [[0.3, -0.5, 0.3], [-0.3, -0.5, 0.3], [-0.3, -0.5, -0.3], [0.3, -0.5, -0.3]]]
    bottom_tip = np.array([0.0, -1.0, 0.0])

    positions, oct_normals, indices = [], [], []

    def add_face(p0, p1, p2):
        e1, e2 = p1 - p0, p2 - p0
        n = np.cross(e1, e2)
        n = n / np.linalg.norm(n)
        enc = oct_encode_np(n)
        base = len(positions)
        for p in (p0, p1, p2):
            positions.append(p)
            oct_normals.append(enc)
        indices.extend([base, base + 1, base + 2])

    for i in range(4):
        add_face(top_tip, top_ring[(i + 1) % 4], top_ring[i])
    for i in range(4):
        j = (i + 1) % 4
        add_face(top_ring[i], top_ring[j], bottom_ring[j])
        add_face(top_ring[i], bottom_ring[j], bottom_ring[i])
    for i in range(4):
        add_face(bottom_tip, bottom_ring[i], bottom_ring[(i + 1) % 4])

    pos = np.array(positions, np.float32)
    v = len(pos)
    return _mesh(
        pos, np.array(oct_normals, np.float32),
        np.zeros((v, 2), np.float32),
        np.tile(np.array([1.0, 0.0, 0.0, 1.0], np.float32), (v, 1)),
        np.array(indices, np.uint32),
    )
