"""What decides `correct`: the frames the timed path produced, against the
reference's frames from the same inputs.

A frame's inputs are the camera and the scene at that frame and the frame
state it starts from. The reference (`rtbench/reference`) works out its
own scene tables and camera uniform from the description and the seed's
inputs. The first frame starts from a fresh state on both sides, so the
reference follows it without anything of the program's. A later frame
starts from the accumulation of every frame before it; the reference
steps from the program's state before that frame (copied as the frame
began) and must land on the program's state after it.

The numbers compared, each with its limit (`rtbench/limits/<cell>.json`);
larger is worse:
  hdr_gap        sum |HDR - reference HDR| / sum |reference HDR|
  ldr_px_pct     % of pixels whose displayed (LDR) value differs by more
                 than 1/255 in a channel
  state_px_pct   % of pixels whose next-frame state (G-buffer, reservoirs,
                 accumulation) differs in a word by more than a relative
                 1e-3 (NaN and infinity must match)
  rays_gap       |traversal queries - reference's| / reference's
  refit_gap      (cells that move instances) the program's refit scene
                 against the reference's: world triangles, their chunk
                 boxes, the shading rows' geometry, the instances'
                 transforms and normal matrices; largest gap over the
                 scene's extent
Each is the largest over the compared frames. Cells that take
screenshots (`shots.py`) add, on the one shot the seed picks:
  shot_gap       sum |denoised image - reference's| / sum |reference's|;
                 the reference (`reference/denoise.py`) denoises the
                 program's own HDR and G-buffer rows of that frame, so
                 this checks the denoiser alone
  png_px_pct     % of pixels whose byte in the written PNG (read by
                 `png.py`) differs by more than 1 in a channel from the
                 reference's sRGB bytes of its own denoised image; a PNG
                 that does not decode, or is not the frame's size in
                 8-bit RGB, reads infinite
"""

from __future__ import annotations

import contextlib
import math
import zlib

import numpy as np
import torch

from . import png
from .reference import camera as ref_camera
from .reference import denoise as ref_denoise
from .reference import lower
from .reference import pipeline as ref_pipeline
from .reference import tables

LDR_STEP = 1.0 / 255.0
STATE_REL = 1e-3
STATE_ABS = 1e-6


def _to_uniform(cam: dict, device) -> dict:
    out = {}
    for k, v in cam.items():
        v = np.asarray(v)
        if v.dtype == np.uint32:
            v = v.astype(np.int64)
        out[k] = torch.as_tensor(v, device=device)
    return out


def reference_uniforms(seq, frames: int, aspect: float, num_lights: int):
    """The camera uniform of each of the first `frames` frames, from the
    reference's own camera controller driven by the seed's inputs, with
    the app's counter: [(frame_count, static_ok, uniform dict)]."""
    cam = seq.controller(ref_camera.CameraController)
    out, frame_count = [], 0
    for i in range(frames):
        inp = seq.frame(i, None)
        for k in inp.keys:
            cam.press(k)
        moved = cam.update(inp.dt if inp.keys else 0.0)
        for k in list(cam.keys):
            cam.release(k)
        if moved:
            frame_count = 0
        out.append((frame_count, frame_count > 0,
                    cam.uniform(aspect, frame_count, num_lights)))
        frame_count += 1
    return out


def _bad_words(a, b):
    """Words of a and b that differ beyond STATE_REL (both NaN, or equal,
    is the same)."""
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    tol = STATE_ABS + STATE_REL * torch.maximum(a.abs(), b.abs())
    close = (a - b).abs() <= tol
    return ~(same | close)


def frame_gaps(prog: dict, ref: dict) -> dict:
    """The numbers of one frame: prog and ref hold ldr, hdr [n, 3],
    state {gb, res, accum} [n, C] and rays (a float)."""
    hdr_p, hdr_r = prog["hdr"].double(), ref["hdr"].double()
    den = hdr_r.abs().sum().clamp(min=1e-30)
    ldr = ~((prog["ldr"] - ref["ldr"]).abs() <= LDR_STEP).all(dim=-1)
    bad = torch.zeros(ldr.shape[0], dtype=torch.bool, device=ldr.device)
    for k in ref["state"]:
        a = prog["state"][k].reshape(bad.shape[0], -1)
        b = ref["state"][k].reshape(bad.shape[0], -1).to(a.device)
        bad |= _bad_words(a, b).any(dim=-1)
    rays_r = max(float(ref["rays"]), 1.0)
    return _finite({
        "hdr_gap": float((hdr_p - hdr_r).abs().sum() / den),
        "ldr_px_pct": 100.0 * float(ldr.double().mean()),
        "state_px_pct": 100.0 * float(bad.double().mean()),
        "rays_gap": abs(float(prog["rays"]) - float(ref["rays"])) / rays_r})


def _finite(numbers: dict) -> dict:
    """A NaN reading (a NaN in the program's frame) is the worst one."""
    return {k: math.inf if math.isnan(v) else v for k, v in numbers.items()}


def refit_gap(fields: dict, ref_scene, low: bool = False) -> float:
    """The program's refit scene fields (tri_planes [4, 3, Tp],
    chunk_aabb [Tp/128, 8], tri_table [T, 35], inst_transform [I, 3, 4],
    inst_normal_mat [I, 3, 3]) against the reference scene's world
    triangles and transforms, over the scene's extent. Each of the
    program's triangles is matched to the reference triangle of nearest
    centroid; a chunk's box must hold its triangles."""
    world = torch.as_tensor(ref_scene.world, dtype=torch.float64)
    tf = torch.as_tensor(ref_scene.inst_transform, dtype=torch.float64)
    nm = torch.as_tensor(ref_scene.inst_normal_mat, dtype=torch.float64)
    if low:   # the control: the reference's refit in bfloat16
        world, tf, nm = (x.to(torch.bfloat16).double() for x in (world, tf,
                                                                  nm))
    planes = fields["tri_planes"].double().cpu()
    valid = planes[3, 0] > 0.5
    v0 = planes[0].T[valid]
    v1, v2 = v0 + planes[1].T[valid], v0 + planes[2].T[valid]
    prog = torch.stack([v0, v1, v2], dim=1)                 # [T, 3, 3]
    extent = float((world.amax(dim=(0, 1)) - world.amin(dim=(0, 1)))
                   .abs().max())
    gaps = []
    if prog.shape[0] != world.shape[0]:
        return float("inf")
    near = torch.cdist(prog.mean(dim=1), world.mean(dim=1)).argmin(dim=1)
    gaps.append(float((prog - world[near]).abs().max()))
    # every valid slot inside its chunk's box
    box = fields["chunk_aabb"].double().cpu()
    slot_chunk = torch.nonzero(valid).squeeze(1) // 128
    lo, hi = box[slot_chunk, 0:3], box[slot_chunk, 3:6]
    out = torch.maximum((lo[:, None] - prog).amax(dim=(1, 2)),
                        (prog - hi[:, None]).amax(dim=(1, 2)))
    gaps.append(float(out.clamp(min=0.0).max()))
    # the shading rows' geometry is the triangles'
    rows = fields["tri_table"].double().cpu()[:, 26:35]
    ok = torch.cat([v0, v1 - v0, v2 - v0], dim=1)
    gaps.append(float((rows[:ok.shape[0]] - ok).abs().max()))
    gaps.append(float((fields["inst_transform"].double().cpu() - tf)
                      .abs().max()))
    gaps.append(float((fields["inst_normal_mat"].double().cpu() - nm)
                      .abs().max()))
    if any(math.isnan(g) for g in gaps):
        return math.inf
    return max(gaps) / max(extent, 1e-30)


def reference_frame(desc, device, width, height, uniform, frame_count,
                    static_ok, gb_reuse, state, transforms, control=None):
    """The reference's frame from `state` (None: a fresh state): a dict
    with ldr, hdr, state and rays, and the reference scene. `control`
    names a lowered precision (`lower.CONTROLS`)."""
    mode = lower.CONTROLS[control]() if control else contextlib.nullcontext()
    with torch.no_grad(), mode:
        with lower.rays():
            scene = tables.build(desc, device, transforms=transforms)
            camera = _to_uniform(uniform, device)
        if state is None:
            state = ref_pipeline.init_state(width, height, device)
        ldr, hdr, new_state, aux = ref_pipeline.render_frame(
            scene, camera, frame_count, state, width, height,
            static_ok=static_ok, gb_reuse=gb_reuse)
    return {"ldr": ldr, "hdr": hdr, "state": new_state,
            "rays": float(aux["rays"])}, scene


def judge(numbers: dict, limits: dict) -> bool:
    """Every number within its limit (a number with no limit fails)."""
    return all(k in limits and v <= limits[k] for k, v in numbers.items())


def shot_gaps(shot, width: int, height: int, iterations: int,
              control=None) -> dict:
    """shot_gap and png_px_pct of the checked screenshot (`shot`: the
    frame's G-buffer rows and HDR, the program's denoised image and its
    PNG's bytes, or None where the shot was never taken). With
    `control`, the reference's denoise in that precision and its sRGB
    bytes stand in the program's place."""
    if shot is None:
        return {"shot_gap": math.inf, "png_px_pct": math.inf}
    with torch.no_grad():
        ref = ref_denoise.denoised_screenshot(shot["gb"], shot["hdr"], width,
                                              height, iterations)
        if control:
            with lower.CONTROLS[control]():
                prog = ref_denoise.denoised_screenshot(
                    shot["gb"], shot["hdr"], width, height, iterations)
        else:
            prog = shot["img"]
        ref_d = ref.double()
        gap = float((prog.double().to(ref.device) - ref_d).abs().sum()
                    / ref_d.abs().sum().clamp(min=1e-30))
    ref_u8 = ref_denoise.srgb_u8(ref.cpu().numpy())
    got = ref_denoise.srgb_u8(prog.cpu().numpy()) if control else None
    if not control and shot.get("png") is not None:
        try:
            got = png.read_rgb8(shot["png"])
        except (ValueError, zlib.error):
            got = None
    if got is None or got.shape != ref_u8.shape:
        px = math.inf
    else:
        off = np.abs(got.astype(np.int16) - ref_u8.astype(np.int16)) > 1
        px = 100.0 * float(off.any(axis=-1).mean())
    return _finite({"shot_gap": gap, "png_px_pct": px})



def compare(snaps, desc, device, seq, frames_run: int, traffic: dict,
            fields, last_transforms, control=None):
    """The numbers of the compared frames (`snaps`: each frame's record,
    the state it started from, None for a fresh one, and its outputs)
    and, with `fields` (the program's refit scene after its last frame,
    moved by `last_transforms`), `refit_gap`. With `control` (a name in
    `lower.CONTROLS`), the reference in that precision stands in the
    program's place. Returns (numbers, the reference's counts a frame of
    the window's frames: queries, trace stages; triangles): set-up's
    first frame, which starts from nothing, is not of the window's kind.
    """
    if traffic["tap_batch"]:
        raise ValueError("the reference traces the spatial taps in turn; "
                         "batched taps draw other random numbers")
    w, h = traffic["width"], traffic["height"]
    lights = sum(op[0] in ("quad_light", "sphere_light") for op in desc.ops)
    uniforms = reference_uniforms(seq, frames_run, w / h, lights)
    numbers, queries, stages = {}, [], []
    for snap in snaps:
        rec = snap["record"]
        fc, static_ok, uni = uniforms[rec["index"]]
        if (fc, static_ok) != (rec["frame_count"], rec["static_ok"]):
            raise RuntimeError("the reference's frame counter left the "
                               "program's")
        args = (desc, device, w, h, uni, fc, static_ok, traffic["gb_reuse"],
                snap["input"], rec["transforms"])
        ref, scene = reference_frame(*args)
        prog = reference_frame(*args, control=control)[0] if control \
            else snap["out"]
        for k, v in frame_gaps(prog, ref).items():
            numbers[k] = max(numbers.get(k, 0.0), v)
        if snap["input"] is not None:
            queries.append(ref["rays"])
            stages.append(scene.counts["stages"])
    if fields is not None:
        numbers["refit_gap"] = refit_gap(
            fields, tables.build(desc, device, transforms=last_transforms),
            low=control == "bf16")
    return numbers, {"queries_per_frame": sum(queries) / len(queries),
                     "stages_per_frame": sum(stages) / len(stages),
                     "triangles": scene.world.shape[0]}
