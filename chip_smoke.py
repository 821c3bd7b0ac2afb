#!/usr/bin/env python3
"""Check run of the PyTorch port on one NVIDIA GPU: build every kernel,
then hold each kernel, route and frame to its plain twin on the card.

    python3 chip_smoke.py

It checks and does not time. The port is timed by the benchmark alone:
`python3 -m rtbench --workload <cell> --trace 1` (rtbench/README.md)
names the device operations and stages that take a cell's time.

Phases (each prints what it checked; any failed check raises, so the exit
code is non-zero):
  1. device   - a CUDA device is required; prints its name and power
                limit as nvidia-smi reports them.
  2. build    - builds kernels K1 (closest-hit), K2 (any-hit), K3
                (streamed closest- and any-hit), K4 (instanced closest-
                and any-hit), K5 (the vpu sweep), K6 (the tensor-core
                test), K7 (the table gather of the row fetches), K8 (the
                BVH walk, closest- and any-hit), K9 (the path tracer's
                shading), K10 (the post pass), K11 (ReSTIR's spatial
                reuse) and the stage marks, from
                tpu_raytracer_torch/csrc/{trace,trace_stream,trace_inst,
                trace_vpu,trace_mxu,gather,trace_bvh,marks,path_trace,
                post,spatial}.cu for sm_90a with one nvcc call. Phases 29,
                30 and 31 run next.
  3. K1       - against its plain PyTorch version on the card: Cornell
                512^2 primary rays and 524,288 random rays (random t_max,
                30% dead lanes). tri equal on every lane, t bit-equal.
  4. K2       - against plain closest-hit `tri >= 0` on the same rays,
                t = t_max.
  5. frame    - the Cornell ReSTIR frame at 512^2 through render_frame,
                FRAMES frames (static_ok from the second frame on): K1 and
                K2 launched, K3-K6 and K8 not; ldr finite in [0, 1], hdr
                finite, rays positive.
  6. golden   - 8 frames of the 64^2 Cornell box against
                tests/golden/cornell_64_f8_ldr.npy and 4 frames of the 48^2
                restir scene (100 sphere lights) against
                tests/golden/restir_48_f4_ldr.npy, PSNR >= GOLDEN_DB.
  7. K4       - the instanced gallery at full width (100 icospheres of
                5,120 triangles, 512,004 world triangles) against the
                plain instanced trace: 512^2 primary rays and 524,288
                random rays inside the gallery (random t_max, 30% dead).
                Closest-hit tri and inst equal on every lane, t within
                T_ULPS; any-hit occlusion equal to plain, t = t_max,
                inst set exactly on the occluded lanes.
  8. gallery  - the gallery's ReSTIR frame at 512^2 through render_frame,
                SCENE_FRAMES frames: both K4 entry points launched and
                none of K1, K2 and K3.
  9. K3       - the dense knot (bench.py config 6: 100,804 world
                triangles in 100,864 slots, loaded from the generated .glb
                through the glTF loader) against the plain versions: 512^2
                primary rays and 524,288 random rays in the knot's box
                (random t_max, 30% dead). Closest-hit tri equal on every
                lane and t within T_ULPS against the streamed twin and the
                chunk scan; any-hit occlusion equal, t = t_max.
 10. knot     - the knot's ReSTIR frame at 512^2, SCENE_FRAMES frames:
                both K3 entry points launched and none of K1, K2 and K4.
                Then (10b) its first 2 frames again with
                trace_api.MXUF_MAX_TP raised here only, so K1/K2 take the
                route (K3 not launched): equal to K3's bit for bit.
 11. bunny    - the bunny scene's (config 3, 15,372 triangles) frame at
                512^2, SCENE_FRAMES frames: K1 and K2 launched, neither K3
                nor K4. Then K3 against K1/K2 on the bunny's and Cornell's
                512^2 primary rays and 524,288 random rays: equal on every
                lane.
 12. K5       - the vpu sweep (an instance of csrc/sweep.cuh) against its
                plain version (the worklists of ops/worklist.py) and
                against K1, on Cornell's 512^2 primary rays, 524,288
                random Cornell rays and 524,288 random rays in the bunny
                scene: tri equal on every lane, t bit-equal to K1's and
                within T_ULPS of plain.
 13. K6       - each variant (mxu3, mxu1, mxuw with hulls of 8 chunks,
                the in-kernel cull's closest- and any-hit) on the same
                rays, against its plain version over the kernel's own
                (lane, chunk) set (at most PLAIN_DIFF lanes of a ray set
                differ in hit/miss and at most PLAIN_DIFF in tri;
                relative t error < PLAIN_REL where tri agrees) and
                against K1 within the reference's bf16 tolerance
                (hit/miss and tri agreement > AGREE, median relative t
                error < MEDIAN_REL; mxu1 held to its plain version only).
 14. modes    - with ops/worklist.py's block_entry and worklists made to
                raise: one scene_trace call on the primary rays under
                vpu (closest and any), mxu3, mxu1, mxuw and the cull
                (closest and any) launches exactly one kernel, its own;
                then the Cornell ReSTIR frame at 512^2, MODE_FRAMES
                frames, under vpu (K5 launched; K1-K4 not), mxu3 and mxuw
                (K6 closest-hit and K2; not K1), and the in-kernel cull
                (both K6 entries; not K1 or K2): PSNR against the same
                frame of phase 5, >= VPU_DB under vpu (K5 returns K1's
                hits) and >= GOLDEN_DB otherwise. mxu1 renders no frame
                (the reference calls it broken for rendering).
 15. golden   - the 64^2 Cornell golden under mxu3, PSNR >= GOLDEN_DB.
 16. K7       - the table gather against its plain version on the card,
                bit for bit: Cornell's tri_table and mat_table, the knot's
                tri_table, the gallery's inst_table and the restir scene's
                light_table (100 lights), at GATHER_RAYS random indices
                (the random sets' counts and the app's, config 4's and
                config 5's frames; negative ones and ones past the table
                included).
 17. fetch    - the first 2 Cornell 512^2 frames again with
                hit.fetch_cols set to the plain gather (here only, never
                in the package): K7 not launched, and the images equal to
                phase 5's (a gather is a copy), PSNR >= VPU_DB.
 18. config 1 - bench.py's config-1 sequence: the diffuse Cornell box at
                512^2, PROGRESSIVE_FRAMES render_progressive frames: K1
                and K7 launched, the accumulation finite, non-negative
                and lit.
 19. config 5 - bench.py's config-5 sequence on the Cornell box at
                3840 x 2160 as one frame: frames 0-2, frame 2 denoised
                (denoised_screenshot), frames 3-31 accumulated; the
                denoised frame 2 against the 32-frame accumulation, both
                through resolve_tonemap, must be finite and above the
                un-denoised frame 2's PSNR; the ScreenshotSaver's PNG
                read back.
 20. config 4 - bench.py's config-4 sequence: the Cornell box at 1920 x
                1080, FLY_FRAMES frames; each presses `d` for 1/60 s (the
                accumulation restarts), moves the crystal (instance 6) by
                bench.py's wobble and refits it with
                ops/refit.py:update_instances(changed=(6,)), static_ok
                False. From the second frame on every refit runs under
                torch.cuda.set_sync_debug_mode("error"): no host sync.
                K1, K2, K7, K9 and K10 launched and nothing else. Checks:
                the last refit against a full refit (changed=None) of the
                same transforms within REFIT_ATOL on tri_planes,
                chunk_aabb, tri_table, bvh_rec, inst_transform and
                inst_normal_mat; every box record of bvh_rec contains its
                triangles; K1/K2 on the refit scene's 1920 x 1080 primary
                rays against plain (tri on every lane, t bit-equal;
                occlusion equal); the refit scene's frame with the plain
                fetch within VPU_DB of the same frame through K7; a
                repack=True refit keeps K1's hit/miss
                and t bit for bit, its rows follow the Morton order, and a
                winner that moved is an exact-t tie.
 21. app      - in process, on the app's default scene and camera at
                1280 x 720: K1/K2 on the primary rays against plain (as in
                phase 20), and the first frame with the plain fetch
                within VPU_DB of K7's. Then
                `python -m tpu_raytracer_torch --scale=1280x720
                --max-frames 12 --no-preview --target-spp 8 --checkpoint
                <tmp> --out-dir <tmp>` as a subprocess, stdin not a tty
                (its frames replayed CUDA graphs that reuse the G-buffer
                on static frames, render/graph.py):
                exit code 0, one PNG read back through utils/png.py, the
                checkpoint's frame_count 12, K1, K2, K7, K9 and K10
                launched, its telemetry with fps; then 2 more frames
                resumed from the checkpoint, starting at frame 12.
 22. stand-ins - the procedural glTF stand-ins at their generators'
                defaults (avocado, helmet, vrm, truffle), each built through
                interactive.load_scene (the .glb generated if missing, its
                textures Lanczos-resized, the tables built), its triangle
                count asserted (and the truffle's three sphere lights), so
                a load that fell back to the floor scene fails; K1/K2 on
                its 512^2 primary rays against plain (as in phase 21);
                then SCENE_FRAMES ReSTIR frames at 512^2: K1, K2 and K7
                launched and none of K3-K6, every frame finite and none
                black (max LDR > 0.01). Then `python -m
                tpu_raytracer_torch --scene truffle --scale=1280x720
                --max-frames 4 --no-preview` as a subprocess: exit code 0,
                K1, K2 and K7 in its launches.
 23. walk     - the BVH walk K8 (the route past a scene's brute_max
                triangle slots). The big scene, built
                (bigscene.big_scene) as scripts/ucb_bigscene.py
                builds its own: the floor, the
                quad light and two create_sphere(8) bodies at x = +-0.3,
                2,621,444 triangles, past the 2M cap, routed to the walk.
                K8 closest- and any-hit against the plain walk
                (traversal.trace_plain) on ucb_bigscene.py's 262,144
                incoherent and 262,144 coherent rays: tri equal on every
                lane, t bit-equal. The big scene's ReSTIR frame at 512^2,
                SCENE_FRAMES frames: K8 and K7 launched and no other trace
                kernel, no frame black. Then the Cornell box built with
                brute_max=1: K8 against the plain walk on its 512^2
                primary rays and 262,144 random rays (30% dead), and its
                first 2 frames (K8, no K1/K2) against phase 5's, PSNR >=
                VPU_DB (the same hits but exact-t ties).
 24. tiles    - the frame over row bands (parallel/tiles.py):
                bench.py:headline_tiled's sequence (the Cornell box at
                512^2, FRAMES frames, cam.uniform(1.0, i, 2), static_ok
                from the second frame) over 4 bands of 128 rows on this
                card (make_mesh(["cuda:0"] * 4)), and over 4 cards where
                the host has them. The last LDR against the one-device
                frame of the same sequence, max abs <= 1e-5 (the
                reference's bound, tests/test_tiles.py:49), rays within
                1e-3 a frame; then 4 frames with the camera moved at frame
                2, held the same way. K1, K2 and K7 launched in every band
                and no other trace kernel, the bands' launches summing to
                the run's.
 25. graph    - the frame as CUDA graphs (render/graph.py:FrameGraph,
                render_frame and render_progressive captured with their
                state updated in place): phase 24's headline sequence and
                its moving camera through the graph and eagerly in
                lockstep, ldr, hdr, every state tensor and rays bit-equal
                on every frame; eager frames 1 and 2 (static, and with
                the G-buffer reused) under set_sync_debug_mode("error");
                the headline sequence eager and then replayed: launches
                (a replay counts its capture's) and rays equal, K9's
                launches 2 x K9_CALL a frame; the graph with gb_reuse
                against eager frames without it (within
                GRAPH_REUSE_ATOL, rays exactly W x H fewer after the
                first); config 1's PROGRESSIVE_FRAMES frames bit-equal;
                and GRAPH_ROUTE_FRAMES frames each of the knot (K3), the
                gallery (K4), Cornell under vpu (K5) and mxu3 (K6) and
                Cornell with brute_max=1 (K8), bit-equal, each route's
                kernels launched in the replay and no other.
 26. graphs II - config 4 and the row bands replayed. Config 4's
                FLY_FRAMES frames through
                FrameGraph(refit_changed=(CRYSTAL,)) (the refit written in
                place, ops/refit.py:update_instances_, and the frame in
                one replay) in lockstep with update_instances +
                render_frame: ldr, hdr, every state tensor, rays and the
                scene's refit fields bit-equal on every frame, replays
                after the first under set_sync_debug_mode("error"), the
                caller's scene unwritten; eager and replayed launches and
                rays equal, and at most GRAPH_FLY_LAUNCHES host launches
                a replayed frame under torch.profiler. Then phase 24's
                headline sequence and moving camera through
                parallel/tiles.py:TiledFrameGraph over 4 bands of this card
                (and of 4 cards where the host has them) in lockstep with
                the eager bands and the one-device frames, every word
                equal; each band's launches its eager band's (K1, K2 and
                K7, no other trace kernel); under torch.profiler, graph
                launches a replayed frame = bands x segments and other
                launches at most GRAPH_TILE_OTHER; on 4 cards also
                `python -m tpu_raytracer_torch --tiles 4` (its frames
                replayed band graphs): exit 0, K1, K2 and K7 launched.
 27. tap batch - batched spatial-tap visibility (ops/restir.py,
                `tap_batch`: the five taps' shadow rays as one any-hit call
                over a pixel-interleaved stream of 5R rays,
                `_tap_stream`). The Cornell box at 512^2, TAP_FRAMES
                frames through FrameGraph(tap_batch=True) in lockstep with
                render_frame(tap_batch=True), every word equal, an eager
                batched frame under set_sync_debug_mode("error"); then
                batched replayed, sequential replayed and batched eager:
                K1, K2 and K7 launched and no other trace kernel, K2 4
                launches fewer a frame batched, replayed launches equal to
                eager, and at most 2 host launches a replayed batched
                frame under torch.profiler. The stream `_tap_stream` made
                in one eager frame (spied, not rebuilt) through K2 against
                plain closest-hit tri>=0, on every lane, t = t_max; the
                knot's and the gallery's streams through K3's and K4's any
                hit against their plain versions. TAP_BAND_FRAMES frames
                of TiledFrameGraph(tap_batch=True) over 4 bands of this
                card against the one-device batched frames, every word
                equal. Then the Cornell box built with subdivide_max_diag=
                SUBDIV_DIAG: more triangles and chunks than the unsplit
                box's, K1 (tri equal, t bit-equal) and K2 against plain on
                its 512^2 primary rays, SUBDIV_FRAMES replayed frames (K1,
                K2 and K7 only).
 28. reorder  - the ray-stream reorder (ops/compaction.py): the Cornell
                box at 512^2 through render_band with
                restir.make_ctx(reorder=m) for m in REORDER_MODES,
                REORDER_FRAMES eager frames a mode (K1/K2/K7 launched, no
                other trace kernel), every word of "live" and "bins" equal
                to "none"; one frame a mode under `vpu` (K5) and on the
                knot (K3), every word equal; under `mxu3` (K6) its
                launches (K6 may differ from "none" in a few lanes). The
                streams one Cornell frame hands its queries (spied at
                trace_api._route): the temporal path's closest-hit calls
                1, 4 and 7 (of 7), its last depth's any-hit and the first
                spatial tap's; on each, a mode's
                permuted stream through K1 (or K2), K5 and K6 (mxu3,
                closest streams), each restored result against "none"
                (K1/K2/K5 every word equal, K6 at most 2 x PLAIN_DIFF
                words differing). One render_band call with a "bins" ctx
                captured in a CUDA graph under
                set_sync_debug_mode("error"), its replay every word equal
                to the eager frame.
 29. K9       - run right after the build: the path tracer's shading
                (csrc/path_trace.cu) against the eager route: both
                trace_path calls (the temporal candidates and the spatial
                replay) of the second of two eager ReSTIR frames of the
                Cornell box and of the knot at PATH_SIZES, spied, each
                through trace_path_kernel and trace_path_plain on the same
                CUDA inputs: state and valid_v1 equal on every lane, rays
                equal, radiance, v1_pos and v1_normal bit-equal on every
                lane; MAX_DEPTH queries a call; one call under
                torch.profiler holds K9_CALL's launches (a session that
                drops events fails here) and only K9, the trace kernels
                and the stage mark; K9 launches a frame (2 prime, 14
                bounce, 2 finish).
 30. K10      - run after phase 29: the post pass (csrc/post.cu) against
                the eager route (post_process_plain on the card) on live
                post_process arguments of a Cornell and a truffle
                1280x720 still frame, a Cornell 1920x1080 frame under a
                moving camera (its counter 0, and 5 for the clipped-history
                branch) and every band of a 4-band split (halo 16) of the
                still and the moving frame: every ldr and accum word
                equal, one "post" launch a call; the still frame's bands
                together equal to its one-device call; one call under
                torch.profiler holds K10 alone; "post" launches a replayed
                frame, 1 on one device and 4 on 4 bands.
 31. K11      - run after phase 30: ReSTIR's spatial reuse
                (csrc/spatial.cu) against the eager route
                (restir_spatial_plain on the card) on live restir_spatial
                arguments of a Cornell and a truffle 1280x720 still frame,
                a Cornell 1920x1080 frame under a moving camera (its
                counter 0, and 5) and every band of a 4-band split (halo
                16) of the Cornell still frame: every word of the output
                reservoirs, hdr, rays and diag equal, K11_CALL's launches a
                call; the bands together equal to the one-device call; a
                call's device trace holds K11_CALL, the trace kernels, K9,
                the stage marks and at most SPATIAL_EAGER other operations
                (the any-hit calls' fills, mask and compare); K11 launches a
                replayed frame, K11_CALL on one device and 4 x K11_CALL on
                4 bands.
Every ReSTIR frame phase but the goldens' (5, 8, 10, 11, 14, 20-28) also
checks that K7, K9, K10 and K11 launched (the batched taps' frames of 27
that K11 did not); the goldens and configs 1 and 5 check K7. Last it prints the device line {"ok": true, "device": {...}}.
Without a CUDA device it exits with 1 and prints no result.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

T_ULPS = 2          # K1/K4 t against plain; measured 0 on the CPU twins
GOLDEN_DB = 38.0
FRAMES = 10         # the Cornell sequence, bench.py:headline's 2 + 8
# the gallery's, knot's, bunny's, stand-ins' and big scene's frames
SCENE_FRAMES = 6
KNOT_TRIANGLES = 100804   # 420 x 120 x 2 knot + floor + light quads
WIDTH = HEIGHT = 512
RANDOM_RAYS = 524288
DEVICE = "cuda:0"
MODE_FRAMES = 6     # the Cornell frames under a mode
VPU_DB = 60.0       # vpu against the default frame (K5 returns K1's hits)
# K6 against K1: the reference's tolerance for its bf16 modes
# (tests/test_mxu_kernel.py:40-52)
AGREE, MEDIAN_REL = 0.999, 1e-4
# K6 against its plain version, per ray set: lanes that may differ in
# hit/miss and (separately) in tri, and the max relative t error where tri
# agrees; measured 0, 0 and 5.94e-5 on the card (PERF.md, PR 4)
PLAIN_DIFF, PLAIN_REL = 8, 1e-4
# K6's variants: (name, grp (None: the in-kernel cull's 2 or 4), passes,
# in-kernel cull)
MXU_VARIANTS = (("mxu3", 1, 3, False), ("mxu1", 1, 1, False),
                ("mxuw8", 8, 3, False), ("incull", None, 3, True))
PROGRESSIVE_FRAMES = 34    # config 1 (bench.py:151-172)
SHOT_W, SHOT_H, SHOT_FRAMES = 3840, 2160, 32   # config 5 (bench.py:207-279)
# config 4 (bench.py:187-206): the 1080p fly-through, the crystal
# (instance 6) refit every frame
FLY_W, FLY_H, FLY_FRAMES, CRYSTAL = 1920, 1080, 8, 6
# the changed-instance refit against the full one; the same bound holds
# the port's refit tables to the reference's (tests/test_torch_refit.py)
REFIT_ATOL = 1e-6
# the app (phase 21): the reference app's default size (src/main.rs:122)
APP_W, APP_H, APP_FRAMES, APP_SPP, APP_RESUME = 1280, 720, 12, 8, 2
# the procedural glTF stand-ins (phase 22): the app's scene name and the
# scene's world triangles at the generators' defaults (the asset's, plus
# the floor and light quads; the truffle: the floor and three sphere
# lights of 5,120 triangles)
STANDINS = (("avocado", 12268), ("helmet", 23364), ("vrm", 11908),
            ("truffle", 23258))
STANDIN_APP_FRAMES = 4
# the BVH walk (phase 23): two create_sphere(8) bodies past the cap, and
# scripts/ucb_bigscene.py's ray sets
BIG_SUBDIV, BIG_TRIANGLES = 8, 2 * 1310720 + 4
WALK_RAYS = 262144
# row bands (phase 24): bench.py:headline_tiled's sequence (Cornell 512^2,
# FRAMES frames, cam.uniform(1.0, i, 2)) over 4 bands of 128 rows, the
# reference's bound against the one-device frame (tests/test_tiles.py:49),
# and test_tiled_matches_single_chip_with_motion's 4 frames (moved at 2)
TILE_BANDS, TILE_LDR_ATOL, TILE_RAYS_ATOL = 4, 1e-5, 1e-3
TILE_MOTION_FRAMES, TILE_MOVE_AT = 4, 2
# K7's index counts: the random sets, the app's, config 4's and config 5's
# frames
GATHER_RAYS = (262144, 524288, APP_W * APP_H, FLY_W * FLY_H, 3840 * 2160)
# the frame as CUDA graphs (phase 25): G-buffer reuse against the traced
# G-buffer within the reference test's bound (tests/test_dedup.py:49-69);
# 2 frames of each other route
GRAPH_REUSE_ATOL = 2e-5
GRAPH_ROUTE_FRAMES = 2
# config 4 and the row bands replayed (phase 26): host launches a
# replayed config-4 frame (the graph and its input copies), and a
# replayed tiled frame's launches besides its bands x segments graphs
# (frame_count a band and the gather of ldr, hdr and aux)
GRAPH_FLY_LAUNCHES, GRAPH_TILE_OTHER = 20, 4 * TILE_BANDS + 8
# batched spatial taps (phase 27): the Cornell frames eager and replayed,
# the 4-band frames, and the subdivided Cornell box's cut
# (subdivide_max_diag) and frames
TAP_FRAMES, TAP_BAND_FRAMES = 8, 2
SUBDIV_DIAG, SUBDIV_FRAMES = 0.1, 6
# the ray-stream reorder (phase 28): the modes of make_ctx(reorder=), the
# eager Cornell frames a mode, and the streams of one frame's queries:
# (label, index in the frame's order of queries: 0 the G-buffer, 1-7 the
# temporal path's closest hits, 8 its last depth's any hit, 9-13 the
# spatial taps')
REORDER_MODES = ("none", "live", "bins")
REORDER_FRAMES = 4
REORDER_STREAMS = (("closest 1", 1), ("closest 4", 4), ("closest 7", 7),
                   ("any, last depth", 8), ("tap 1", 9))


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _random_rays(torch, n, device, seed=0, lo=-0.95, hi=0.95, y=None,
                 t_far=3.0):
    """Origins uniform in [lo, hi]^3 (lo and hi scalars, or [3, 1] arrays
    for a box; y in `y` if given), unit directions, t_max uniform in
    (0.01, t_far), 30% dead lanes (t_max = 0)."""
    g = np.random.default_rng(seed)
    o = g.uniform(lo, hi, (3, n)).astype(np.float32)
    if y is not None:
        o[1] = g.uniform(*y, n)
    d = g.standard_normal((3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    t_max = g.uniform(0.01, t_far, n).astype(np.float32)
    t_max[g.uniform(size=n) < 0.3] = 0.0            # dead lanes
    return tuple(torch.from_numpy(x).to(device) for x in (o, d, t_max))


def _ulps(a, b):
    return (a.view(np.int32).astype(np.int64)
            - b.view(np.int32).astype(np.int64))


def _device_ops(torch, fn):
    """{name: count} of the operations the card ran in one call of fn,
    under torch.profiler: the session runs fn once as its warm-up step,
    whose events it drops, and records the second call alone. A session's
    first call can lose its first kernel's event; the warm-up step takes
    that loss. It records the device's activity alone: with the host's
    too, a process's second such session has recorded no device work."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    cuda = torch.autograd.DeviceType.CUDA
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)}


def _host_launches(torch, render, seq):
    """(launches of device work, of them graph launches) the host makes
    a frame in seq[1:], each render(*its inputs), under torch.profiler,
    after seq[0] unprofiled."""
    render(*seq[0])
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for inputs in seq[1:]:
            render(*inputs)
        torch.cuda.synchronize()
    avgs = prof.key_averages()

    def count(*keys):
        return sum(e.count for e in avgs if e.key in keys) / (len(seq) - 1)
    return (count("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                  "cudaGraphLaunch"), count("cudaGraphLaunch"))


def _run_frames(torch, scene, dev, frames, name, on, off):
    """The main path: `frames` ReSTIR frames of `scene` at WIDTH x HEIGHT
    through render_frame (static_ok from the second frame on), with the
    launch counts set to 0 just before. Checks the output and that the
    kernels `on`, K7 (every frame's row fetches), K9 and K10 launched and
    those `off` did not. Returns every frame's ldr."""
    from tpu_raytracer_torch.ops import trace_api
    from tpu_raytracer_torch.render import camera, pipeline, renderer

    cam = camera.CameraController()
    state = pipeline.init_state(WIDTH, HEIGHT, dev)
    trace_api.reset_launch_counts()
    rays, ldrs = [], []
    for i in range(frames):
        uniform = renderer.camera_to_device(
            cam.uniform(WIDTH / HEIGHT, i, scene.num_lights), dev)
        ldr, hdr, state, aux = pipeline.render_frame(
            scene, uniform, i, state, WIDTH, HEIGHT, static_ok=i > 0)
        ldrs.append(ldr)
        rays.append(aux["rays"])
    launches = dict(trace_api.LAUNCHES)
    on = [*on, "table_gather", *FRAME_SHADE]
    if min(launches[k] for k in on) <= 0 or any(launches[k] for k in off):
        raise AssertionError(f"the {name} frame must launch {on} and none "
                             f"of {off}: {launches}")
    if not (torch.isfinite(ldr).all() and ldr.min() >= 0
            and ldr.max() <= 1):
        raise AssertionError(f"{name} ldr is not finite in [0, 1]")
    if not torch.isfinite(hdr).all():
        raise AssertionError(f"{name} hdr is not finite")
    if min(float(r) for r in rays) <= 0:
        raise AssertionError(f"{name} aux['rays'] is not positive")
    return ldrs


def _psnr(a, b):
    """PSNR in dB of two images in [0, 1]; inf when they are equal."""
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return float("inf") if mse <= 0 else 10.0 * np.log10(1.0 / mse)


def _golden_psnr(torch, scene, dev, size, frames, path):
    """PSNR of `frames` frames at size^2 against the golden LDR image;
    raises unless K7 launched and the PSNR is at least GOLDEN_DB."""
    from tpu_raytracer_torch.ops import trace_api
    from tpu_raytracer_torch.render import camera, pipeline, renderer

    golden = np.load(path).astype(np.float32)
    cam = camera.CameraController()
    state = pipeline.init_state(size, size, dev)
    trace_api.reset_launch_counts()
    for f in range(frames):
        u = renderer.camera_to_device(cam.uniform(1.0, f, scene.num_lights),
                                      dev)
        ldr, _, state, _ = pipeline.render_frame(scene, u, f, state, size,
                                                 size)
    psnr = _psnr(ldr.cpu().numpy(), golden)
    launches = dict(trace_api.LAUNCHES)
    if launches["table_gather"] <= 0:
        raise AssertionError(f"golden {os.path.basename(path)}: K7 did not "
                             f"launch: {launches}")
    if not psnr >= GOLDEN_DB:
        raise AssertionError(f"golden {os.path.basename(path)}: PSNR "
                             f"{psnr:.2f} dB < {GOLDEN_DB}")
    return psnr


def _check_closest(name, got, want, hit_keys=("tri",)):
    """Raise unless `got` has `want`'s hit keys on every lane and t within
    T_ULPS; returns the largest t difference in ulps."""
    for key in hit_keys:
        bad = int((got[key] != want[key]).sum())
        if bad:
            raise AssertionError(f"{name}: {key} differs on {bad} lanes")
    g_t, w_t = got["t"].cpu().numpy(), want["t"].cpu().numpy()
    ulps = int(np.abs(_ulps(g_t, w_t)).max())
    if ulps > T_ULPS:
        raise AssertionError(f"{name}: t differs by {ulps} ulps")
    return ulps


def _compare(got, want):
    """Agreement of two closest-hit answers: hit/miss agreement, tri
    agreement where both hit, the median and max relative t error and max
    |dt| where tri agrees, and on the lanes that disagree their count and
    the largest relative t margin between the two answers."""
    g_tri, w_tri = got["tri"].cpu().numpy(), want["tri"].cpu().numpy()
    g_t, w_t = (x["t"].cpu().numpy().astype(np.float64) for x in (got, want))
    g_hit, w_hit = g_tri >= 0, w_tri >= 0
    both = g_hit & w_hit
    same = both & (g_tri == w_tri)
    flip = both & (g_tri != w_tri)
    scale = np.maximum(np.abs(w_t), 1e-6)
    rel = np.abs(g_t - w_t) / scale
    return {"hit": float((g_hit == w_hit).mean()),
            "tri": float(same.sum() / max(both.sum(), 1)),
            "median": float(np.median(rel[same])) if same.any() else 0.0,
            "max": float(rel[same].max(initial=0)),
            "abs": float(np.abs(g_t - w_t)[same].max(initial=0)),
            "hit_diff": int((g_hit != w_hit).sum()),
            "tri_diff": int(flip.sum()),
            "margin": float(rel[flip].max(initial=0))}


def _check_agree(name, cmp, any_hit):
    """Raise unless `cmp` (from _compare) meets the bf16 tolerance."""
    if not (cmp["hit"] > AGREE and (any_hit or (
            cmp["tri"] > AGREE and cmp["median"] < MEDIAN_REL))):
        raise AssertionError(f"{name}: outside tolerance: {cmp}")


def _check_plain(name, cmp, any_hit):
    """Raise unless `cmp` (from _compare, K6 against its plain version)
    is within PLAIN_DIFF lanes and PLAIN_REL."""
    if not (cmp["hit_diff"] <= PLAIN_DIFF and (any_hit or (
            cmp["tri_diff"] <= PLAIN_DIFF and cmp["max"] < PLAIN_REL))):
        raise AssertionError(f"{name}: outside tolerance: {cmp}")


def _gather_phase(torch, dev, tables, sizes):
    """Phase 16: K7 on each (name, [M, C] table) at each index count in
    `sizes`, against its plain version bit for bit."""
    from tpu_raytracer_torch.ops import table_gather

    gen = torch.Generator(device=dev).manual_seed(5)
    for tname, table in tables:
        m, c = table.shape
        for n in sizes:
            # random rows, an eighth of them past either end of the table
            idx = torch.randint(-(m // 8) - 1, m + m // 8 + 1, (n,),
                                dtype=torch.int32, device=dev, generator=gen)
            got = table_gather.table_gather_kernel(table, idx)
            want = table_gather.table_gather_plain(table, idx)
            torch.cuda.synchronize()
            bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            if bad:
                raise AssertionError(f"K7 {tname} at {n} rows: {bad} words "
                                     f"differ from plain")
        print(f"K7: {tname} [{m}, {c}] at {', '.join(map(str, sizes))} "
              f"random rows: equal to plain bit for bit", flush=True)


def _first_frames(scene, dev, n):
    """The first n ReSTIR frames of `scene` at WIDTH x HEIGHT, as the frame
    phases render them, with the launch counts set to 0 just before.
    Returns (the ldrs on the CPU, the launches)."""
    from tpu_raytracer_torch.ops import trace_api
    from tpu_raytracer_torch.render import camera, pipeline, renderer

    cam = camera.CameraController()
    state = pipeline.init_state(WIDTH, HEIGHT, dev)
    trace_api.reset_launch_counts()
    ldrs = []
    for i in range(n):
        uniform = renderer.camera_to_device(
            cam.uniform(WIDTH / HEIGHT, i, scene.num_lights), dev)
        ldr, _, state, _ = pipeline.render_frame(
            scene, uniform, i, state, WIDTH, HEIGHT, static_ok=i > 0)
        ldrs.append(ldr.cpu())
    return ldrs, dict(trace_api.LAUNCHES)


def _swept_knot_phase(scene, dev, want_ldrs):
    """Phase 10b: the knot's first len(want_ldrs) frames with
    trace_api.MXUF_MAX_TP raised here only, so K1/K2 take the route K3
    takes, against the same frames through K3 (`want_ldrs`): both are
    exact, so the images must be equal bit for bit."""
    from tpu_raytracer_torch.ops import trace_api

    saved = trace_api.MXUF_MAX_TP
    trace_api.MXUF_MAX_TP = scene.tri_planes.shape[2]
    try:
        ldrs, launches = _first_frames(scene, dev, len(want_ldrs))
    finally:
        trace_api.MXUF_MAX_TP = saved
    if (not (launches["closest_hit"] and launches["any_hit"])
            or launches["stream_closest_hit"] or launches["stream_any_hit"]):
        raise AssertionError(f"the knot frames with MXUF_MAX_TP raised must "
                             f"launch K1 and K2 and not K3: {launches}")
    bad = sum(int((a != b).sum()) for a, b in zip(ldrs, want_ldrs))
    if bad:
        raise AssertionError(f"the knot frames through K1/K2 differ from "
                             f"those through K3 in {bad} values")
    print(f"knot route: the first {len(ldrs)} knot {WIDTH}x{HEIGHT} frames "
          f"through K1/K2 (MXUF_MAX_TP raised) equal those through K3 bit "
          f"for bit", flush=True)


def _fetch_phase(torch, scene, dev, want_ldrs):
    """Phase 17: the first len(want_ldrs) ReSTIR frames of `scene` at
    WIDTH x HEIGHT with hit.fetch_cols set to the plain gather, against
    the same frames rendered through K7 (`want_ldrs`, on the CPU)."""
    from tpu_raytracer_torch.ops import hit, table_gather

    saved = hit.fetch_cols
    hit.fetch_cols = lambda table, idx: list(
        table_gather.table_gather_plain(table, idx).unbind(0))
    try:
        ldrs, launches = _first_frames(scene, dev, len(want_ldrs))
    finally:
        hit.fetch_cols = saved
    if launches["table_gather"] or not launches["closest_hit"]:
        raise AssertionError(f"the plain-fetch frames must launch K1 and not "
                             f"K7: {launches}")
    psnr = min(_psnr(a.numpy(), b.numpy()) for a, b in zip(ldrs, want_ldrs))
    if not psnr >= VPU_DB:
        raise AssertionError(f"plain-fetch frames: PSNR {psnr:.2f} dB "
                             f"against K7's < {VPU_DB}")
    print(f"fetch: the first {len(ldrs)} Cornell {WIDTH}x{HEIGHT} frames "
          f"with the plain gather (K7 not launched) against the same frames "
          f"through K7: PSNR {psnr:.2f} dB (floor {VPU_DB})", flush=True)


def _progressive_phase(torch, dev, width, height, frames):
    """Phase 18, bench.py's config 1: `frames` render_progressive frames
    of the diffuse Cornell box."""
    from tpu_raytracer_torch.models import scenes
    from tpu_raytracer_torch.ops import trace_api
    from tpu_raytracer_torch.render import camera, renderer

    scene = scenes.create_cornell_box_diffuse(dev)
    cam = camera.CameraController()
    accum = renderer.make_accum(width, height, dev)
    trace_api.reset_launch_counts()
    for f in range(frames):
        uniform = renderer.camera_to_device(
            cam.uniform(1.0, f, scene.num_lights), dev)
        accum, rad = renderer.render_progressive(scene, uniform, f, accum,
                                                 width, height)
    launches = dict(trace_api.LAUNCHES)
    if not (launches["closest_hit"] > 0 and launches["table_gather"] > 0):
        raise AssertionError(f"config 1 must launch K1 and K7: {launches}")
    if not (torch.isfinite(accum).all() and accum.min() >= 0
            and accum.max() > 0 and torch.isfinite(rad).all()):
        raise AssertionError("config 1: accum is not finite, non-negative "
                             "and lit")
    print(f"config 1: diffuse Cornell ({scene.num_triangles} triangles) "
          f"{width}x{height}, {frames} render_progressive frames: K1 and K7 "
          f"launched, the accumulation finite, non-negative and lit",
          flush=True)


def _screenshot_phase(torch, scene, dev, width, height, frames):
    """Phase 19, bench.py's config 5 at width x height as one frame:
    frames 0-2, frame 2 denoised, then frames 3 to frames - 1
    accumulated. The denoised frame 2 must beat the un-denoised one
    against the accumulation; its PNG must read back."""
    from tpu_raytracer_torch.app.screenshot import (ScreenshotSaver,
                                                    denoised_screenshot)
    from tpu_raytracer_torch.ops import trace_api
    from tpu_raytracer_torch.ops.post import resolve_tonemap
    from tpu_raytracer_torch.render import camera, pipeline, renderer
    from tpu_raytracer_torch.utils import png

    cam = camera.CameraController()

    def frame(f, st):
        uniform = renderer.camera_to_device(
            cam.uniform(width / height, f, scene.num_lights), dev)
        return pipeline.render_frame(scene, uniform, f, st, width, height,
                                     static_ok=f > 0)

    state = pipeline.init_state(width, height, dev)
    trace_api.reset_launch_counts()
    for f in range(3):
        _, hdr, state, _ = frame(f, state)
    den = denoised_screenshot(state["gb"], hdr, width, height)
    den_tm = resolve_tonemap(den).cpu().numpy()
    raw_tm = resolve_tonemap(hdr.reshape(height, width, 3)).cpu().numpy()
    den_img = den.cpu().numpy()
    del den
    for f in range(3, frames):
        _, hdr, state, _ = frame(f, state)
    launches = dict(trace_api.LAUNCHES)
    ref_tm = resolve_tonemap(state["accum"].reshape(height, width, 3))
    ref_tm = ref_tm.cpu().numpy()
    del state, hdr
    if not (launches["closest_hit"] > 0 and launches["table_gather"] > 0):
        raise AssertionError(f"config 5 must launch K1 and K7: {launches}")
    if not (np.isfinite(den_img).all()
            and den_img.shape == (height, width, 3)):
        raise AssertionError(f"config 5: the denoised image is not finite "
                             f"[{height}, {width}, 3]")
    den_psnr, raw_psnr = _psnr(den_tm, ref_tm), _psnr(raw_tm, ref_tm)
    if not (np.isfinite(den_psnr) and den_psnr > raw_psnr):
        raise AssertionError(f"config 5: denoised PSNR {den_psnr:.4f} dB is "
                             f"not finite and above the frame's "
                             f"{raw_psnr:.4f} dB")
    with tempfile.TemporaryDirectory() as tmp:
        saver = ScreenshotSaver(tmp)
        if not saver.submit(den_img, label="config5"):
            raise AssertionError("config 5: the screenshot queue is full")
        saver.flush(timeout=300.0)
        (name,) = os.listdir(tmp)
        with open(os.path.join(tmp, name), "rb") as fh:
            png_shape = png.decode(fh.read()).shape
    if png_shape != (height, width, 4):
        raise AssertionError(f"config 5: the screenshot PNG decodes to "
                             f"{png_shape}")
    print(f"config 5: Cornell {width}x{height} as one frame, {frames} "
          f"frames: the denoised frame 2 at {den_psnr:.4f} dB of the "
          f"accumulation, above the frame without the denoise "
          f"({raw_psnr:.4f} dB); PNG {png_shape} read back", flush=True)


def _check_primary(torch, scene, uniform, width, height, what):
    """Raise unless K1 and K2 on `scene`'s width x height primary rays
    equal their plain versions (tri on every lane and t bit for bit; K2's
    occlusion equal and its t t_max). Returns the rays (o, d as [3, n]
    tensors, po, pd as V3s, t_min, t_max)."""
    from tpu_raytracer_torch.ops import gbuffer, trace_api

    po, pd = gbuffer.generate_primary_rays(uniform, width, height)
    o, d = (torch.stack(list(x)).contiguous() for x in (po, pd))
    n = o.shape[1]
    t_min = torch.full((n,), gbuffer.T_MIN, device=o.device)
    t_max = torch.full((n,), gbuffer.T_MAX, device=o.device)
    got, got_a = (trace_api.trace_kernel(scene.tri_planes, scene.chunk_aabb,
                                         o, d, t_min, t_max, any_hit=a)
                  for a in (False, True))
    want = trace_api.trace_plain(scene.tri_planes, scene.chunk_aabb, po, pd,
                                 t_min, t_max)
    torch.cuda.synchronize()
    if not torch.equal(got["tri"], want["tri"]):
        raise AssertionError(f"{what}: K1's tri differs from plain on "
                             f"{int((got['tri'] != want['tri']).sum())} "
                             f"lanes")
    if not torch.equal(got["t"].view(torch.int32),
                       want["t"].view(torch.int32)):
        raise AssertionError(f"{what}: K1's t is not bit-equal to plain")
    if not (torch.equal(got_a["tri"] >= 0, want["tri"] >= 0)
            and torch.equal(got_a["t"], t_max)):
        raise AssertionError(f"{what}: K2's occlusion differs from plain "
                             f"or its t is not t_max")
    return o, d, po, pd, t_min, t_max


def _check_fetch(torch, scene, uniform, width, height, what):
    """Raise unless one ReSTIR frame of `scene` at width x height from a
    fresh state (frame 0, static_ok False) with hit.fetch_cols set to the
    plain gather is within VPU_DB of the same frame through K7, as phase
    17 holds them. Returns the PSNR."""
    from tpu_raytracer_torch.ops import hit, table_gather, trace_api
    from tpu_raytracer_torch.render import pipeline

    def frame():
        trace_api.reset_launch_counts()
        state = pipeline.init_state(width, height, scene.tri_planes.device)
        ldr = pipeline.render_frame(scene, uniform, 0, state, width, height,
                                    static_ok=False)[0]
        return ldr.cpu().numpy(), trace_api.LAUNCHES["table_gather"]

    want, k7_launched = frame()
    saved = hit.fetch_cols
    hit.fetch_cols = lambda table, idx: list(
        table_gather.table_gather_plain(table, idx).unbind(0))
    try:
        got, plain_launched = frame()
    finally:
        hit.fetch_cols = saved
    if not k7_launched or plain_launched:
        raise AssertionError(f"{what}: the K7 frame must launch K7 and the "
                             f"plain-fetch frame not: {k7_launched}, "
                             f"{plain_launched}")
    psnr = _psnr(got, want)
    if not psnr >= VPU_DB:
        raise AssertionError(f"{what}: the plain-fetch frame is at PSNR "
                             f"{psnr:.2f} dB of K7's, < {VPU_DB}")
    return psnr


def _boxes_contain(torch, scene):
    """Raise unless every box record of scene.bvh_rec contains each
    triangle record of its subtree (records box+1 .. skip-1), exactly.
    Returns the number of (box, triangle) pairs checked."""
    rec, skip = scene.bvh_rec, scene.bvh_skip
    boxes = torch.nonzero(skip >= 0).squeeze(1)
    tris = torch.nonzero(skip < 0).squeeze(1)
    v0 = rec[tris, 0:3]
    v1, v2 = v0 + rec[tris, 3:6], v0 + rec[tris, 6:9]
    t_mn = torch.minimum(torch.minimum(v0, v1), v2)
    t_mx = torch.maximum(torch.maximum(v0, v1), v2)
    inside = ((tris[None, :] > boxes[:, None])
              & (tris[None, :] < skip[boxes][:, None]))
    ok = ((rec[boxes, None, 0:3] <= t_mn[None]).all(-1)
          & (t_mx[None] <= rec[boxes, None, 3:6]).all(-1))
    bad = int((inside & ~ok).sum())
    if bad:
        raise AssertionError(f"config 4: {bad} (box, triangle) pairs of the "
                             f"refit BVH are not contained")
    return int(inside.sum())


def _wobble(torch, base, i, dev):
    """bench.py:194-199: every instance's transform at config 4's frame
    i, the crystal moved; uploaded here, before the refit runs."""
    from tpu_raytracer_torch.utils.math3d import (rotation_y, scale,
                                                  translation)

    tf = base.copy()
    tf[CRYSTAL] = (translation([0.4, -0.5 + 0.02 * (i % 8), 0.3])
                   @ rotation_y(0.1 * i) @ scale(0.5))[:3, :4]
    return torch.as_tensor(tf, dtype=torch.float32, device=dev)


def _flythrough_phase(torch, dev):
    """Phase 20, bench.py's config 4: the Cornell box at FLY_W x FLY_H,
    FLY_FRAMES frames; each frame presses `d` for 1/60 s (the
    accumulation restarts), moves the crystal by bench.py's wobble and
    refits with changed=(CRYSTAL,), then renders with static_ok False.
    From the second frame on every update_instances call runs under
    torch.cuda.set_sync_debug_mode("error"). Then the checks: the last
    refit against a full refit of the same transforms, K1/K2 on the
    refit scene against plain, the refit boxes, and a repack."""
    from tpu_raytracer_torch.models import scenes
    from tpu_raytracer_torch.ops import lbvh, refit, trace_api
    from tpu_raytracer_torch.render import camera, pipeline, renderer
    from tpu_raytracer_torch.utils.vec3 import V3

    scene0 = scene = scenes.create_cornell_box(dev)
    base = scene.inst_transform.cpu().numpy()

    def wobble(i):
        return _wobble(torch, base, i, dev)

    cam = camera.CameraController()
    state = pipeline.init_state(FLY_W, FLY_H, dev)
    trace_api.reset_launch_counts()
    rays = []
    for i in range(FLY_FRAMES):
        cam.press("d")
        cam.update(1.0 / 60.0)
        cam.release("d")
        tf = wobble(i)
        if i > 0:
            torch.cuda.set_sync_debug_mode("error")
        try:
            scene = refit.update_instances(scene, tf, changed=(CRYSTAL,))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        uniform = renderer.camera_to_device(
            cam.uniform(FLY_W / FLY_H, 0, scene.num_lights), dev)
        ldr, hdr, state, aux = pipeline.render_frame(
            scene, uniform, 0, state, FLY_W, FLY_H, static_ok=False)
        rays.append(aux["rays"])
    launches = dict(trace_api.LAUNCHES)
    rays = [float(r) for r in rays]
    on = ["closest_hit", "any_hit", "table_gather", *FRAME_SHADE]
    if min(launches[k] for k in on) <= 0 or any(
            v for k, v in launches.items() if k not in on):
        raise AssertionError(f"config 4 must launch {on} and nothing else: "
                             f"{launches}")
    if not (torch.isfinite(ldr).all() and ldr.min() >= 0 and ldr.max() <= 1
            and torch.isfinite(hdr).all() and min(rays) > 0):
        raise AssertionError("config 4: ldr not finite in [0, 1], hdr not "
                             "finite or no rays")
    if ldr.shape != (FLY_W * FLY_H, 3):
        raise AssertionError(f"config 4: ldr is {tuple(ldr.shape)}")

    # the last changed-instance refit against a full one
    tf = wobble(FLY_FRAMES - 1)
    full = refit.update_instances(scene0, tf)
    gaps = {}
    for name in ("tri_planes", "chunk_aabb", "tri_table", "bvh_rec",
                 "inst_transform", "inst_normal_mat"):
        gaps[name] = float((getattr(scene, name)
                            - getattr(full, name)).abs().max())
    if not max(gaps.values()) <= REFIT_ATOL:
        raise AssertionError(f"config 4: the changed refit differs from the "
                             f"full one beyond {REFIT_ATOL}: {gaps}")
    pairs = _boxes_contain(torch, scene)

    # K1 / K2 on the refit scene's primary rays against plain, and its
    # frame with the plain fetch against K7's
    uniform = renderer.camera_to_device(
        cam.uniform(FLY_W / FLY_H, 0, scene.num_lights), dev)
    o, d, po, pd, t_min, t_max = _check_primary(torch, scene, uniform, FLY_W,
                                                FLY_H, "config 4")
    n = o.shape[1]
    fetch_psnr = _check_fetch(torch, scene, uniform, FLY_W, FLY_H,
                              "config 4")

    def k1(s):
        return trace_api.trace_kernel(s.tri_planes, s.chunk_aabb, o, d,
                                      t_min, t_max)

    # a repack keeps K1's answers; each winner's row follows its triangle
    packed = refit.update_instances(scene0, tf, repack=True)
    order = lbvh.morton_order(full)
    if not torch.equal(packed.tri_table, full.tri_table[order]):
        raise AssertionError("config 4: the repacked rows do not follow the "
                             "Morton order")
    f_res, p_res = k1(full), k1(packed)
    hit = f_res["tri"] >= 0
    if not (torch.equal(p_res["tri"] >= 0, hit) and torch.equal(
            p_res["t"].view(torch.int32), f_res["t"].view(torch.int32))):
        raise AssertionError("config 4: the repack changed K1's hit/miss or "
                             "t")
    moved = hit & (order[p_res["tri"].clamp(min=0).long()] != f_res["tri"])
    lanes = torch.nonzero(moved).squeeze(1)
    if lanes.numel():
        # a different winner only at an exact-t tie (ids order ties)
        ids = order[p_res["tri"][lanes].long()]
        t_other, _ = trace_api.mt_argmin(
            full.tri_planes[:, :, ids][..., None],
            V3(*(x[lanes] for x in po)), V3(*(x[lanes] for x in pd)),
            t_min[lanes], t_max[lanes], t_max[lanes])
        if not torch.equal(t_other, f_res["t"][lanes]):
            raise AssertionError(f"config 4: {lanes.numel()} repacked "
                                 f"winners are other triangles without a "
                                 f"tie")
    print(f"config 4: Cornell {FLY_W}x{FLY_H} fly-through, crystal refit "
          f"with changed=({CRYSTAL},) each frame, {FLY_FRAMES} frames: "
          f"{on} launched and nothing else, no host sync in "
          f"update_instances from frame 1 on; changed refit against full, "
          f"max |diff| {max(gaps.values()):.3g} (bound {REFIT_ATOL}); "
          f"{pairs} (box, triangle) pairs contained; K1 equal to plain on "
          f"{n} primary rays, t bit-equal, K2 occlusion equal; the frame "
          f"with the plain fetch against K7's: PSNR {fetch_psnr:.2f} dB "
          f"(floor {VPU_DB}); repack: K1 hit/miss and t bit-equal, rows "
          f"follow the order, {lanes.numel()} winners moved within exact-t "
          f"ties", flush=True)


def _app_phase(torch, root, dev):
    """Phase 21: first, in this process, K1/K2 on the app's default scene
    and camera at APP_W x APP_H against plain, and its first frame with
    the plain fetch against K7's; then `python -m tpu_raytracer_torch` at
    APP_W x APP_H for APP_FRAMES frames (no preview, stdin not a tty, an
    auto-screenshot at APP_SPP samples, a checkpoint), then APP_RESUME
    more frames resumed from its checkpoint."""
    from tpu_raytracer_torch.app import interactive
    from tpu_raytracer_torch.render import camera, checkpoint, renderer
    from tpu_raytracer_torch.utils import config, png

    cfg = config.RenderConfig()
    scene = interactive.load_scene(cfg.scene, dev)
    uniform = renderer.camera_to_device(camera.CameraController().uniform(
        APP_W / APP_H, 0, scene.num_lights), dev)
    _check_primary(torch, scene, uniform, APP_W, APP_H, "app")
    fetch_psnr = _check_fetch(torch, scene, uniform, APP_W, APP_H, "app")
    print(f"app checks: the default scene ({cfg.scene}) at {APP_W}x{APP_H}: "
          f"K1 equal to plain on {APP_W * APP_H} primary rays, t bit-equal, "
          f"K2 occlusion equal; the first frame with the plain fetch against "
          f"K7's: PSNR {fetch_psnr:.2f} dB (floor {VPU_DB})", flush=True)
    del scene

    with tempfile.TemporaryDirectory() as tmp:
        ck, out = os.path.join(tmp, "app.npz"), os.path.join(tmp, "shots")

        def app(frames):
            proc = subprocess.run(
                [sys.executable, "-m", "tpu_raytracer_torch",
                 f"--scale={APP_W}x{APP_H}", "--max-frames", str(frames),
                 "--no-preview", "--target-spp", str(APP_SPP),
                 "--checkpoint", ck, "--out-dir", out],
                cwd=root, stdin=subprocess.DEVNULL, capture_output=True,
                text=True, timeout=600)
            if proc.returncode:
                raise AssertionError(f"the app exited {proc.returncode}: "
                                     f"{proc.stderr[-3000:]}")
            lines = proc.stdout.strip().splitlines()
            return lines, json.loads(lines[-1])

        lines, tel = app(APP_FRAMES)
        shots = os.listdir(out)
        if len(shots) != 1:
            raise AssertionError(f"the app wrote {shots}, not one PNG")
        with open(os.path.join(out, shots[0]), "rb") as fh:
            shape = png.decode(fh.read()).shape
        if shape != (APP_H, APP_W, 4):
            raise AssertionError(f"the app's PNG decodes to {shape}")
        frame_count = checkpoint.load(ck)[1]
        launches = tel["launches"]
        on = ("closest_hit", "any_hit", "table_gather", *FRAME_SHADE)
        if not (frame_count == APP_FRAMES == tel["frames"]
                and min(launches[k] for k in on) > 0 and "fps" in tel):
            raise AssertionError(f"the app: checkpoint frame_count "
                                 f"{frame_count}, telemetry {tel}")
        r_lines, _ = app(APP_RESUME)
        resumed = f"resumed from {ck} at frame {APP_FRAMES}"
        if resumed not in r_lines or (checkpoint.load(ck)[1]
                                      != APP_FRAMES + APP_RESUME):
            raise AssertionError(f"the app did not resume at frame "
                                 f"{APP_FRAMES}: {r_lines}")
    print(f"app: python -m tpu_raytracer_torch --scale={APP_W}x{APP_H}, "
          f"{APP_FRAMES} frames: exit 0, {list(on)} launched, PNG {shape} "
          f"read back, checkpoint frame_count {frame_count}; resumed at "
          f"frame {APP_FRAMES} for {APP_RESUME} frames", flush=True)


def _standins_phase(torch, root, dev, kernels):
    """Phase 22: each stand-in scene built through the app's load_scene,
    checked (triangles, the truffle's lights, K1/K2 on its primary rays)
    and rendered through _run_frames, launching `kernels` and none of the
    other trace kernels; then the app on the truffle."""
    from tpu_raytracer_torch.app import interactive
    from tpu_raytracer_torch.render import camera, renderer

    flat, others = kernels
    for name, want in STANDINS:
        scene = interactive.load_scene(name, dev)
        if scene.num_triangles != want or scene.instanced:
            raise AssertionError(f"{name}: {scene.num_triangles} triangles "
                                 f"(instanced {scene.instanced}), not the "
                                 f"{want} of the flat stand-in scene")
        if name == "truffle":
            strengths = sorted(scene.light_table[:, 14].tolist())
            if scene.num_lights != 3 or strengths != [10.0, 40.0, 80.0]:
                raise AssertionError(f"truffle: {scene.num_lights} lights "
                                     f"of strengths {strengths}, not the "
                                     f"studio's 10, 40 and 80")
        uniform = renderer.camera_to_device(camera.CameraController().uniform(
            WIDTH / HEIGHT, 0, scene.num_lights), dev)
        _check_primary(torch, scene, uniform, WIDTH, HEIGHT, name)
        ldrs = _run_frames(torch, scene, dev, SCENE_FRAMES, name, flat,
                           others)
        for i, ldr in enumerate(ldrs):
            if not (torch.isfinite(ldr).all() and float(ldr.max()) > 0.01):
                raise AssertionError(f"{name}: frame {i} is not finite or "
                                     f"is black (max {float(ldr.max())})")
        print(f"stand-in {name}: {scene.num_triangles} triangles, "
              f"{scene.num_lights} lights; K1 equal to plain on "
              f"{WIDTH * HEIGHT} primary rays, t bit-equal, K2 occlusion "
              f"equal; {SCENE_FRAMES} {WIDTH}x{HEIGHT} frames finite, none "
              f"black, {flat}, K7, K9 and K10 launched and no other trace "
              f"kernel", flush=True)
        del scene, ldrs

    proc = subprocess.run(
        [sys.executable, "-m", "tpu_raytracer_torch", "--scene", "truffle",
         f"--scale={APP_W}x{APP_H}", "--max-frames", str(STANDIN_APP_FRAMES),
         "--no-preview"], cwd=root, stdin=subprocess.DEVNULL,
        capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"the truffle app exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    tel = json.loads(proc.stdout.strip().splitlines()[-1])
    launches = tel["launches"]
    if not (tel["frames"] == STANDIN_APP_FRAMES
            and min(launches[k]
                    for k in (*flat, "table_gather", *FRAME_SHADE)) > 0
            and not any(launches[k] for k in others)):
        raise AssertionError(f"the truffle app: telemetry {tel}")
    print(f"stand-in app: python -m tpu_raytracer_torch --scene truffle "
          f"--scale={APP_W}x{APP_H} --max-frames {STANDIN_APP_FRAMES}: exit "
          f"0, launches {launches}", flush=True)


def _walk_check(torch, scene, what, o, d, t_min, t_max):
    """K8 closest- and any-hit against the plain walk on these rays: tri
    equal on every lane and t bit-equal, or raise."""
    from tpu_raytracer_torch.ops import traversal
    from tpu_raytracer_torch.utils.vec3 import V3

    bvh = (scene.bvh_rec, scene.bvh_skip, scene.bvh_tri)
    for any_hit in (False, True):
        got = traversal.trace_bvh_kernel(*bvh, o, d, t_min, t_max, any_hit)
        want = traversal.trace_plain(*bvh, V3(*o), V3(*d), t_min, t_max,
                                     any_hit=any_hit)
        query = "any" if any_hit else "closest"
        bad = int((got["tri"] != want["tri"]).sum())
        if bad:
            raise AssertionError(f"K8 {query} {what}: tri differs from the "
                                 f"plain walk on {bad} lanes")
        bad = int((got["t"].view(torch.int32)
                   != want["t"].view(torch.int32)).sum())
        if bad:
            raise AssertionError(f"K8 {query} {what}: t differs from the "
                                 f"plain walk on {bad} lanes")
    print(f"K8: {what}: closest- and any-hit equal the plain walk on "
          f"{o.shape[1]} rays: tri on every lane, t bit-equal", flush=True)


def _walk_phase(torch, dev, every, c_first):
    """Phase 23: the BVH walk (K8) on the 2,621,444-triangle scene past the
    cap, and on the Cornell box built with brute_max=1 (its frames against
    `c_first`, phase 5's)."""
    from tpu_raytracer_torch.bigscene import big_scene, walk_rays
    from tpu_raytracer_torch.models import scenes
    from tpu_raytracer_torch.ops import gbuffer, trace_api
    from tpu_raytracer_torch.render import camera, renderer

    walk = ["bvh_closest_hit", "bvh_any_hit"]
    others = [k for k in every if k not in (*walk, *FRAME_SHADE)]
    big = big_scene(dev, BIG_SUBDIV, (-0.3, 0.3))
    route = trace_api.trace_route(big.kernel, big.incull,
                                  big.tri_planes.shape[2], False,
                                  big.brute_max)
    if big.num_triangles != BIG_TRIANGLES or route[0] != "bvh":
        raise AssertionError(f"big scene: {big.num_triangles} triangles, "
                             f"route {route}")
    print(f"walk: big scene {big.num_triangles} triangles (cap "
          f"{big.brute_max}: route {route[0]})", flush=True)

    # K8 against the plain walk on both ray sets
    for name, r in walk_rays(dev, WALK_RAYS).items():
        _walk_check(torch, big, f"big scene {name}", *r)

    # the big scene's frames: K8 and K7 only
    ldrs = _run_frames(torch, big, dev, SCENE_FRAMES, "big scene", walk,
                       others)
    for i, ldr in enumerate(ldrs):
        if not float(ldr.max()) > 0.01:
            raise AssertionError(f"big scene frame {i} is black")
    print(f"walk frame: big scene {WIDTH}x{HEIGHT}, {SCENE_FRAMES} frames: "
          f"K8, K7, K9 and K10 launched and no other trace kernel, none "
          f"black", flush=True)
    del big, ldrs

    # the Cornell box forced through the walk
    cornell = scenes.create_cornell_box(dev, brute_max=1)
    uniform = renderer.camera_to_device(camera.CameraController().uniform(
        WIDTH / HEIGHT, 0, cornell.num_lights), dev)
    po, pd = gbuffer.generate_primary_rays(uniform, WIDTH, HEIGHT)
    n_p = po.x.shape[0]
    primary = (torch.stack(list(po)).contiguous(),
               torch.stack(list(pd)).contiguous(),
               torch.full((n_p,), gbuffer.T_MIN, device=dev),
               torch.full((n_p,), gbuffer.T_MAX, device=dev))
    ro, rd, rt_max = _random_rays(torch, WALK_RAYS, dev, seed=3)
    rnd = (ro, rd, torch.full((WALK_RAYS,), 1e-3, device=dev), rt_max)
    _walk_check(torch, cornell, f"Cornell primary {WIDTH}^2", *primary)
    _walk_check(torch, cornell, "Cornell random", *rnd)
    ldrs, c_launches = _first_frames(cornell, dev, len(c_first))
    if (min(c_launches[k] for k in (*walk, *FRAME_SHADE)) <= 0
            or any(c_launches[k] for k in others)):
        raise AssertionError(f"the walked Cornell frames must launch K8 and "
                             f"K9 and no other kernel: {c_launches}")
    psnr = min(_psnr(a.numpy(), b.numpy()) for a, b in zip(ldrs, c_first))
    if not psnr >= VPU_DB:
        raise AssertionError(f"walked Cornell frames: PSNR {psnr:.2f} dB "
                             f"against K1's < {VPU_DB}")
    print(f"walk Cornell: the first {len(ldrs)} {WIDTH}x{HEIGHT} frames "
          f"built with brute_max=1 (K8, no K1/K2) against phase 5's: PSNR "
          f"{psnr:.2f} dB (floor {VPU_DB})", flush=True)


def _tiled_sequence(torch, render, state, dev, frames, move_at=None):
    """`frames` Cornell frames of bench.py:headline_tiled's camera
    sequence through `render(uniform, frame_count, state, static_ok)`,
    the camera moved (and the count reset) at frame `move_at`. Returns
    (the last ldr, every frame's rays, the per-band launches summed over
    every frame or None)."""
    rays, bands = [], None
    for uniform, fc, static_ok in _camera_seq(dev, frames, 2, move_at):
        ldr, hdr, state, aux = render(uniform, fc, state, static_ok)
        if "band_launches" in aux:
            bands = [{k: (bands[b][k] if bands else 0) + v
                      for k, v in launched.items()}
                     for b, launched in enumerate(aux["band_launches"])]
        rays.append(float(aux["rays"]))    # a host read, as the bench's
    if not (torch.isfinite(ldr).all() and ldr.min() >= 0 and ldr.max() <= 1
            and torch.isfinite(hdr).all()):
        raise AssertionError("tiled phase: ldr or hdr is not finite")
    return ldr, rays, bands


def _tiles_phase(torch, dev, every):
    """24. the frame over row bands (parallel/tiles.py): 4 bands of the
    512^2 Cornell frame on this card (and on 4 cards where there are),
    held to the one-device frames of the same sequences."""
    from tpu_raytracer_torch.models import scenes
    from tpu_raytracer_torch.ops import trace_api
    from tpu_raytracer_torch.parallel import tiles
    from tpu_raytracer_torch.render import pipeline

    scene = scenes.create_cornell_box(dev)
    on = ["closest_hit", "any_hit", "table_gather", *FRAME_SHADE]
    off = [k for k in every if k not in on]

    def one_device(uniform, fc, state, static_ok):
        return pipeline.render_frame(scene, uniform, fc, state, WIDTH,
                                     HEIGHT, static_ok=static_ok)

    def fresh():
        return pipeline.init_state(WIDTH, HEIGHT, dev)

    ldr1, rays1, _ = _tiled_sequence(torch, one_device, fresh(), dev, FRAMES)
    moved1, _, _ = _tiled_sequence(torch, one_device, fresh(), dev,
                                   TILE_MOTION_FRAMES, TILE_MOVE_AT)

    meshes = [("1 card", [dev] * TILE_BANDS)]
    if torch.cuda.device_count() >= TILE_BANDS:
        meshes.append((f"{TILE_BANDS} cards",
                       [torch.device("cuda", i) for i in range(TILE_BANDS)]))
    for what, devices in meshes:
        mesh = tiles.make_mesh(devices)
        tiled = tiles.make_render_frame_tiled(mesh, WIDTH, HEIGHT)
        scene_r = tiles.replicate(scene, mesh)

        def render(uniform, fc, state, static_ok):
            return tiled(scene_r, uniform, fc, state, static_ok)

        def fresh_bands():
            return tiles.shard_state(fresh(), mesh)

        trace_api.reset_launch_counts()
        ldr, rays, bands = _tiled_sequence(torch, render, fresh_bands(), dev,
                                           FRAMES)
        launches = dict(trace_api.LAUNCHES)
        moved, _, _ = _tiled_sequence(torch, render, fresh_bands(), dev,
                                      TILE_MOTION_FRAMES, TILE_MOVE_AT)
        gap = float((ldr - ldr1).abs().max())
        gap_moved = float((moved - moved1).abs().max())
        ray_gap = max(abs(a - b) for a, b in zip(rays, rays1))
        if gap > TILE_LDR_ATOL or gap_moved > TILE_LDR_ATOL \
                or ray_gap > TILE_RAYS_ATOL:
            raise AssertionError(
                f"{TILE_BANDS} bands on {what}: ldr max abs {gap:.3g} (moved "
                f"{gap_moved:.3g}), rays {ray_gap:.3g} off the one-device "
                f"frames (bounds {TILE_LDR_ATOL}, {TILE_RAYS_ATOL})")
        for b, band in enumerate(bands):
            if min(band[k] for k in on) <= 0 or any(band[k] for k in off):
                raise AssertionError(f"band {b} on {what} must launch {on} "
                                     f"and none of {off}: {band}")
        if launches != {k: sum(b[k] for b in bands) for k in launches}:
            raise AssertionError(f"the bands' launches {bands} do not sum "
                                 f"to the run's {launches}")
        print(f"tiles: {TILE_BANDS} bands of {HEIGHT // TILE_BANDS} rows on "
              f"{what}, Cornell {WIDTH}x{HEIGHT}, {FRAMES} frames: last ldr "
              f"max abs {gap:.3g} against the one-device frame, moved "
              f"camera {gap_moved:.3g} (bound {TILE_LDR_ATOL}), rays max gap "
              f"{ray_gap:.3g} a frame; {on} launched in every band and no "
              f"other trace kernel", flush=True)


def _camera_seq(dev, frames, num_lights, move_at=None, start=0):
    """The inputs of a camera sequence at aspect 1: per frame (uniform on
    dev, frame_count, static_ok). The counter starts at `start` and
    resets at frame `move_at`, where the camera moves (state.rs:151)."""
    from tpu_raytracer_torch.render import camera, renderer

    cam = camera.CameraController()
    fc, seq = start, []
    for i in range(frames):
        if i == move_at:
            cam.press("w")
            cam.update(0.05)
            cam.release("w")
            fc = 0
        seq.append((renderer.camera_to_device(
            cam.uniform(1.0, fc, num_lights), dev), fc, fc > 0))
        fc += 1
    return seq


def _eager(scene, dev, width, height, **kw):
    """render(uniform, fc, static_ok): render_frame's eager frames from a
    fresh state, each frame's state carried to the next."""
    from tpu_raytracer_torch.render import pipeline

    state = pipeline.init_state(width, height, dev)

    def render(uniform, fc, static_ok):
        nonlocal state
        out = pipeline.render_frame(scene, uniform, fc, state, width, height,
                                    static_ok=static_ok, **kw)
        state = out[2]
        return out

    return render


def _replay(graph, **kw):
    """render(uniform, fc, static_ok) through `graph` from a fresh state."""
    from tpu_raytracer_torch.render import pipeline, renderer

    w, h, dev = graph.width, graph.height, graph.device
    graph.load_state({"accum": renderer.make_accum(w, h, dev)}
                     if graph.progressive else pipeline.init_state(w, h, dev))

    def render(uniform, fc, static_ok):
        return graph(uniform, fc, static_ok, **kw)

    return render


def _words(out):
    """A frame's outputs as (name, tensor) pairs: render_frame's ldr, hdr,
    each state tensor and aux["rays"], or render_progressive's accum and
    radiance."""
    if len(out) == 2:
        return [("accum", out[0]), ("radiance", out[1])]
    ldr, hdr, state, aux = out
    return [("ldr", ldr), ("hdr", hdr), *state.items(), ("rays", aux["rays"])]


def _word_gap(torch, a, b):
    """(max |a - b|, every word equal) of two tensors of one dtype; f32
    words are compared as their bits."""
    gap = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
    if a.dtype == torch.float32:
        return gap, torch.equal(a.view(torch.int32), b.view(torch.int32))
    return gap, torch.equal(a, b)


def _lockstep(torch, eager, graph, seq, what):
    """Each frame of `seq` through `eager` and then `graph`, held word for
    word (ldr, hdr, every state tensor, rays). Returns the max abs gap;
    raises on a word that differs."""
    gap = 0.0
    for i, (u, fc, static_ok) in enumerate(seq):
        want = _words(eager(u, fc, static_ok))
        got = _words(graph(u, fc, static_ok))
        for (name, a), (_, b) in zip(got, want):
            g, same = _word_gap(torch, a, b)
            gap = max(gap, g)
            if not same:
                raise AssertionError(f"{what} frame {i}: the graph's {name} "
                                     f"differs from the eager frame's (max "
                                     f"abs {g:.3g})")
    return gap


def _run_seq(render, seq):
    """Each of seq's frames through render(*its inputs); returns their
    rays."""
    return [float(render(*inputs)[3]["rays"]) for inputs in seq]


def _graph_phase(torch, dev, every):
    """25. the frame as CUDA graphs (render/graph.py:FrameGraph): the
    headline sequence, the moving camera, G-buffer reuse, config 1 and
    the other trace routes, each replayed frame held to the eager frame
    word for word; an eager frame under set_sync_debug_mode("error");
    eager and replayed launches."""
    from tpu_raytracer_torch.models import scenes
    from tpu_raytracer_torch.ops import trace_api
    from tpu_raytracer_torch.render import pipeline, renderer
    from tpu_raytracer_torch.render.graph import FrameGraph

    scene = scenes.create_cornell_box(dev)
    seq = _camera_seq(dev, FRAMES, scene.num_lights)
    graph = FrameGraph(scene, WIDTH, HEIGHT, dev)
    gap = _lockstep(torch, _eager(scene, dev, WIDTH, HEIGHT), _replay(graph),
                    seq, "headline")
    moved = _camera_seq(dev, TILE_MOTION_FRAMES, scene.num_lights,
                        move_at=TILE_MOVE_AT)
    gap_moved = _lockstep(torch, _eager(scene, dev, WIDTH, HEIGHT),
                          _replay(graph), moved, "moving camera")
    print(f"graph: Cornell {WIDTH}x{HEIGHT}, the headline sequence ({FRAMES} "
          f"frames) and the moving camera ({TILE_MOTION_FRAMES} frames, moved "
          f"at {TILE_MOVE_AT}) through FrameGraph against render_frame: ldr, "
          f"hdr, every state tensor and rays bit-equal on every frame, max "
          f"abs gap {gap:.3g} / {gap_moved:.3g}", flush=True)

    # no host read: eager frames after the first under the sync check
    render = _eager(scene, dev, WIDTH, HEIGHT)
    (u0, f0, s0), (u1, f1, s1), (u2, f2, s2) = seq[:3]
    render(u0, f0, s0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = render(u1, f1, s1)[2]
        pipeline.render_frame(scene, u2, f2, state, WIDTH, HEIGHT,
                              static_ok=s2, gb_reuse=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("graph: eager Cornell frames 1 and 2 (static, and with the G-buffer "
          "reused) under torch.cuda.set_sync_debug_mode('error'): no host "
          "sync", flush=True)

    # the headline sequence eager, then replayed: the same launches and
    # rays
    trace_api.reset_launch_counts()
    e_rays = _run_seq(_eager(scene, dev, WIDTH, HEIGHT), seq)
    e_launches = dict(trace_api.LAUNCHES)
    trace_api.reset_launch_counts()
    g_rays = _run_seq(_replay(graph), seq)
    g_launches = dict(trace_api.LAUNCHES)
    if g_launches != e_launches or g_rays != e_rays:
        raise AssertionError(f"replayed frames launch {g_launches} and count "
                             f"{g_rays} rays; the eager frames {e_launches} "
                             f"and {e_rays}")
    on = ["closest_hit", "any_hit", "table_gather", *FRAME_SHADE]
    if min(g_launches[k] for k in on) <= 0 or any(
            g_launches[k] for k in every if k not in on):
        raise AssertionError(f"the replayed Cornell frames must launch {on} "
                             f"and no other kernel: {g_launches}")
    per_frame = {k: g_launches[k] / FRAMES for k in on}
    if any(per_frame[k] != 2 * n for k, n in K9_CALL.items()):
        raise AssertionError(f"the replayed Cornell frames launch K9 "
                             f"{per_frame}: want 2 trace_path calls of "
                             f"{K9_CALL} a frame")
    print(f"graph: launches a frame, replayed and eager, equal: {per_frame}; "
          f"rays equal", flush=True)

    # the G-buffer reused on static frames, against the traced one
    eager = _eager(scene, dev, WIDTH, HEIGHT)
    reuse = _replay(graph, gb_reuse=True)
    r_gap = 0.0
    for i, (u, fc, static_ok) in enumerate(seq):
        want, got = eager(u, fc, static_ok), reuse(u, fc, static_ok)
        r_gap = max(r_gap, *(float((a - b).abs().max())
                             for a, b in zip(got[:2], want[:2])))
        drop = float(want[3]["rays"]) - float(got[3]["rays"])
        if drop != (WIDTH * HEIGHT if i else 0):
            raise AssertionError(f"reuse frame {i}: {drop} fewer rays than "
                                 f"the traced G-buffer's frame")
    if r_gap > GRAPH_REUSE_ATOL:
        raise AssertionError(f"reused G-buffer frames: max abs {r_gap:.3g} "
                             f"off the traced ones (bound {GRAPH_REUSE_ATOL})")
    print(f"graph: FrameGraph with gb_reuse against render_frame without: "
          f"ldr and hdr max abs {r_gap:.3g} (bound {GRAPH_REUSE_ATOL}), "
          f"{WIDTH * HEIGHT} rays fewer on every frame after the first",
          flush=True)
    del graph, reuse, render, eager

    # config 1: the progressive frames
    diffuse = scenes.create_cornell_box_diffuse(dev)
    p_seq = _camera_seq(dev, PROGRESSIVE_FRAMES, diffuse.num_lights)
    p_graph = FrameGraph(diffuse, WIDTH, HEIGHT, dev, progressive=True)
    accum = renderer.make_accum(WIDTH, HEIGHT, dev)

    def progressive(u, fc, static_ok):
        nonlocal accum
        accum, rad = renderer.render_progressive(diffuse, u, fc, accum,
                                                 WIDTH, HEIGHT)
        return accum, rad

    p_gap = _lockstep(torch, progressive, _replay(p_graph), p_seq,
                      "config 1")
    print(f"graph: config 1, {PROGRESSIVE_FRAMES} render_progressive frames "
          f"through FrameGraph(progressive=True) against eager: accum and "
          f"radiance bit-equal on every frame (max abs gap {p_gap:.3g})",
          flush=True)
    del p_graph, diffuse, accum

    # the other routes, each kernel captured in its own scene's frames
    routes = (
        ("knot (K3)", lambda: scenes.create_dense_knot_scene(dev),
         ["stream_closest_hit", "stream_any_hit"]),
        ("gallery (K4)", lambda: scenes.create_instancing_gallery_scene(dev),
         ["inst_closest_hit", "inst_any_hit"]),
        ("vpu (K5)", lambda: scenes.create_cornell_box(dev, kernel="vpu"),
         ["vpu_closest_hit"]),
        ("mxu3 (K6)", lambda: scenes.create_cornell_box(dev, kernel="mxu3"),
         ["mxu_closest_hit", "any_hit"]),
        ("walked Cornell (K8)",
         lambda: scenes.create_cornell_box(dev, brute_max=1),
         ["bvh_closest_hit", "bvh_any_hit"]))
    for what, build, on in routes:
        s = build()
        r_seq = _camera_seq(dev, GRAPH_ROUTE_FRAMES, s.num_lights)
        g = FrameGraph(s, WIDTH, HEIGHT, dev)
        gap = _lockstep(torch, _eager(s, dev, WIDTH, HEIGHT), _replay(g),
                        r_seq, what)
        trace_api.reset_launch_counts()
        render = _replay(g)
        for u, fc, static_ok in r_seq:
            render(u, fc, static_ok)
        launched = dict(trace_api.LAUNCHES)
        on = [*on, "table_gather", *FRAME_SHADE]
        if min(launched[k] for k in on) <= 0 or any(
                launched[k] for k in every if k not in on):
            raise AssertionError(f"the replayed {what} frames must launch "
                                 f"{on} and no other kernel: {launched}")
        print(f"graph: {what} {WIDTH}x{HEIGHT}, {GRAPH_ROUTE_FRAMES} frames "
              f"through FrameGraph bit-equal to render_frame (max abs gap "
              f"{gap:.3g}); replayed, {on} launched and no other kernel",
              flush=True)
        del s, g, render


def _refit_graph(torch, dev, every):
    """26a. config 4 replayed (render/graph.py:FrameGraph with
    refit_changed): bench.py:187-206's sequence, each frame's crystal
    refit in place and the frame in one replay, held in lockstep to the
    eager sequence (update_instances, then render_frame): every output,
    state word and refit field equal; replays after the first under
    set_sync_debug_mode("error"). Then both again for their launches and
    rays, and a replayed frame's host launches under torch.profiler."""
    from tpu_raytracer_torch.models import scenes
    from tpu_raytracer_torch.ops import refit, trace_api
    from tpu_raytracer_torch.render import camera, pipeline, renderer
    from tpu_raytracer_torch.render.graph import FrameGraph

    scene0 = scenes.create_cornell_box(dev)
    names = refit.refit_fields(scene0)
    kept = {n: getattr(scene0, n).clone() for n in names}
    base = scene0.inst_transform.cpu().numpy()
    cam = camera.CameraController()
    frames = FLY_FRAMES
    seq = []
    for i in range(frames + 2):       # 2 more for the profiled frame
        cam.press("d")
        cam.update(1.0 / 60.0)
        cam.release("d")
        seq.append((renderer.camera_to_device(
            cam.uniform(FLY_W / FLY_H, 0, scene0.num_lights), dev),
            _wobble(torch, base, i, dev)))

    def eager():
        """(render(uniform, transforms), the refit scene of its last
        frame) from config 4's first state."""
        at = {"scene": scene0,
              "state": pipeline.init_state(FLY_W, FLY_H, dev)}

        def render(u, tf):
            at["scene"] = refit.update_instances(at["scene"], tf,
                                                 changed=(CRYSTAL,))
            out = pipeline.render_frame(at["scene"], u, 0, at["state"],
                                        FLY_W, FLY_H, static_ok=False)
            at["state"] = out[2]
            return out
        return render, at

    graph = FrameGraph(scene0, FLY_W, FLY_H, dev, refit_changed=(CRYSTAL,))

    def replay(u, tf):
        return graph(u, 0, False, transforms=tf)

    render, at = eager()
    gap = 0.0
    for i, (u, tf) in enumerate(seq[:frames]):
        want = _words(render(u, tf))
        if i:
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = _words(replay(u, tf))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got += [(n, getattr(graph.scene, n)) for n in names]
        want += [(n, getattr(at["scene"], n)) for n in names]
        for (name, a), (_, b) in zip(got, want):
            g, same = _word_gap(torch, a, b)
            gap = max(gap, g)
            if not same:
                raise AssertionError(f"config 4 frame {i}: the replay's "
                                     f"{name} differs from the eager "
                                     f"sequence's (max abs {g:.3g})")
    for n, t in kept.items():
        if not torch.equal(getattr(scene0, n), t):
            raise AssertionError(f"config 4: the replays wrote the "
                                 f"caller's scene ({n})")
    print(f"graph II: config 4 (Cornell {FLY_W}x{FLY_H} fly-through, the "
          f"crystal refit with changed=({CRYSTAL},) in place) through "
          f"FrameGraph(refit_changed) against update_instances + "
          f"render_frame, {frames} frames: ldr, hdr, every state tensor, "
          f"rays and the refit fields {list(names)} bit-equal on every "
          f"frame (max abs gap {gap:.3g}); replays 1-{frames - 1} under "
          f"set_sync_debug_mode('error'): no host sync; the caller's scene "
          f"unwritten", flush=True)

    on = ["closest_hit", "any_hit", "table_gather", *FRAME_SHADE]
    runs = {}
    for what in ("eager", "replayed"):
        if what == "eager":
            render, _ = eager()
        else:
            graph.load_state(pipeline.init_state(FLY_W, FLY_H, dev))
            render = replay
        trace_api.reset_launch_counts()
        rays = _run_seq(render, seq[:frames])
        runs[what] = (rays, dict(trace_api.LAUNCHES))
    (e_rays, e_launches), (g_rays, g_launches) = (runs["eager"],
                                                  runs["replayed"])
    if g_launches != e_launches or g_rays != e_rays:
        raise AssertionError(f"config 4 replayed launches {g_launches} and "
                             f"counts {g_rays} rays; eager {e_launches}, "
                             f"{e_rays}")
    if min(g_launches[k] for k in on) <= 0 or any(
            g_launches[k] for k in every if k not in on):
        raise AssertionError(f"config 4 replayed must launch {on} and no "
                             f"other kernel: {g_launches}")
    launched, graphs = _host_launches(torch, replay, seq[frames:])
    if launched > GRAPH_FLY_LAUNCHES:
        raise AssertionError(f"config 4 replayed: {launched:.0f} host "
                             f"launches a frame (at most "
                             f"{GRAPH_FLY_LAUNCHES})")
    print(f"graph II: config 4 replayed and eager: launches and rays equal, "
          f"{on} launched and no other kernel; a replayed frame under "
          f"torch.profiler: {launched:.0f} host launches ({graphs:.0f} "
          f"graphs, at most {GRAPH_FLY_LAUNCHES})", flush=True)
    del graph


def _tiled_graph(torch, root, dev, every):
    """26b. the row bands replayed (parallel/tiles.py:TiledFrameGraph):
    phase 24's headline sequence and moving camera over 4 bands of this
    card, and of 4 cards where the host has them (there also `python -m
    tpu_raytracer_torch --tiles 4`), each frame held to the eager tiled
    frame and to the one-device frame."""
    from tpu_raytracer_torch.models import scenes

    scene = scenes.create_cornell_box(dev)
    _bands_replayed(torch, dev, every, scene, "1 card", [dev] * TILE_BANDS)
    if torch.cuda.device_count() >= TILE_BANDS:
        _bands_replayed(torch, dev, every, scene, f"{TILE_BANDS} cards",
                        [torch.device("cuda", i) for i in range(TILE_BANDS)])
        _tiled_app(root)


def _bands_replayed(torch, dev, every, scene, what, devices):
    """TiledFrameGraph over `devices`: the headline sequence and the
    moving camera in lockstep with the eager bands and the one-device
    frames, every word equal; each band's launches its eager band's (K1,
    K2 and K7, no other trace kernel). Then a replayed frame under
    torch.profiler: graph launches a frame = bands x segments, other
    launches at most GRAPH_TILE_OTHER."""
    from tpu_raytracer_torch.parallel import tiles
    from tpu_raytracer_torch.render import pipeline

    seqs = (("headline", _camera_seq(dev, FRAMES, scene.num_lights)),
            ("moving camera", _camera_seq(dev, TILE_MOTION_FRAMES,
                                          scene.num_lights,
                                          move_at=TILE_MOVE_AT)))
    on = ["closest_hit", "any_hit", "table_gather", *FRAME_SHADE]
    mesh = tiles.make_mesh(devices)
    scene_r = tiles.replicate(scene, mesh)
    tiled = tiles.make_render_frame_tiled(mesh, WIDTH, HEIGHT)
    graph = tiles.TiledFrameGraph(mesh, scene_r, WIDTH, HEIGHT)

    def eager_bands():
        state = tiles.shard_state(pipeline.init_state(WIDTH, HEIGHT, dev),
                                  mesh)

        def render(u, fc, static_ok):
            nonlocal state
            ldr, hdr, state, aux = tiled(scene_r, u, fc, state, static_ok)
            return ldr, hdr, tiles.gather_state(state), aux
        return render

    def replay(u, fc, static_ok):
        ldr, hdr, state, aux = graph(u, fc, static_ok)
        return ldr, hdr, tiles.gather_state(state), aux

    gaps = {}
    for name, seq in seqs:
        one, bands = _eager(scene, dev, WIDTH, HEIGHT), eager_bands()
        graph.load_state(pipeline.init_state(WIDTH, HEIGHT, dev))
        gap = 0.0
        for i, (u, fc, static_ok) in enumerate(seq):
            want1 = _words(one(u, fc, static_ok))
            out_e = bands(u, fc, static_ok)
            out_g = replay(u, fc, static_ok)
            for ref, against in ((_words(out_e), "eager bands"),
                                 (want1, "one-device frame")):
                for (n, a), (_, b) in zip(_words(out_g), ref):
                    g, same = _word_gap(torch, a, b)
                    gap = max(gap, g)
                    if not same:
                        raise AssertionError(
                            f"{TILE_BANDS} bands replayed on {what}, {name} "
                            f"frame {i}: {n} differs from the {against}' "
                            f"(max abs {g:.3g})")
            e_b, g_b = (o[3]["band_launches"] for o in (out_e, out_g))
            if e_b != g_b:
                raise AssertionError(f"replayed band launches {g_b}, eager "
                                     f"{e_b}")
            for b, band in enumerate(g_b):
                if min(band[k] for k in on) <= 0 or any(
                        band[k] for k in every if k not in on):
                    raise AssertionError(f"replayed band {b} must launch "
                                         f"{on} and no other kernel: {band}")
        gaps[name] = gap

    graph.load_state(pipeline.init_state(WIDTH, HEIGHT, dev))
    launched, graphs = _host_launches(torch, replay, seqs[0][1][:2])
    if graphs != TILE_BANDS * graph.segments or \
            launched - graphs > GRAPH_TILE_OTHER:
        raise AssertionError(
            f"{TILE_BANDS} bands replayed: {graphs:.0f} graph launches a "
            f"frame ({TILE_BANDS} x {graph.segments} expected) and "
            f"{launched - graphs:.0f} other launches (at most "
            f"{GRAPH_TILE_OTHER})")
    print(f"graph II: {TILE_BANDS} bands of {HEIGHT // TILE_BANDS} rows on "
          f"{what}, Cornell {WIDTH}x{HEIGHT}, {graph.segments} segments a "
          f"band, through TiledFrameGraph against the eager bands and the "
          f"one-device frames: ldr, hdr, every state word and rays "
          f"bit-equal on every frame (max abs {gaps}); replayed band "
          f"launches equal the eager bands'; a replayed frame under "
          f"torch.profiler: {graphs:.0f} graph launches, "
          f"{launched - graphs:.0f} other launches (at most "
          f"{GRAPH_TILE_OTHER})", flush=True)


def _tiled_app(root):
    """`python -m tpu_raytracer_torch --tiles 4` on 4 cards: the app's
    frames as replayed band graphs. Exit 0, K1, K2 and K7 launched."""
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_raytracer_torch", "--tiles",
         str(TILE_BANDS), f"--scale={APP_W}x{APP_H}", "--max-frames",
         str(APP_FRAMES), "--no-preview"],
        cwd=root, stdin=subprocess.DEVNULL, capture_output=True, text=True,
        timeout=600)
    if proc.returncode:
        raise AssertionError(f"the app with --tiles {TILE_BANDS} exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    tel = json.loads(proc.stdout.strip().splitlines()[-1])
    if min(tel["launches"][k] for k in ("closest_hit", "any_hit",
                                        "table_gather", *FRAME_SHADE)) <= 0:
        raise AssertionError(f"the app with --tiles {TILE_BANDS}: {tel}")
    print(f"graph II: python -m tpu_raytracer_torch --tiles {TILE_BANDS} "
          f"--scale={APP_W}x{APP_H}, {tel['frames']} frames on "
          f"{TILE_BANDS} cards: exit 0, launches {tel['launches']}",
          flush=True)


def _spied_stream(torch, scene, dev, inputs):
    """The stream restir._tap_stream hands the any-hit call in one eager
    batched frame (its inputs: uniform, frame_count, static_ok) from a
    fresh state: (o, d [3, 5R], t_min, t_max [5R] with the inactive lanes
    dead), as scene_trace hands it on."""
    from tpu_raytracer_torch.ops import restir

    render = _eager(scene, dev, WIDTH, HEIGHT, tap_batch=True)
    seen = []
    orig = restir._tap_stream

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen.append(out[1])
        return out
    restir._tap_stream = spy
    try:
        render(*inputs)
    finally:
        restir._tap_stream = orig
    if len(seen) != 1:
        raise AssertionError(f"the batched frame made {len(seen)} tap "
                             f"streams, not 1")
    st = seen[0]
    n = st["t_max"].shape[0]
    if n != restir.TAPS * WIDTH * HEIGHT:
        raise AssertionError(f"the tap stream has {n} lanes")
    return (torch.stack(list(st["o"])).contiguous(),
            torch.stack(list(st["d"])).contiguous(),
            torch.full((n,), 1e-3, device=dev),
            torch.where(st["active"], st["t_max"], 0.0).contiguous())


def _occlusion_check(torch, what, got, want, t_max):
    """Raise unless any-hit `got` flags exactly the lanes `want` does,
    with t = t_max."""
    bad = int(((got["tri"] >= 0) != want).sum())
    if bad:
        raise AssertionError(f"{what}: occlusion differs from plain on {bad} "
                             f"lanes")
    if not torch.equal(got["t"], t_max):
        raise AssertionError(f"{what}: t is not t_max")


def _tap_batch_phase(torch, dev, every):
    """27. batched spatial taps (ops/restir.py:_tap_stream, tap_batch):
    the Cornell frames eager and replayed in lockstep, the launches of
    the batched and the sequential frames, K2 on one frame's tap stream
    against plain; K3 and K4 on the knot's and the gallery's streams; 4
    bands against one device; the subdivided Cornell box."""
    from tpu_raytracer_torch.models import scenes
    from tpu_raytracer_torch.ops import (gbuffer, restir, trace_api,
                                         trace_inst, trace_stream)
    from tpu_raytracer_torch.parallel import tiles
    from tpu_raytracer_torch.render.graph import FrameGraph
    from tpu_raytracer_torch.utils.vec3 import V3

    scene = scenes.create_cornell_box(dev)
    seq = _camera_seq(dev, TAP_FRAMES, scene.num_lights)
    graph = FrameGraph(scene, WIDTH, HEIGHT, dev, tap_batch=True)
    gap = _lockstep(torch, _eager(scene, dev, WIDTH, HEIGHT, tap_batch=True),
                    _replay(graph), seq, "tap batch")
    render = _eager(scene, dev, WIDTH, HEIGHT, tap_batch=True)
    render(*seq[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        render(*seq[1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"tap batch: Cornell {WIDTH}x{HEIGHT}, {TAP_FRAMES} frames through "
          f"FrameGraph(tap_batch=True) against render_frame(tap_batch=True): "
          f"ldr, hdr, every state tensor and rays bit-equal on every frame "
          f"(max abs gap {gap:.3g}); eager frame 1 under "
          f"set_sync_debug_mode('error'): no host sync", flush=True)

    # the launches of batched replayed, sequential replayed and batched
    # eager frames; each graph captured before its counts are reset
    seq_graph = FrameGraph(scene, WIDTH, HEIGHT, dev)
    _lockstep(torch, _eager(scene, dev, WIDTH, HEIGHT), _replay(seq_graph),
              seq[:2], "sequential taps")
    runs = {}
    for what, render in (
            ("batched, replayed", _replay(graph)),
            ("sequential, replayed", _replay(seq_graph)),
            ("batched, eager", _eager(scene, dev, WIDTH, HEIGHT,
                                      tap_batch=True))):
        trace_api.reset_launch_counts()
        _run_seq(render, seq)
        runs[what] = dict(trace_api.LAUNCHES)
    b_launches, s_launches = (runs[k] for k in ("batched, replayed",
                                                "sequential, replayed"))
    # the batched taps keep the eager spatial reuse: no K11
    on = ["closest_hit", "any_hit", "table_gather", *FRAME_SHADE]
    b_on = [k for k in on if k not in SPATIAL_K11]
    if min(b_launches[k] for k in b_on) <= 0 or any(
            b_launches[k] for k in every if k not in b_on):
        raise AssertionError(f"the batched Cornell frames must launch {b_on} "
                             f"and no other kernel: {b_launches}")
    saved = s_launches["any_hit"] - b_launches["any_hit"]
    if saved != (restir.TAPS - 1) * TAP_FRAMES:
        raise AssertionError(f"K2 launches: {b_launches['any_hit']} batched "
                             f"against {s_launches['any_hit']} sequential "
                             f"over {TAP_FRAMES} frames")
    if runs["batched, replayed"] != runs["batched, eager"]:
        raise AssertionError(f"replayed batched frames launch "
                             f"{b_launches}; eager ones "
                             f"{runs['batched, eager']}")
    launched, graphs = _host_launches(torch, _replay(graph), seq[:2])
    if launched > 2:
        raise AssertionError(f"a replayed batched frame makes {launched} "
                             f"host launches (2 expected)")
    print(f"tap batch: Cornell {WIDTH}x{HEIGHT}, {TAP_FRAMES} frames: K2 "
          f"{restir.TAPS - 1} launches fewer a frame batched than "
          f"sequential, replayed launches equal to eager; a replayed "
          f"batched frame under torch.profiler: {launched:.0f} host launches "
          f"({graphs:.0f} graphs)", flush=True)
    del graph, seq_graph, render

    # K2 on one frame's tap stream against plain
    o, d, t_min, t_max = _spied_stream(torch, scene, dev, seq[0])
    n = t_max.shape[0]
    want = trace_api.trace_plain(scene.tri_planes, scene.chunk_aabb, V3(*o),
                                 V3(*d), t_min, t_max)["tri"] >= 0
    _occlusion_check(torch, "K2 on the tap stream", trace_api.trace_kernel(
        scene.tri_planes, scene.chunk_aabb, o, d, t_min, t_max,
        any_hit=True), want, t_max)
    print(f"tap batch: K2 on one Cornell frame's tap stream ({n} rays, "
          f"pixel-interleaved) equals plain closest-hit tri>=0 on every "
          f"lane, t = t_max", flush=True)

    # K3 and K4 on the knot's and the gallery's streams
    for what, build, kernel, plain_fn in (
            ("K3 (knot)", scenes.create_dense_knot_scene,
             lambda s, o, d, t0, t1: trace_stream.trace_stream_kernel(
                 s.tri_planes, s.chunk_aabb, o, d, t0, t1, any_hit=True),
             lambda s, o, d, t0, t1: trace_stream.trace_stream_plain(
                 s.tri_planes, s.chunk_aabb, V3(*o), V3(*d), t0, t1,
                 any_hit=True)),
            ("K4 (gallery)", scenes.create_instancing_gallery_scene,
             lambda s, o, d, t0, t1: trace_inst.trace_instanced_kernel(
                 s.tri_planes, s.obj_group_aabb, s.inst_table, s.inst_aabb,
                 s.inst_group_span, o, d, t0, t1, any_hit=True),
             lambda s, o, d, t0, t1: trace_inst.trace_instanced_plain(
                 s.tri_planes, s.obj_group_aabb, s.inst_table, s.inst_aabb,
                 s.unit_inst, s.unit_group, V3(*o), V3(*d), t0, t1))):
        s = build(dev)
        stream = _spied_stream(torch, s, dev,
                               _camera_seq(dev, 1, s.num_lights)[0])
        got = kernel(s, *stream)
        want = plain_fn(s, *stream)["tri"] >= 0
        _occlusion_check(torch, f"{what} on the tap stream", got, want,
                         stream[3])
        print(f"tap batch: {what} any-hit on one frame's tap stream "
              f"({stream[3].shape[0]} rays) equals plain on every lane, t = "
              f"t_max", flush=True)
        del s, stream, got, want

    # 4 bands of this card against the one-device batched frames
    mesh = tiles.make_mesh([dev] * TILE_BANDS)
    bands = tiles.TiledFrameGraph(mesh, tiles.replicate(scene, mesh), WIDTH,
                                  HEIGHT, tap_batch=True)
    one = _eager(scene, dev, WIDTH, HEIGHT, tap_batch=True)
    b_gap = 0.0
    for i, inputs in enumerate(seq[:TAP_BAND_FRAMES]):
        ldr, hdr, state, aux = bands(*inputs)
        got = _words((ldr, hdr, tiles.gather_state(state), aux))
        for (name, a), (_, b) in zip(got, _words(one(*inputs))):
            g, same = _word_gap(torch, a, b)
            b_gap = max(b_gap, g)
            if not same:
                raise AssertionError(f"{TILE_BANDS} batched bands, frame "
                                     f"{i}: {name} differs from the "
                                     f"one-device frame's (max abs {g:.3g})")
    print(f"tap batch: {TILE_BANDS} bands of {HEIGHT // TILE_BANDS} rows "
          f"through TiledFrameGraph(tap_batch=True) against the one-device "
          f"batched frames, {TAP_BAND_FRAMES} frames: every word equal (max "
          f"abs {b_gap:.3g})", flush=True)
    del bands, one

    # the subdivided Cornell box
    split = scenes.create_cornell_box(dev, subdivide_max_diag=SUBDIV_DIAG)
    n_tri = int(split.tri_planes[3, 0].sum())
    chunks = split.chunk_aabb.shape[0]
    if not n_tri > scene.num_triangles or chunks <= scene.chunk_aabb.shape[0]:
        raise AssertionError(f"the subdivided box has {n_tri} triangles in "
                             f"{chunks} chunks")
    u = seq[0][0]
    po, pd = gbuffer.generate_primary_rays(u, WIDTH, HEIGHT)
    po, pd = (torch.stack(list(x)).contiguous() for x in (po, pd))
    t_lo = torch.full((po.shape[1],), 1e-3, device=dev)
    t_hi = torch.full((po.shape[1],), 1000.0, device=dev)
    want = trace_api.trace_plain(split.tri_planes, split.chunk_aabb, V3(*po),
                                 V3(*pd), t_lo, t_hi)
    got = trace_api.trace_kernel(split.tri_planes, split.chunk_aabb, po, pd,
                                 t_lo, t_hi)
    ulps = _check_closest("K1 on the subdivided box", got, want)
    if ulps:
        raise AssertionError(f"K1 on the subdivided box: t differs from "
                             f"plain by {ulps} ulps")
    _occlusion_check(torch, "K2 on the subdivided box", trace_api.trace_kernel(
        split.tri_planes, split.chunk_aabb, po, pd, t_lo, t_hi,
        any_hit=True), want["tri"] >= 0, t_hi)
    s_graph = FrameGraph(split, WIDTH, HEIGHT, dev)
    s_seq = _camera_seq(dev, SUBDIV_FRAMES, split.num_lights)
    _lockstep(torch, _eager(split, dev, WIDTH, HEIGHT), _replay(s_graph),
              s_seq[:2], "subdivided Cornell")
    trace_api.reset_launch_counts()
    _run_seq(_replay(s_graph), s_seq)
    sub_launches = dict(trace_api.LAUNCHES)
    if min(sub_launches[k] for k in on) <= 0 or any(
            sub_launches[k] for k in every if k not in on):
        raise AssertionError(f"the subdivided Cornell frames must launch {on} "
                             f"and no other kernel: {sub_launches}")
    print(f"tap batch: subdivided Cornell (subdivide_max_diag={SUBDIV_DIAG}):"
          f" {n_tri} triangles in {chunks} chunks (unsplit "
          f"{scene.num_triangles} in {scene.chunk_aabb.shape[0]}); K1 on its "
          f"{po.shape[1]} primary rays tri equal on every lane and t "
          f"bit-equal to plain, K2 occlusion equal; {SUBDIV_FRAMES} replayed "
          f"frames, {on} launched and no other kernel", flush=True)


def _band(scene, dev, width, height, reorder):
    """render(uniform, fc, static_ok): render_band's eager frames with
    restir.make_ctx(reorder=), from a fresh state, each frame's state
    carried to the next: the way a caller reaches the knob."""
    from tpu_raytracer_torch.ops import restir
    from tpu_raytracer_torch.parallel import views
    from tpu_raytracer_torch.render import pipeline

    ctx = restir.make_ctx(width, height, dev, reorder=reorder)
    state = pipeline.init_state(width, height, dev)

    def view(flat):
        return views.trivial_view(flat, width, height)

    def render(uniform, fc, static_ok):
        nonlocal state
        out = pipeline.render_band(scene, uniform, fc, state, ctx, view,
                                   static_ok=static_ok)
        state = out[2]
        return out

    return render


def _word_diff(torch, got, want):
    """(words that differ, max abs gap) of two frames' _words."""
    diff, gap = 0, 0.0
    for (name, a), (_, b) in zip(_words(got), _words(want)):
        g, _ = _word_gap(torch, a, b)
        gap = max(gap, g)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        diff += int((a != b).sum())
    return diff, gap


def _mode_frames(torch, scene, dev, seq, what, on, every):
    """seq's frames through _band under each of REORDER_MODES: per mode
    the frames' outputs; raises where a mode launches a kernel outside
    `on` or leaves one of `on` out."""
    from tpu_raytracer_torch.ops import trace_api

    runs, on = {}, [*on, *FRAME_SHADE]
    for m in REORDER_MODES:
        render = _band(scene, dev, WIDTH, HEIGHT, m)
        trace_api.reset_launch_counts()
        runs[m] = [render(*inputs) for inputs in seq]
        launched = dict(trace_api.LAUNCHES)
        if min(launched[k] for k in on) <= 0 or any(
                launched[k] for k in every if k not in on):
            raise AssertionError(f"{what} reorder={m}: want {on} launched "
                                 f"and no other kernel: {launched}")
    return runs


def _recorded_streams(torch, scene, dev, seq):
    """The streams the eager Cornell frame seq[1] (after seq[0]) hands
    its queries, in order, spied where scene_trace hands them to their
    route: per query (route, any_hit, o [3, R], d [3, R], t_min, t_max
    with the dead lanes at 0)."""
    from tpu_raytracer_torch.ops import trace_api

    render = _band(scene, dev, WIDTH, HEIGHT, "none")
    render(*seq[0])
    seen = []
    orig = trace_api._route

    def spy(sc, name, grp, passes, any_hit, o, d, t_min, t_max):
        seen.append((name, any_hit, torch.stack(list(o)).contiguous(),
                     torch.stack(list(d)).contiguous(), t_min.contiguous(),
                     t_max.contiguous()))
        return orig(sc, name, grp, passes, any_hit, o, d, t_min, t_max)
    trace_api._route = spy
    try:
        render(*seq[1])
    finally:
        trace_api._route = orig
    if [q[1] for q in seen[:10]] != [False] * 8 + [True] * 2:
        raise AssertionError(f"the frame's queries: "
                             f"{[(q[0], q[1]) for q in seen]}")
    return seen


def _stream_checks(torch, scene, mxu_scene, streams):
    """REORDER_STREAMS through K1/K2, K5 and K6 under each mode, each
    restored result held to "none": K1/K2/K5 every word equal, K6 at most
    2 x PLAIN_DIFF words differing."""
    from tpu_raytracer_torch.ops import compaction, trace_api, trace_mxu
    from tpu_raytracer_torch.ops import trace_vpu

    planes, boxes = scene.tri_planes, scene.chunk_aabb
    for label, i in REORDER_STREAMS:
        _, any_hit, o, d, t_min, t_max = streams[i]
        n = t_max.shape[0]
        base, k6_diff = {}, {}
        for m in REORDER_MODES:
            if m == "none":
                src = dest = torch.arange(n, device=o.device)
            else:
                src, dest = compaction.permutation(m, tuple(d), t_max)
            po, pd = o[:, src].contiguous(), d[:, src].contiguous()
            p0, p1 = t_min[src].contiguous(), t_max[src].contiguous()
            got = {"k": trace_api.trace_kernel(planes, boxes, po, pd, p0, p1,
                                               any_hit=any_hit),
                   "k5": trace_vpu.vpu_kernel(planes, boxes, po, pd, p0, p1)}
            if not any_hit:
                got["k6"] = trace_mxu.mxu_kernel(mxu_scene.coef48_t, boxes,
                                                 po, pd, p0, p1, 1, 3, False,
                                                 False)
            got = {key: {f: v[dest] for f, v in r.items()}
                   for key, r in got.items()}
            if m == "none":
                base = got
            for key, r in got.items():
                if key == "k6":
                    k6_diff[m] = int(
                        ((r["tri"] >= 0) != (base[key]["tri"] >= 0)).sum()
                        + (r["tri"] != base[key]["tri"]).sum()
                        + (r["t"].view(torch.int32)
                           != base[key]["t"].view(torch.int32)).sum())
                    if k6_diff[m] > 2 * PLAIN_DIFF:
                        raise AssertionError(f"K6 on {label} reorder={m}: "
                                             f"{k6_diff[m]} words differ "
                                             f"from none")
                    continue
                want = base["k"]
                if key == "k5" and any_hit:
                    same = torch.equal(r["tri"] >= 0, want["tri"] >= 0)
                else:
                    same = torch.equal(r["tri"], want["tri"]) and \
                        torch.equal(r["t"].view(torch.int32),
                                    want["t"].view(torch.int32))
                if not same:
                    raise AssertionError(f"{key} on {label} reorder={m}: "
                                         f"the restored result differs from "
                                         f"K1/K2's in order")
        print(f"reorder: {label} ({n} rays, {'any' if any_hit else 'closest'}"
              f" hit): K{'2' if any_hit else '1'} and K5 restored results "
              f"equal to none's under {REORDER_MODES[1:]}"
              + (f", K6 words differing {k6_diff}" if k6_diff else ""),
              flush=True)


def _captured_band(torch, scene, dev, seq):
    """One render_band call with a "bins" ctx captured in a CUDA graph:
    the eager call and the capture under set_sync_debug_mode("error"),
    the replay held to the eager call word for word. Returns (the
    capture's launches, max abs gap)."""
    from tpu_raytracer_torch.ops import restir, trace_api
    from tpu_raytracer_torch.parallel import views
    from tpu_raytracer_torch.render import pipeline

    ctx = restir.make_ctx(WIDTH, HEIGHT, dev, reorder="bins")
    render = _band(scene, dev, WIDTH, HEIGHT, "bins")
    state0 = {k: v.clone() for k, v in render(*seq[0])[2].items()}
    u = seq[1][0]
    fc = torch.tensor(seq[1][1], dtype=torch.int64, device=dev)

    def view(flat):
        return views.trivial_view(flat, WIDTH, HEIGHT)

    def call(state):
        return pipeline.render_band(scene, u, fc, state, ctx, view,
                                    static_ok=True)

    torch.cuda.synchronize()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        call({k: v.clone() for k, v in state0.items()})
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize()
    static = {k: v.clone() for k, v in state0.items()}
    graph = torch.cuda.CUDAGraph()
    torch.cuda.set_sync_debug_mode("error")
    try:
        want = call({k: v.clone() for k, v in state0.items()})
        with trace_api.captured_launches() as launched:
            with torch.cuda.graph(graph):
                got = call(static)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launched = dict(launched)
    graph.replay()
    torch.cuda.synchronize()
    diff, gap = _word_diff(torch, got, want)
    if diff:
        raise AssertionError(f"the captured bins frame differs from the "
                             f"eager one in {diff} words (max abs {gap:.3g})")
    del graph
    return launched, gap


def _reorder_phase(torch, dev, every):
    """28. the ray-stream reorder: make_ctx(reorder=) through render_band
    on the Cornell box (K1, K2), under vpu (K5) and mxu3 (K6), on the
    knot (K3); one frame's streams through K1/K2, K5 and K6 under each
    mode; a captured "bins" frame."""
    from tpu_raytracer_torch.models import scenes

    scene = scenes.create_cornell_box(dev)
    seq = _camera_seq(dev, REORDER_FRAMES, scene.num_lights)
    on = ["closest_hit", "any_hit", "table_gather"]
    runs = _mode_frames(torch, scene, dev, seq, "Cornell", on, every)
    for m in REORDER_MODES:
        for i, (g, w) in enumerate(zip(runs[m], runs["none"])):
            diff, gap = _word_diff(torch, g, w)
            if diff:
                raise AssertionError(f"Cornell reorder={m} frame {i}: {diff} "
                                     f"words differ from none (max abs "
                                     f"{gap:.3g})")
    print(f"reorder: Cornell {WIDTH}x{HEIGHT} through render_band with "
          f"make_ctx(reorder=m), m in {REORDER_MODES}, {REORDER_FRAMES} eager "
          f"frames a mode: every word equal to none's, {on} launched and no "
          f"other trace kernel", flush=True)
    del runs

    # one frame a mode on K5 (vpu), K3 (the knot) and K6 (mxu3)
    mxu_scene = scenes.create_cornell_box(dev, kernel="mxu3")
    for what, build, kernels, exact in (
            ("Cornell vpu (K5)",
             lambda: scenes.create_cornell_box(dev, kernel="vpu"),
             ["vpu_closest_hit", "table_gather"], True),
            ("knot (K3)", lambda: scenes.create_dense_knot_scene(dev),
             ["stream_closest_hit", "stream_any_hit", "table_gather"], True),
            ("Cornell mxu3 (K6)", lambda: mxu_scene,
             ["mxu_closest_hit", "any_hit", "table_gather"], False)):
        s = build()
        one = _camera_seq(dev, 1, s.num_lights)
        runs = _mode_frames(torch, s, dev, one, what, kernels, every)
        if exact:
            for m in ("live", "bins"):
                diff, gap = _word_diff(torch, runs[m][0], runs["none"][0])
                if diff:
                    raise AssertionError(f"{what} reorder={m}: {diff} words "
                                         f"differ from none (max abs "
                                         f"{gap:.3g})")
        print(f"reorder: {what} {WIDTH}x{HEIGHT}, 1 eager frame a mode: "
              f"{kernels} launched and no other trace kernel"
              + ("; every word equal to none's" if exact else ""),
              flush=True)
        del s, runs

    # one frame's streams: the kernels a mode
    streams = _recorded_streams(torch, scene, dev, seq)
    _stream_checks(torch, scene, mxu_scene, streams)
    del streams

    # the captured bins frame
    launched, gap = _captured_band(torch, scene, dev, seq)
    print(f"reorder: one render_band call with make_ctx(reorder='bins') "
          f"captured in a CUDA graph under set_sync_debug_mode('error') "
          f"(launches recorded {launched['closest_hit']} K1, "
          f"{launched['any_hit']} K2, {launched['table_gather']} K7); its "
          f"replay equals the eager call in every word (max abs {gap:.3g})",
          flush=True)


PATH_K9 = ("path_prime", "path_bounce", "path_finish")
SPATIAL_K11 = ("spatial_tap", "spatial_close", "spatial_finish")
# the shading kernels of every ReSTIR frame: K9's, K10 ("post") and K11's
# (every frame of sequential spatial taps, the default)
FRAME_SHADE = (*PATH_K9, "post", *SPATIAL_K11)
PATH_SIZES = ((1280, 720),)
# K9's launches a trace_path call, by kind
K9_CALL = {"path_prime": 1, "path_bounce": 7, "path_finish": 1}


def _spied_path_calls(torch, scene, dev, width, height, frames):
    """The trace_path calls (the temporal candidates, then the spatial
    replay) of the last of `frames` eager ReSTIR frames of `scene` at
    width x height (static_ok from the second frame on), each as
    (gb, view_pos, seed, active, reorder) with its tensors cloned."""
    from tpu_raytracer_torch.ops import path_trace
    from tpu_raytracer_torch.render import camera, pipeline, renderer

    real, calls = path_trace.trace_path, []

    def spy(scene_, gb, view_pos, seed, active=None, reorder="none"):
        calls.append(({k: v.clone() for k, v in gb.items()},
                      view_pos.clone(), seed.clone(),
                      None if active is None else active.clone(), reorder))
        return real(scene_, gb, view_pos, seed, active, reorder)

    cam = camera.CameraController()
    state = pipeline.init_state(width, height, dev)
    path_trace.trace_path = spy
    try:
        for i in range(frames):
            calls.clear()
            uniform = renderer.camera_to_device(
                cam.uniform(width / height, i, scene.num_lights), dev)
            _, _, state, _ = pipeline.render_frame(
                scene, uniform, i, state, width, height, static_ok=i > 0)
    finally:
        path_trace.trace_path = real
    torch.cuda.synchronize()
    return calls


def _k9_queries(torch, scene, call):
    """K9's call with its queries counted: (outputs, the scene_trace
    calls it made)."""
    from tpu_raytracer_torch.ops import path_trace

    real, queries = path_trace.scene_trace, []

    def spy(*args, **kw):
        queries.append(1)
        return real(*args, **kw)

    path_trace.scene_trace = spy
    try:
        out = path_trace.trace_path_kernel(scene, *call)
        torch.cuda.synchronize()
    finally:
        path_trace.scene_trace = real
    return out, len(queries)


def _k9_diff(torch, got, want):
    """Per output: (lanes equal in every word, lanes, max abs difference,
    max ulps)."""
    out = {}
    for k in ("radiance", "v1_pos", "v1_normal", "state", "valid_v1"):
        a, b = got[k], want[k]
        if a.dtype == torch.float32:
            bits_a, bits_b = a.view(torch.int32), b.view(torch.int32)
            same = (bits_a == bits_b) | (a == b)
            lanes = same.reshape(a.shape[0], -1).all(-1)
            err = float((a - b).abs().max()) if a.numel() else 0.0
            ulps = _ulps(a.cpu().numpy(), b.cpu().numpy())
            ulps = int(np.abs(ulps).max()) if ulps.size else 0
        else:
            lanes, err, ulps = a == b, 0.0, 0
        out[k] = (int(lanes.sum()), a.shape[0], err, ulps)
    return out


def _path_kernel_phase(torch, dev):
    """29. K9, the path tracer's shading (csrc/path_trace.cu), against the
    eager route on the card: both trace_path calls of a Cornell and a
    knot ReSTIR frame at 1280x720 (spied, the second frame's), through
    trace_path_kernel and trace_path_plain on the same CUDA inputs; its
    queries a call; only K9, the trace kernels and the stage mark in a
    call's device trace; launches a frame."""
    import re

    from tpu_raytracer_torch.models import scenes
    from tpu_raytracer_torch.ops import path_trace, trace_api
    from tpu_raytracer_torch.render import camera, pipeline, renderer

    trace_names = re.compile(r"\b(closest_hit|any_hit|stream|inst|vpu|mxu|"
                             r"bvh)_kernel\b")
    for what, make in (("Cornell", lambda: scenes.create_cornell_box(dev)),
                       ("knot", lambda: scenes.create_dense_knot_scene(dev))):
        scene = make()
        for width, height in PATH_SIZES:
            r = width * height
            calls = _spied_path_calls(torch, scene, dev, width, height, 2)
            if len(calls) != 2:
                raise AssertionError(f"{what}: {len(calls)} trace_path "
                                     f"calls in a frame, want 2")
            for name, call in zip(("candidates", "spatial replay"), calls):
                got, queries = _k9_queries(torch, scene, call)
                want = path_trace.trace_path_plain(scene, *call)
                torch.cuda.synchronize()
                diff = _k9_diff(torch, got, want)
                if diff["state"][0] != r or diff["valid_v1"][0] != r:
                    raise AssertionError(f"K9 {what} {name}: state / "
                                         f"valid_v1 differ: {diff}")
                if float(got["rays"]) != float(want["rays"]):
                    raise AssertionError(f"K9 {what} {name}: rays "
                                         f"{float(got['rays'])} against "
                                         f"{float(want['rays'])}")
                for k in ("radiance", "v1_pos", "v1_normal"):
                    if diff[k][0] != r:
                        raise AssertionError(f"K9 {what} {name}: {k} "
                                             f"bit-equal on {diff[k][0]} of "
                                             f"{r} lanes (max abs "
                                             f"{diff[k][2]:.3g}, "
                                             f"{diff[k][3]} ulps)")
                if queries != path_trace.MAX_DEPTH - (scene.num_lights == 0):
                    raise AssertionError(f"K9 made {queries} queries")

                # one call under the profiler: only K9, the trace kernels
                # and the stage mark; a session that drops events reads
                # too few K9 launches
                seen, other = dict.fromkeys(PATH_K9, 0), []
                for key, count in _device_ops(torch, lambda: path_trace
                                              .trace_path(scene,
                                                          *call)).items():
                    kind = next((k for k in PATH_K9 if k in key), None)
                    if kind:
                        seen[kind] += count
                    elif not (trace_names.search(key)
                              or "tpurt_mark_" in key):
                        other.append(key)
                if other:
                    raise AssertionError(f"K9 {what} {name}: a trace_path "
                                         f"call ran other device work: "
                                         f"{other}")
                if seen != K9_CALL:
                    raise AssertionError(f"K9 {what} {name}: the profile "
                                         f"holds {seen} launches, want "
                                         f"{K9_CALL}")
                print(f"K9 {what} {width}x{height} {name}: state and "
                      f"valid_v1 equal on {r} of {r} lanes, rays "
                      f"{float(got['rays']):.0f} equal; radiance, v1_pos and "
                      f"v1_normal bit-equal on every lane; {queries} queries; "
                      f"a call's device trace holds {seen} and no other "
                      f"device work", flush=True)

        # launches a frame of the eager frames
        cam = camera.CameraController()
        state = pipeline.init_state(*PATH_SIZES[0], dev)
        trace_api.reset_launch_counts()
        for i in range(2):
            uniform = renderer.camera_to_device(
                cam.uniform(PATH_SIZES[0][0] / PATH_SIZES[0][1], i,
                            scene.num_lights), dev)
            _, _, state, _ = pipeline.render_frame(
                scene, uniform, i, state, *PATH_SIZES[0], static_ok=i > 0)
        torch.cuda.synchronize()
        per_frame = {k: trace_api.LAUNCHES[k] / 2 for k in PATH_K9}
        if per_frame != {k: 2 * n for k, n in K9_CALL.items()}:
            raise AssertionError(f"K9 launches a {what} frame: {per_frame}")
        print(f"K9 {what}: {sum(per_frame.values()):.0f} launches a frame "
              f"{per_frame}", flush=True)


# 30. K10, the post pass (csrc/post.cu): the one-card cells' frame sizes
# and the bands cell's split
POST_SIZES = ((1280, 720), (1920, 1080))
POST_BANDS, POST_HALO = 4, 16


def _live_call(torch, module, name, scene, dev, width, height, frames,
               move=False):
    """The arguments of `module.name`'s call (post.post_process,
    restir.restir_spatial) in the last of `frames` eager ReSTIR frames of
    `scene` at width x height, live: a still camera with the counter at
    the frame's index, static_ok and gb_reuse from the second frame on, as
    the app renders; with `move`, a camera moving each frame (the counter
    0, as the app resets it)."""
    from tpu_raytracer_torch.render import camera, pipeline, renderer

    real, calls = getattr(module, name), []

    def spy(*args):
        calls[:] = [args]
        return real(*args)

    cam = camera.CameraController()
    state = pipeline.init_state(width, height, dev)
    setattr(module, name, spy)
    try:
        for i in range(frames):
            fc = 0 if move else i
            if move:
                cam.press("d")
                cam.update(0.05)
                cam.release("d")
            uniform = renderer.camera_to_device(
                cam.uniform(width / height, fc, scene.num_lights), dev)
            _, _, state, _ = pipeline.render_frame(
                scene, uniform, fc, state, width, height, static_ok=fc > 0,
                gb_reuse=True)
    finally:
        setattr(module, name, real)
    torch.cuda.synchronize()
    return calls[0]


def _band_view(view, ctx, band):
    """The BandView halo_exchange gives band `band` of POST_BANDS, halo
    POST_HALO, of a one-device view (zero rows outside the image)."""
    from tpu_raytracer_torch.parallel.views import BandView

    width, height = ctx["width"], ctx["height"]
    band_h = height // POST_BANDS
    y0 = band * band_h
    rows = view.data.reshape(height, width, -1)
    ext = rows.new_zeros((band_h + 2 * POST_HALO, width, rows.shape[2]))
    lo, hi = max(y0 - POST_HALO, 0), min(y0 + band_h + POST_HALO, height)
    ext[lo - y0 + POST_HALO:hi - y0 + POST_HALO] = rows[lo:hi]
    return BandView(ext.reshape(-1, rows.shape[2]), y0, width, height,
                    band_h, POST_HALO)


def _post_band(torch, args, band):
    """The post_process arguments of band `band` of POST_BANDS, halo
    POST_HALO, cut from a one-device call's: the views halo_exchange
    gives, the band's motion rows."""
    hdr_view, gb, gb_view, hist_view, fc, ctx = args
    band_h = ctx["height"] // POST_BANDS
    own = slice(band * band_h * ctx["width"],
                (band + 1) * band_h * ctx["width"])
    return (_band_view(hdr_view, ctx, band), {"motion": gb["motion"][own]},
            _band_view(gb_view, ctx, band), _band_view(hist_view, ctx, band),
            fc, dict(ctx, y0=band * band_h, band_h=band_h))


def _k10_diff(torch, got, want):
    """Per output (ldr, accum): (words equal, words, max abs difference,
    max ulps)."""
    out = []
    for a, b in zip(got, want):
        same = a.view(torch.int32) == b.view(torch.int32)
        err = float((a - b).abs().max())
        ulps = int(np.abs(_ulps(a.cpu().numpy(), b.cpu().numpy())).max())
        out.append((int(same.sum()), a.numel(), err, ulps))
    return out


def _post_kernel_phase(torch, dev):
    """30. K10, the post pass (csrc/post.cu), against the eager route
    (post_process_plain on the card) on live frame inputs: a Cornell and a
    truffle 1280x720 still frame, a Cornell 1920x1080 frame under a moving
    camera (as rendered, counter 0, and with the counter at 5, so the
    clipped-history branch runs), and every band of a 4-band split (halo
    16) of the Cornell still and the moving frame; every word of ldr and
    accum. The bands' K10 words against the one-device call's on the
    still frame; a call's device trace holds K10 alone; "post" launches a
    replayed frame, one device and 4 bands."""
    from tpu_raytracer_torch.app import interactive
    from tpu_raytracer_torch.models import scenes
    from tpu_raytracer_torch.ops import post, trace_api
    from tpu_raytracer_torch.parallel import tiles
    from tpu_raytracer_torch.render import graph as graph_mod
    from tpu_raytracer_torch.render import pipeline

    cornell = scenes.create_cornell_box(dev)
    truffle = interactive.load_scene("truffle", dev)
    (w1, h1), (w2, h2) = POST_SIZES
    still = _live_call(torch, post, "post_process", cornell, dev, w1, h1, 4)
    moving = _live_call(torch, post, "post_process", cornell, dev, w2, h2, 3,
                        move=True)
    cases = [("Cornell still", still),
             ("truffle still", _live_call(torch, post, "post_process",
                                          truffle, dev, w1, h1, 4)),
             ("Cornell moving", moving),
             ("Cornell moving, counter 5", moving[:4] + (5,) + moving[5:])]
    cases += [(f"Cornell still, band {b} of {POST_BANDS}",
               _post_band(torch, still, b)) for b in range(POST_BANDS)]
    cases += [(f"Cornell moving, counter 5, band {b} of {POST_BANDS}",
               _post_band(torch, cases[3][1], b)) for b in range(POST_BANDS)]
    outs = {}
    for what, args in cases:
        trace_api.reset_launch_counts()
        got = post.post_process(*args)
        torch.cuda.synchronize()
        if trace_api.LAUNCHES["post"] != 1:
            raise AssertionError(f"K10 {what}: post_process launched "
                                 f"{trace_api.LAUNCHES['post']} K10")
        want = post.post_process_plain(*args)
        torch.cuda.synchronize()
        outs[what] = got
        diff = _k10_diff(torch, got, want)
        line = "; ".join(f"{k} {d[0]} of {d[1]} words equal (max abs "
                         f"{d[2]:.3g}, {d[3]} ulps)"
                         for k, d in zip(("ldr", "accum"), diff))
        if any(d[0] != d[1] for d in diff):
            raise AssertionError(f"K10 {what}: {line}")
        print(f"K10 {what}: {line}", flush=True)

    # the first case's call under the profiler: K10 alone
    kernels = _device_ops(torch, lambda: post.post_process(*cases[0][1]))
    if list(kernels.values()) != [1] or "post_pass" not in next(iter(kernels)):
        raise AssertionError(f"K10 {cases[0][0]}: a post_process call ran "
                             f"{kernels} on the card")
    print(f"K10: the device trace of a post_process call holds {kernels} "
          f"alone", flush=True)

    # the still frame's bands, put together, are the one-device call's
    for k in (0, 1):
        bands = torch.cat([outs[f"Cornell still, band {b} of {POST_BANDS}"]
                           [k] for b in range(POST_BANDS)])
        if not torch.equal(bands.view(torch.int32),
                           outs["Cornell still"][k].view(torch.int32)):
            raise AssertionError("K10's 4 bands of the still frame differ "
                                 "from its one-device call")
    print(f"K10: the still frame's {POST_BANDS} bands put together equal "
          f"its one-device call in every ldr and accum word", flush=True)

    # "post" launches a replayed frame: one device, then 4 bands
    seq = _camera_seq(dev, 6, cornell.num_lights)
    one = graph_mod.FrameGraph(cornell, w1, h1, dev)
    mesh = tiles.make_mesh([DEVICE] * POST_BANDS)
    banded = tiles.TiledFrameGraph(mesh, tiles.replicate(cornell, mesh), w1,
                                   h1)
    banded.load_state(pipeline.init_state(w1, h1, dev))
    per_frame = []
    for render in (lambda u, fc, st: one(u, fc, st, gb_reuse=True),
                   lambda u, fc, st: banded(u, fc, st)):
        for u, fc, st in seq[:4]:
            render(u, fc, st)
        trace_api.reset_launch_counts()
        for u, fc, st in seq[4:]:
            render(u, fc, st)
        torch.cuda.synchronize()
        per_frame.append(trace_api.LAUNCHES["post"] / (len(seq) - 4))
    if per_frame != [1, POST_BANDS]:
        raise AssertionError(f"K10 launches a replayed frame {per_frame}, "
                             f"want [1, {POST_BANDS}]")
    print(f"K10: {per_frame[0]:.0f} launch a replayed one-device frame, "
          f"{per_frame[1]:.0f} a replayed frame of {POST_BANDS} bands",
          flush=True)


# 31. K11, ReSTIR's spatial reuse (csrc/spatial.cu): the one-card cells'
# frame sizes and the bands cell's split (POST_SIZES, POST_BANDS,
# POST_HALO), its launches a call, and the other device operations a call
# may make: each tap any-hit call's two fills, its mask's where and its
# answer's compare (ops/trace_api.py:scene_trace, scene_occluded; measured
# on the card)
K11_CALL = {"spatial_tap": 5, "spatial_close": 1, "spatial_finish": 1}
SPATIAL_EAGER = 4 * 5


def _spatial_band(torch, args, band):
    """The restir_spatial arguments of band `band` of POST_BANDS, halo
    POST_HALO, cut from a one-device call's: the comb view halo_exchange
    gives, the band's G-buffer and reservoir rows."""
    from tpu_raytracer_torch.utils.vec3 import V3

    scene, gb, view, res, cam, fc, ctx = args
    band_h = ctx["height"] // POST_BANDS
    own = slice(band * band_h * ctx["width"],
                (band + 1) * band_h * ctx["width"])

    def cut(x):
        return V3(*(c[own] for c in x)) if isinstance(x, V3) else x[own]
    return (scene, {k: cut(x) for k, x in gb.items()},
            _band_view(view, ctx, band), {k: cut(x) for k, x in res.items()},
            cam, fc, dict(ctx, y0=band * band_h, band_h=band_h))


def _spatial_words(out):
    """restir_spatial's outputs as {name: tensor}."""
    res, hdr, rays, diag = out
    words = {}
    for k, v in res.items():
        if isinstance(v, tuple):
            words.update((f"{k}.{c}", x) for c, x in zip("xyz", v))
        else:
            words[k] = v
    return {**words, "hdr": hdr, "rays": rays, **diag}


def _k11_diff(torch, got, want):
    """Per output: (words equal, words, max abs difference)."""
    out, want = {}, _spatial_words(want)
    for name, a in _spatial_words(got).items():
        b = want[name]
        if a.dtype == torch.float32:
            same = a.view(torch.int32) == b.view(torch.int32)
        else:
            same = a == b
        err = float((a.double() - b.double()).abs().max()) \
            if a.numel() else 0.0
        out[name] = (int(same.sum()), a.numel(), err)
    return out


def _spatial_kernel_phase(torch, dev):
    """31. K11, ReSTIR's spatial reuse (csrc/spatial.cu), against the eager
    route (restir_spatial_plain on the card) on live frame inputs: a
    Cornell and a truffle 1280x720 still frame, a Cornell 1920x1080 frame
    under a moving camera (as rendered, counter 0, and with the counter
    at 5), and every band of a 4-band split (halo 16) of the Cornell still
    frame; every output word. The bands' K11 words against the
    one-device call's; a call's device trace; K11 launches a replayed
    frame, one device and 4 bands."""
    import re

    from tpu_raytracer_torch.app import interactive
    from tpu_raytracer_torch.models import scenes
    from tpu_raytracer_torch.ops import restir, trace_api
    from tpu_raytracer_torch.parallel import tiles
    from tpu_raytracer_torch.render import graph as graph_mod
    from tpu_raytracer_torch.render import pipeline

    cornell = scenes.create_cornell_box(dev)
    truffle = interactive.load_scene("truffle", dev)
    (w1, h1), (w2, h2) = POST_SIZES
    still = _live_call(torch, restir, "restir_spatial", cornell, dev, w1, h1,
                       4)
    moving = _live_call(torch, restir, "restir_spatial", cornell, dev, w2, h2,
                        3, move=True)
    bands = [f"Cornell still, band {b} of {POST_BANDS}"
             for b in range(POST_BANDS)]
    cases = [("Cornell still", still),
             ("truffle still", _live_call(torch, restir, "restir_spatial",
                                          truffle, dev, w1, h1, 4)),
             ("Cornell moving", moving),
             ("Cornell moving, counter 5", moving[:5] + (5,) + moving[6:])]
    cases += [(name, _spatial_band(torch, still, b))
              for b, name in enumerate(bands)]
    outs = {}
    for what, args in cases:
        trace_api.reset_launch_counts()
        got = restir.restir_spatial(*args)
        torch.cuda.synchronize()
        launched = {k: trace_api.LAUNCHES[k] for k in K11_CALL}
        if launched != K11_CALL:
            raise AssertionError(f"K11 {what}: restir_spatial launched "
                                 f"{launched}, want {K11_CALL}")
        want = restir.restir_spatial_plain(*args)
        torch.cuda.synchronize()
        outs[what] = _spatial_words(got)
        diff = _k11_diff(torch, got, want)
        bad = {k: d for k, d in diff.items() if d[0] != d[1]}
        if bad:
            raise AssertionError(f"K11 {what}: words differ from the eager "
                                 f"route's (equal, words, max abs): {bad}")
        print(f"K11 {what}: every word of {list(diff)} equal "
              f"({sum(d[1] for d in diff.values())} words; rays "
              f"{float(got[2]):.0f}, cached {float(got[3]['cached']):.0f} "
              f"of {float(got[3]['lanes']):.0f} lanes)", flush=True)

    # the still frame's bands, put together, are the one-device call's;
    # their counts add up to its
    for name, whole in outs["Cornell still"].items():
        parts = [outs[b][name] for b in bands]
        if name == "rays":      # each an f32 sum, rounded past 2^24
            continue
        if name in ("cached", "lanes"):
            same = float(sum(p.double() for p in parts)) == float(whole)
        elif whole.dtype == torch.float32:
            same = torch.equal(torch.cat(parts).view(torch.int32),
                               whole.view(torch.int32))
        else:
            same = torch.equal(torch.cat(parts), whole)
        if not same:
            raise AssertionError(f"K11's {POST_BANDS} bands of the still "
                                 f"frame differ from its one-device call in "
                                 f"{name}")
    print(f"K11: the still frame's {POST_BANDS} bands put together equal its "
          f"one-device call in every word, and their lane counts add up to "
          f"its",
          flush=True)

    # the first case's call under the profiler: K11, the trace kernels, K9,
    # the stage marks and the any-hit calls' few eager operations
    known = re.compile(r"\b(closest_hit|any_hit|stream|inst|vpu|mxu|bvh)"
                       r"_kernel\b|tpurt_mark_|path_(prime|bounce|finish)")
    seen, other = dict.fromkeys(K11_CALL, 0), {}
    for key, count in _device_ops(torch, lambda: restir.restir_spatial(
            *cases[0][1])).items():
        kind = next((k for k in K11_CALL if k in key), None)
        if kind:
            seen[kind] += count
        elif not known.search(key):
            other[key] = count
    if seen != K11_CALL or sum(other.values()) > SPATIAL_EAGER:
        raise AssertionError(f"K11 {cases[0][0]}: a restir_spatial call ran "
                             f"{seen} K11 launches and {other} besides the "
                             f"trace kernels, K9 and the marks")
    print(f"K11: the device trace of a restir_spatial call holds {seen}, the "
          f"trace kernels, K9, the stage marks and {sum(other.values())} "
          f"other operations {other}", flush=True)

    # K11 launches a replayed frame: one device, then 4 bands
    seq = _camera_seq(dev, 6, cornell.num_lights)
    one = graph_mod.FrameGraph(cornell, w1, h1, dev)
    mesh = tiles.make_mesh([DEVICE] * POST_BANDS)
    banded = tiles.TiledFrameGraph(mesh, tiles.replicate(cornell, mesh), w1,
                                   h1)
    banded.load_state(pipeline.init_state(w1, h1, dev))
    per_frame = []
    for render in (lambda u, fc, st: one(u, fc, st, gb_reuse=True),
                   lambda u, fc, st: banded(u, fc, st)):
        for u, fc, st in seq[:4]:
            render(u, fc, st)
        trace_api.reset_launch_counts()
        for u, fc, st in seq[4:]:
            render(u, fc, st)
        torch.cuda.synchronize()
        per_frame.append({k: trace_api.LAUNCHES[k] / (len(seq) - 4)
                          for k in K11_CALL})
    want = [K11_CALL, {k: POST_BANDS * n for k, n in K11_CALL.items()}]
    if per_frame != want:
        raise AssertionError(f"K11 launches a replayed frame {per_frame}, "
                             f"want {want}")
    print(f"K11: {per_frame[0]} launches a replayed one-device frame, "
          f"{per_frame[1]} a replayed frame of {POST_BANDS} bands",
          flush=True)


def main() -> int:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    print(f"device: {_card()} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})", flush=True)
    dev = torch.device(DEVICE)

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from tpu_raytracer_torch.models import dense_asset, scenes
    from tpu_raytracer_torch.ops import (gbuffer, trace_api, trace_inst,
                                         trace_mxu, trace_stream, trace_vpu,
                                         worklist)
    from tpu_raytracer_torch.render import camera, renderer
    from tpu_raytracer_torch.utils.vec3 import V3

    flat_kernels = ["closest_hit", "any_hit"]
    stream_kernels = ["stream_closest_hit", "stream_any_hit"]
    inst_kernels = ["inst_closest_hit", "inst_any_hit"]
    vpu_kernels = ["vpu_closest_hit"]
    mxu_kernels = ["mxu_closest_hit", "mxu_any_hit"]
    bvh_kernels = ["bvh_closest_hit", "bvh_any_hit"]
    every = (flat_kernels + stream_kernels + inst_kernels + vpu_kernels
             + mxu_kernels + bvh_kernels + list(FRAME_SHADE))

    # 2. build
    trace_api.load_kernels()
    print("build: K1-K10 and the stage marks from csrc/{trace,trace_stream,"
          "trace_inst,trace_vpu,trace_mxu,gather,trace_bvh,marks,path_trace,"
          "post}.cu (one nvcc call, sm_90a)", flush=True)

    scene = scenes.create_cornell_box(dev)
    cam = camera.CameraController()

    def primary_rays(s):
        uniform = renderer.camera_to_device(
            cam.uniform(WIDTH / HEIGHT, 0, s.num_lights), dev)
        po, pd = gbuffer.generate_primary_rays(uniform, WIDTH, HEIGHT)
        return (torch.stack(list(po)).contiguous(),
                torch.stack(list(pd)).contiguous())

    def kernel(o, d, t_min, t_max, any_hit=False):
        return trace_api.trace_kernel(scene.tri_planes, scene.chunk_aabb,
                                      o, d, t_min, t_max, any_hit=any_hit)

    def plain(o, d, t_min, t_max):
        return trace_api.trace_plain(scene.tri_planes, scene.chunk_aabb,
                                     V3(*o), V3(*d), t_min, t_max)

    # 29. K9, the path tracer's shading, against the eager route: first,
    # as a process's later torch.profiler sessions can drop events (the
    # phase checks its launch count and fails on such a session; its
    # sessions, and phase 30's, record after a warm-up step, _device_ops)
    _path_kernel_phase(torch, dev)
    # 30. K10, the post pass, against the eager route
    _post_kernel_phase(torch, dev)
    # 31. K11, ReSTIR's spatial reuse, against the eager route
    _spatial_kernel_phase(torch, dev)

    # 3. K1 against plain
    primary = primary_rays(scene)
    n_p = primary[0].shape[1]
    p_win = (torch.full((n_p,), 1e-3, device=dev),
             torch.full((n_p,), 1000.0, device=dev))
    ro, rd, rt_max = _random_rays(torch, RANDOM_RAYS, dev)
    r_tmin = torch.full((RANDOM_RAYS,), 1e-3, device=dev)
    r_plain = plain(ro, rd, r_tmin, rt_max)
    p_plain = plain(*primary, *p_win)
    for name, (o, d), (t_min, t_max) in (
            ("primary 512^2", primary, p_win),
            ("random", (ro, rd), (r_tmin, rt_max))):
        got = kernel(o, d, t_min, t_max)
        want = r_plain if o is ro else p_plain
        torch.cuda.synchronize()
        ulps = _check_closest(f"K1 {name}", got, want)
        if ulps:        # K1 runs the plain version's arithmetic
            raise AssertionError(f"K1 {name}: t differs from plain by "
                                 f"{ulps} ulps")
    print(f"K1: closest-hit equals plain on {n_p} primary + {RANDOM_RAYS} "
          f"random rays: tri equal on every lane, t bit-equal", flush=True)

    # 4. K2 against plain closest-hit tri >= 0
    for name, (o, d), (t_min, t_max), closest in (
            ("primary 512^2", primary, p_win, p_plain),
            ("random", (ro, rd), (r_tmin, rt_max), r_plain)):
        got = kernel(o, d, t_min, t_max, any_hit=True)
        want = closest["tri"] >= 0
        torch.cuda.synchronize()
        k2_bad = int(((got["tri"] >= 0) != want).sum())
        if k2_bad:
            raise AssertionError(f"K2 {name}: occlusion differs on {k2_bad} "
                                 f"lanes")
        if not torch.equal(got["t"], t_max):
            raise AssertionError(f"K2 {name}: t is not t_max")
        print(f"K2: any-hit equals plain closest-hit tri>=0 on the {name} "
              f"rays, t = t_max", flush=True)

    # 5. frame: the Cornell path
    c_ldrs = _run_frames(
        torch, scene, dev, FRAMES, "Cornell", on=flat_kernels,
        off=[k for k in every if k not in (*flat_kernels, *FRAME_SHADE)])
    print(f"frame: Cornell ReSTIR {WIDTH}x{HEIGHT}, {FRAMES} frames: "
          f"{flat_kernels}, K7, K9 and K10 launched and no other trace "
          f"kernel", flush=True)

    # 6. golden
    golden_dir = os.path.join(root, "tests", "golden")
    psnr = _golden_psnr(torch, scene, dev, 64, 8,
                        os.path.join(golden_dir, "cornell_64_f8_ldr.npy"))
    restir = scenes.create_restir_scene(dev)
    r_psnr = _golden_psnr(torch, restir, dev, 48, 4,
                          os.path.join(golden_dir, "restir_48_f4_ldr.npy"))
    print(f"golden: 64x64 Cornell, 8 frames: PSNR {psnr:.2f} dB vs "
          f"tests/golden/cornell_64_f8_ldr.npy; 48x48 restir "
          f"({restir.num_lights} lights, {restir.num_triangles} triangles), "
          f"4 frames: PSNR {r_psnr:.2f} dB vs "
          f"tests/golden/restir_48_f4_ldr.npy (floor {GOLDEN_DB})",
          flush=True)

    # 7. K4 against plain on the full-width gallery
    gal = scenes.create_instancing_gallery_scene(dev)

    def k4(o, d, t_min, t_max, any_hit=False):
        return trace_inst.trace_instanced_kernel(
            gal.tri_planes, gal.obj_group_aabb, gal.inst_table,
            gal.inst_aabb, gal.inst_group_span, o, d, t_min, t_max,
            any_hit=any_hit)

    def k4_plain(o, d, t_min, t_max):
        return trace_inst.trace_instanced_plain(
            gal.tri_planes, gal.obj_group_aabb, gal.inst_table,
            gal.inst_aabb, gal.unit_inst, gal.unit_group, V3(*o), V3(*d),
            t_min, t_max)

    g_primary = primary_rays(gal)
    go, gd, gt_max = _random_rays(torch, RANDOM_RAYS, dev, seed=1, lo=-7.0,
                                  hi=7.0, y=(-0.9, 3.0), t_far=20.0)
    for name, (o, d), (t_min, t_max) in (
            ("primary 512^2", g_primary, p_win),
            ("random", (go, gd), (r_tmin, gt_max))):
        want = k4_plain(o, d, t_min, t_max)
        got = k4(o, d, t_min, t_max)
        got_a = k4(o, d, t_min, t_max, any_hit=True)
        torch.cuda.synchronize()
        ulps = _check_closest(f"K4 {name}", got, want, ("tri", "inst"))
        occ = want["tri"] >= 0
        bad = int(((got_a["tri"] >= 0) != occ).sum())
        if bad:
            raise AssertionError(f"K4 any-hit {name}: occlusion differs on "
                                 f"{bad} lanes")
        if not torch.equal(got_a["t"], t_max):
            raise AssertionError(f"K4 any-hit {name}: t is not t_max")
        if not torch.equal(got_a["inst"] >= 0, occ):
            raise AssertionError(f"K4 any-hit {name}: inst is not set "
                                 f"exactly on the occluded lanes")
        print(f"K4: closest-hit equals plain on the gallery's {name} rays "
              f"({gal.num_instances} instances, {gal.num_triangles} world "
              f"triangles): tri and inst equal on every lane, t max {ulps} "
              f"ulps (bound {T_ULPS}); any-hit equals plain closest-hit "
              f"tri>=0, t = t_max, inst set exactly on the occluded lanes",
              flush=True)

    # 8. gallery frame: the instanced path
    _run_frames(torch, gal, dev, SCENE_FRAMES, "gallery", on=inst_kernels,
                off=flat_kernels + stream_kernels)
    print(f"gallery frame: instanced ReSTIR {WIDTH}x{HEIGHT}, {SCENE_FRAMES} "
          f"frames: {inst_kernels}, K7, K9 and K10 launched, not K1-K3",
          flush=True)
    gal_inst_table = gal.inst_table     # for phase 16
    del gal, go, gd, gt_max

    # 9. K3 against the plain versions on the full-width knot
    knot = scenes.create_dense_knot_scene(dev)
    if knot.num_triangles != KNOT_TRIANGLES:
        raise AssertionError(f"the knot scene holds {knot.num_triangles} "
                             f"world triangles, not {KNOT_TRIANGLES}: did "
                             f"the .glb load?")

    def k3(o, d, t_min, t_max, any_hit=False):
        return trace_stream.trace_stream_kernel(
            knot.tri_planes, knot.chunk_aabb, o, d, t_min, t_max,
            any_hit=any_hit)

    def k3_plain(o, d, t_min, t_max, any_hit=False):
        return trace_stream.trace_stream_plain(
            knot.tri_planes, knot.chunk_aabb, V3(*o), V3(*d), t_min, t_max,
            any_hit=any_hit)

    def knot_scan(o, d, t_min, t_max):
        return trace_api.trace_plain(knot.tri_planes, knot.chunk_aabb,
                                     V3(*o), V3(*d), t_min, t_max)

    k_primary = primary_rays(knot)
    pos = dense_asset.knot_mesh()[0] * 1.1 + np.float32([0.0, 1.2, 0.0])
    lo, hi = pos.min(0)[:, None], pos.max(0)[:, None]
    ko, kd, kt_max = _random_rays(torch, RANDOM_RAYS, dev, seed=2, lo=lo,
                                  hi=hi, t_far=float(np.linalg.norm(hi - lo)))
    for name, (o, d), (t_min, t_max) in (
            ("primary 512^2", k_primary, p_win),
            ("random", (ko, kd), (r_tmin, kt_max))):
        got = k3(o, d, t_min, t_max)
        got_a = k3(o, d, t_min, t_max, any_hit=True)
        want = k3_plain(o, d, t_min, t_max)
        want_a = k3_plain(o, d, t_min, t_max, any_hit=True)
        scan = knot_scan(o, d, t_min, t_max)
        torch.cuda.synchronize()
        ulps = max(_check_closest(f"K3 {name} vs {ref_name}", got, ref)
                   for ref_name, ref in (("streamed twin", want),
                                         ("chunk scan", scan)))
        for ref_name, ref in (("streamed twin", want_a["tri"] >= 0),
                              ("chunk scan", scan["tri"] >= 0)):
            bad = int(((got_a["tri"] >= 0) != ref).sum())
            if bad:
                raise AssertionError(f"K3 any-hit {name} vs {ref_name}: "
                                     f"occlusion differs on {bad} lanes")
        if not torch.equal(got_a["t"], t_max):
            raise AssertionError(f"K3 any-hit {name}: t is not t_max")
        print(f"K3: on the knot's {name} rays closest-hit equals the "
              f"streamed twin and the chunk scan: tri equal on every lane, "
              f"t max {ulps} ulps (bound {T_ULPS}); any-hit occlusion equal, "
              f"t = t_max", flush=True)
    del ko, kd, kt_max, want, want_a, scan

    # 10. knot frame: the streamed path
    k_ldrs = _run_frames(torch, knot, dev, SCENE_FRAMES, "knot",
                         on=stream_kernels, off=flat_kernels + inst_kernels)
    print(f"knot frame: dense knot ReSTIR {WIDTH}x{HEIGHT}, {SCENE_FRAMES} "
          f"frames: {stream_kernels}, K7, K9 and K10 launched, not K1, K2 "
          f"or K4", flush=True)

    # 10b. the first knot frames through K1/K2, against K3's
    _swept_knot_phase(knot, dev, [x.cpu() for x in k_ldrs[:2]])
    knot_tri_table = knot.tri_table     # for phase 16
    del knot, k_ldrs

    # 11. bunny frame: a second flattened scene on K1/K2's route
    bunny = scenes.create_bunny_scene(dev)
    _run_frames(torch, bunny, dev, SCENE_FRAMES, "bunny", on=flat_kernels,
                off=stream_kernels + inst_kernels)
    print(f"bunny frame ({bunny.num_triangles} triangles): ReSTIR "
          f"{WIDTH}x{HEIGHT}, {SCENE_FRAMES} frames: {flat_kernels}, K7, K9 "
          f"and K10 launched, not K3 or K4", flush=True)

    # K3 against K1/K2 on the bunny and Cornell (the route keeps both on
    # K1/K2)
    bo, bd, bt_max = _random_rays(torch, RANDOM_RAYS, dev, seed=3)
    for sname, s, (o, d), (t_min, t_max) in (
            ("bunny", bunny, primary_rays(bunny), p_win),
            ("bunny", bunny, (bo, bd), (r_tmin, bt_max)),
            ("Cornell", scene, primary, p_win),
            ("Cornell", scene, (ro, rd), (r_tmin, rt_max))):
        name = ("primary 512^2" if o.shape[1] == n_p
                else f"{RANDOM_RAYS} random")
        args = (s.tri_planes, s.chunk_aabb, o, d, t_min, t_max)
        k1 = trace_api.trace_kernel(*args)
        got = trace_stream.trace_stream_kernel(*args)
        got_a = trace_stream.trace_stream_kernel(*args, any_hit=True)
        torch.cuda.synchronize()
        _check_closest(f"K3 {sname} {name} vs K1", got, k1)
        bad = int(((got_a["tri"] >= 0) != (k1["tri"] >= 0)).sum())
        if bad:
            raise AssertionError(f"K3 any-hit {sname} {name} vs K1: "
                                 f"occlusion differs on {bad} lanes")
        print(f"K3 on the {sname} {name} rays equals K1/K2 on every lane",
              flush=True)

    # 12. K5 against its plain version and K1
    ray_sets = [("Cornell primary 512^2", scene, primary, p_win),
                (f"Cornell {RANDOM_RAYS} random", scene, (ro, rd),
                 (r_tmin, rt_max)),
                (f"bunny {RANDOM_RAYS} random", bunny, (bo, bd),
                 (r_tmin, bt_max))]
    k1_ref = {name: trace_api.trace_kernel(s.tri_planes, s.chunk_aabb, o, d,
                                           t_min, t_max)
              for name, s, (o, d), (t_min, t_max) in ray_sets}
    for name, s, (o, d), (t_min, t_max) in ray_sets:
        got = trace_vpu.vpu_kernel(s.tri_planes, s.chunk_aabb, o, d, t_min,
                                   t_max)
        want = trace_vpu.trace_vpu_plain(
            s.tri_planes, *trace_vpu.vpu_worklists(
                s.chunk_aabb, V3(*o), V3(*d), t_min, t_max),
            V3(*o), V3(*d), t_min, t_max)
        torch.cuda.synchronize()
        ulps = max(_check_closest(f"K5 {name} vs {ref_name}", got, ref)
                   for ref_name, ref in (("plain", want),
                                         ("K1", k1_ref[name])))
        if not torch.equal(got["t"], k1_ref[name]["t"]):
            raise AssertionError(f"K5 {name}: t is not K1's bit for bit")
        print(f"K5: on {name} rays equals its plain version and K1: tri "
              f"equal on every lane, t bit-equal to K1's, max {ulps} ulps "
              f"from plain (bound {T_ULPS})", flush=True)

    # 13. K6, each variant, against its plain version and K1
    tables = {"Cornell": trace_mxu.kernel_table(scene.tri_planes),
              "bunny": trace_mxu.kernel_table(bunny.tri_planes)}
    for vname, grp, passes, incull in MXU_VARIANTS:
        for any_hit in ((False, True) if incull else (False,)):
            for name, s, (o, d), (t_min, t_max) in ray_sets:
                table = tables[name.split()[0]]
                g = grp or (2 if s.chunk_aabb.shape[0] <= 48 else 4)
                # the (lane, chunk) set the kernel tests, for the plain
                # version
                chunks = trace_mxu.lane_chunks(s.chunk_aabb, g, incull,
                                               V3(*o), V3(*d), t_min, t_max)
                got = trace_mxu.mxu_kernel(table, s.chunk_aabb, o, d, t_min,
                                           t_max, g, passes, incull, any_hit)
                want = trace_mxu.trace_mxu_plain(table, chunks, V3(*o),
                                                 V3(*d), t_min, t_max,
                                                 passes, any_hit)
                k1 = k1_ref[name]
                if any_hit:
                    k1 = {"t": t_max,
                          "tri": torch.where(k1["tri"] >= 0, 1, -1)}
                torch.cuda.synchronize()
                if any_hit and not torch.equal(got["t"], t_max):
                    raise AssertionError(f"K6 {vname} any-hit: t is not "
                                         f"t_max")
                cmp = _compare(got, want)
                _check_plain(f"K6 {vname} {name} vs plain", cmp, any_hit)
                if vname != "mxu1":
                    _check_agree(f"K6 {vname} {name} vs K1",
                                 _compare(got, k1), any_hit)
                print(f"K6 {vname}{' any-hit' if any_hit else ''} (grp {g}, "
                      f"{passes} pass{'es' if passes > 1 else ''}) on {name} "
                      f"rays: vs plain {cmp['hit_diff']} lanes differ in "
                      f"hit/miss, {cmp['tri_diff']} in tri (at most "
                      f"{PLAIN_DIFF}), t rel max {cmp['max']:.3g}"
                      + ("" if vname == "mxu1" else "; within the bf16 "
                         "tolerance of K1"), flush=True)

    # 14. the Cornell frame under each mode, against the same frame of
    # phase 5's default run
    ldr_default = c_ldrs[MODE_FRAMES - 1].cpu().numpy()
    c_first = [x.cpu() for x in c_ldrs[:2]]      # for phase 17
    del c_ldrs

    def no_prepass(*args, **kwargs):
        raise AssertionError("a mode's CUDA route ran the worklist prepass")

    # the CUDA routes of the modes build their units in the kernel: in this
    # phase the prepass (ops/worklist.py) raises if anything calls it
    prepass = worklist.block_entry, worklist.worklists
    worklist.block_entry = worklist.worklists = no_prepass
    for mode, kernel_mode, incull, any_hit, want in (
            ("vpu", "vpu", False, False, "vpu_closest_hit"),
            ("vpu", "vpu", False, True, "vpu_closest_hit"),
            ("mxu3", "mxu3", False, False, "mxu_closest_hit"),
            ("mxu1", "mxu1", False, False, "mxu_closest_hit"),
            ("mxuw8", "mxuw", False, False, "mxu_closest_hit"),
            ("incull", "mxuf2", True, False, "mxu_closest_hit"),
            ("incull", "mxuf2", True, True, "mxu_any_hit")):
        # one trace call, one kernel launch
        s = scenes.create_cornell_box(dev, kernel=kernel_mode, incull=incull)
        trace_api.reset_launch_counts()
        trace_api.scene_trace(s, V3(*primary[0]), V3(*primary[1]), *p_win,
                              any_hit=any_hit)
        torch.cuda.synchronize()
        got = {k: v for k, v in trace_api.LAUNCHES.items() if v}
        if got != {want: 1}:
            raise AssertionError(f"{mode} {'any' if any_hit else 'closest'}"
                                 f"-hit scene_trace launched {got}, not "
                                 f"{{{want!r}: 1}}")
    print(f"modes: one scene_trace call under vpu, mxu3, mxu1, mxuw and the "
          f"cull (closest and any) launches its kernel once and nothing "
          f"else, with no prepass", flush=True)
    for mode, kernel_mode, incull, on, floor in (
            ("vpu", "vpu", False, vpu_kernels, VPU_DB),
            ("mxu3", "mxu3", False, ["mxu_closest_hit", "any_hit"],
             GOLDEN_DB),
            ("mxuw8", "mxuw", False, ["mxu_closest_hit", "any_hit"],
             GOLDEN_DB),
            ("incull", "mxuf2", True, mxu_kernels, GOLDEN_DB)):
        s = scenes.create_cornell_box(dev, kernel=kernel_mode, incull=incull)
        ldrs = _run_frames(
            torch, s, dev, MODE_FRAMES, f"Cornell {mode}", on=on,
            off=[k for k in every if k not in (*on, *FRAME_SHADE)])
        p = _psnr(ldrs[-1].cpu().numpy(), ldr_default)
        if not p >= floor:
            raise AssertionError(f"Cornell {mode} frame: PSNR {p:.2f} dB "
                                 f"against the default frame < {floor}")
        print(f"mode frame {mode}: Cornell ReSTIR under {kernel_mode}"
              f"{' + in-kernel cull' if incull else ''}, {MODE_FRAMES} "
              f"frames: {on}, K7, K9 and K10 launched and no other trace "
              f"kernel; PSNR {p:.2f} dB against the default frame (floor "
              f"{floor})", flush=True)
    worklist.block_entry, worklist.worklists = prepass

    # 15. the 64^2 golden under mxu3
    m_psnr = _golden_psnr(torch, scenes.create_cornell_box(dev, kernel="mxu3"),
                          dev, 64, 8,
                          os.path.join(golden_dir, "cornell_64_f8_ldr.npy"))
    print(f"golden under mxu3: 64x64 Cornell, 8 frames: PSNR {m_psnr:.2f} dB "
          f"vs tests/golden/cornell_64_f8_ldr.npy (floor {GOLDEN_DB})",
          flush=True)

    # 16. K7 against its plain version
    _gather_phase(torch, dev, (
        ("Cornell tri_table", scene.tri_table),
        ("Cornell mat_table", scene.mat_table),
        ("knot tri_table", knot_tri_table),
        ("gallery inst_table", gal_inst_table),
        ("restir light_table", restir.light_table)), GATHER_RAYS)

    # 17. the first Cornell frames with the plain fetch, against phase 5's
    _fetch_phase(torch, scene, dev, c_first)

    # 18. config 1: the 1-spp progressive diffuse Cornell box
    _progressive_phase(torch, dev, WIDTH, HEIGHT, PROGRESSIVE_FRAMES)

    # 19. config 5: the denoised 3840 x 2160 screenshot as one frame
    _screenshot_phase(torch, scene, dev, SHOT_W, SHOT_H, SHOT_FRAMES)

    # 20. config 4: the 1080p fly-through with the crystal refit each frame
    _flythrough_phase(torch, dev)

    # 21. the app, its screenshot, checkpoint and resume
    _app_phase(torch, root, dev)

    # 22. the procedural glTF stand-ins and the truffle app
    _standins_phase(
        torch, root, dev,
        (flat_kernels, [k for k in every if k not in (*flat_kernels,
                                                      *FRAME_SHADE)]))

    # 23. the BVH walk: K8 past the cap and on the Cornell box forced to it
    _walk_phase(torch, dev, every, c_first)

    # 24. the frame over 4 row bands, against the one-device frame
    _tiles_phase(torch, dev, every)

    # 25. the frame as CUDA graphs, against the eager frames
    _graph_phase(torch, dev, every)

    # 26. config 4 and the row bands replayed, against their eager frames
    _refit_graph(torch, dev, every)
    _tiled_graph(torch, root, dev, every)

    # 27. batched spatial taps, and the subdivided Cornell box
    _tap_batch_phase(torch, dev, every)

    # 28. the ray-stream reorder through render_band's ctx
    _reorder_phase(torch, dev, every)

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
