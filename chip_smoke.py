#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, time.

    python3 chip_smoke.py

Phases (each prints one line; any failed check raises, so the exit code
is non-zero):
  1. device   - a CUDA device is required; prints its name and power
                limit as nvidia-smi reports them.
  2. build    - builds kernels K1 (closest-hit), K2 (any-hit), K3
                (streamed closest- and any-hit), K4 (instanced closest-
                and any-hit), K5 (the vpu sweep), K6 (the tensor-core
                test), K7 (the table gather of the row fetches) and K8
                (the BVH walk, closest- and any-hit), with K9 (the path
                tracer's shading) and the stage marks, from
                tpu_raytracer_torch/csrc/{trace,trace_stream,trace_inst,
                trace_vpu,trace_mxu,gather,trace_bvh,marks,path_trace}.cu
                for sm_90a with one nvcc call.
  3. K1       - against its plain PyTorch version on the card: Cornell
                512^2 primary rays and 524,288 random rays (random t_max,
                30% dead lanes). tri equal on every lane, t bit-equal.
  4. K2       - against plain closest-hit `tri >= 0` on the same rays,
                t = t_max.
  5. frame    - the Cornell ReSTIR frame at 512^2 through render_frame:
                2 warm-up + 8 timed frames (static_ok from the second
                frame on), launch counts (K1 and K2 launched, K3-K6
                not), fps, Mrays/s, and K1/K2 against plain at 262,144 and
                524,288 random rays; then K1/K2 on the primary rays beside
                their bound, with K1's unit capacity (SWEPT_MAX_UNITS) and
                units and ptxas's registers and shared memory for both
                entries.
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
                inst set exactly on the occluded lanes. After phase 8,
                K4 is timed on both ray sets and printed beside its
                bound, with its MAX_UNITS and units and ptxas's
                registers and shared memory for its entries.
  8. gallery  - the gallery's ReSTIR frame at 512^2 through render_frame:
                2 warm-up + 4 timed frames, both K4 entry points launched
                and neither K1 nor K2; fps, Mrays/s; K4 against plain at
                262,144 and 524,288 random rays.
  9. K3       - the dense knot (bench.py config 6: 100,804 world
                triangles in 100,864 slots, loaded from the generated .glb
                through the glTF loader) against the plain versions: 512^2
                primary rays and 524,288 random rays in the knot's box
                (random t_max, 30% dead). Closest-hit tri equal on every
                lane and t within T_ULPS against the streamed twin and the
                chunk scan; any-hit occlusion equal, t = t_max. K1 is
                timed on the same rays and scene beside K3 (a check of
                MXUF_MAX_TP on this card, not a yardstick); both times
                print beside the bound, with K3's MAX_UNITS and grp and
                ptxas's registers and shared memory for its entries.
 10. knot     - the knot's ReSTIR frame at 512^2: 2 warm-up + 4 timed
                frames, both K3 entry points launched and none of K1, K2
                and K4; fps, Mrays/s. Then (10b) its first 2 frames again
                with trace_api.MXUF_MAX_TP raised here only, so K1/K2 take
                the route (K3 not launched): equal to K3's bit for bit.
 11. bunny    - the bunny scene's (config 3, 15,372 triangles) frame at
                512^2: 2 warm-up + 4 timed frames, K1 and K2 launched,
                neither K3 nor K4. Then K3 against K1/K2 on the bunny's
                and Cornell's 512^2 primary rays and 524,288 random rays
                (equal on every lane) and timed beside them: data for
                MXUF_MAX_TP, which stays as it is.
 12. K5       - the vpu sweep (an instance of csrc/sweep.cuh) against its
                plain version (the worklists of ops/worklist.py) and
                against K1, on Cornell's 512^2 primary rays, 524,288
                random Cornell rays and 524,288 random rays in the bunny
                scene: tri equal on every lane, t bit-equal to K1's and
                within T_ULPS of plain. Timed beside K1, with the vpu
                route's whole call as scene_trace makes it, and ptxas.
 13. K6       - each variant (mxu3, mxu1, mxuw with hulls of 8 chunks,
                the in-kernel cull's closest- and any-hit) on the same
                rays, against its plain version over the kernel's own
                (lane, chunk) set (at most PLAIN_DIFF lanes of a ray set
                differ in hit/miss and at most PLAIN_DIFF in tri;
                relative t error < PLAIN_REL where tri agrees) and
                against K1 within the reference's bf16 tolerance
                (hit/miss and tri agreement > AGREE, median relative t
                error < MEDIAN_REL; mxu1's only printed), with the count
                and relative t margin of the lanes that disagree. Timed
                on the random Cornell rays, beside the route's whole
                scene_trace call; ptxas of every instance.
 14. modes    - with ops/worklist.py's block_entry and worklists made to
                raise: one scene_trace call on the primary rays under
                vpu (closest and any), mxu3, mxu1, mxuw and the cull
                (closest and any) launches exactly one kernel, its own;
                then the Cornell ReSTIR frame at 512^2, MODE_WARMUP +
                MODE_TIMED frames, under vpu (K5 launched; K1-K4 not),
                mxu3 and mxuw (K6 closest-hit and K2; not K1), and the
                in-kernel cull (both K6 entries; not K1 or K2): fps,
                Mrays/s, and PSNR against the same frame of phase 5's
                default run, >= VPU_DB under vpu (K5 returns K1's hits)
                and >= GOLDEN_DB otherwise. mxu1 renders no frame (the
                reference calls it broken for rendering).
 15. golden   - the 64^2 Cornell golden under mxu3, PSNR >= GOLDEN_DB.
 16. K7       - the table gather against its plain version on the card,
                bit for bit: Cornell's tri_table and mat_table, the knot's
                tri_table, the gallery's inst_table and the restir scene's
                light_table (100 lights), at GATHER_RAYS random indices
                (the random sets' counts and the app's, config 4's and
                config 5's frames; negative ones and ones past the table
                included). Timed
                beside the plain version and one torch.index_select call
                on the transposed table (the yardstick, `library_ms`).
 17. fetch    - the first 2 Cornell 512^2 frames again with
                hit.fetch_cols set to the plain gather (here only, never
                in the package): K7 not launched, and the images equal to
                phase 5's (a gather is a copy), PSNR >= VPU_DB.
 18. config 1 - bench.py's config-1 sequence: the diffuse Cornell box at
                512^2, PROGRESSIVE_FRAMES render_progressive frames, the
                first 2 untimed: fps_1spp_progressive.
 19. config 5 - bench.py's config-5 sequence on the Cornell box at
                3840 x 2160 as one frame: frame 0, frame 1 and a warm-up
                denoised_screenshot, then frame 2 and its denoise timed
                (s_per_denoised_frame), then frames 3-31 accumulate;
                denoised_psnr_vs_32spp_3840x2160 (the denoised frame 2
                against the 32-frame accumulation, both through
                resolve_tonemap) must be finite and above the un-denoised
                frame 2's. Peak device memory of a frame and of the
                denoise; the ScreenshotSaver's PNG read back.
 20. config 4 - bench.py's config-4 sequence: the Cornell box at 1920 x
                1080, FLY_WARMUP + FLY_TIMED frames; each presses `d` for
                1/60 s (the accumulation restarts), moves the crystal
                (instance 6) by bench.py's wobble and refits it with
                ops/refit.py:update_instances(changed=(6,)), static_ok
                False. From the second frame on every refit runs under
                torch.cuda.set_sync_debug_mode("error"): no host sync.
                fps_1080p_flythrough_refit, Mrays/s, the refit's time a
                frame (on the host in the frame loop, and its device time
                and kernel launches under torch.profiler over REFIT_REPS
                refits), launches a frame (K1, K2, K7 and K9;
                nothing else), peak memory. Checks:
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
                checkpoint's frame_count 12, K1, K2 and K7 launched; then
                2 more frames resumed from the checkpoint, starting at
                frame 12. Prints the app's FrameStats fps and Mrays/s.
 22. stand-ins - the procedural glTF stand-ins at their generators'
                defaults (avocado, helmet, vrm, truffle), each built through
                interactive.load_scene (the .glb generated if missing, its
                textures Lanczos-resized, the tables built; host seconds
                printed), its triangle count asserted (and the truffle's
                three sphere lights), so a load that fell back to the floor
                scene fails; K1/K2 on its 512^2 primary rays against plain
                (as in phase 21); then 2 warm-up + 4 timed ReSTIR frames at
                512^2: K1, K2 and K7 launched and none of K3-K6, every frame
                finite and none black (max LDR > 0.01), fps and Mrays/s.
                Then `python -m tpu_raytracer_torch --scene truffle
                --scale=1280x720 --max-frames 4 --no-preview` as a
                subprocess: exit code 0, K1, K2 and K7 in its launches.
                Prints the phase's wall time.
 23. walk     - the BVH walk K8 (the route past a scene's brute_max
                triangle slots). The big scene, built
                (bigscene.big_scene) as scripts/ucb_bigscene.py
                builds its own: the floor, the
                quad light and two create_sphere(8) bodies at x = +-0.3,
                2,621,444 triangles, past the 2M cap; its host build time,
                bvh_rec's records and bytes. K8 closest- and any-hit
                against the plain walk (traversal.trace_plain, with its
                step counts) on ucb_bigscene.py's 262,144 incoherent and
                262,144 coherent rays: tri equal on every lane, t
                bit-equal. Timed by CUDA events beside the plain walk
                (timed once, counting its steps), K3 on the same scene and
                rays, and the bound from the plain walk's steps and
                touched records, each time beside the walk's steps per
                ray (mean, p99, max), its warps' longest lane over the
                mean lane (32 lanes in call order) and its box misses
                (bigscene.step_stats); then K8 and K3 on
                ucb_bigscene.py's own
                983,044-triangle scene (three create_sphere(7)) forced
                through the walk with brute_max=1. The big scene's ReSTIR
                frame at 512^2: 2 warm-up + 4 timed frames, K8 and K7
                launched and no other trace kernel, fps, Mrays/s and the
                peak device memory of the phase. Then the Cornell box
                built with brute_max=1: K8 against the plain walk on its
                512^2 primary rays and 262,144 random rays (30% dead),
                timed beside K1/K2 on the same random rays, and its first
                2 frames (K8, no K1/K2) against phase
                5's, PSNR >= VPU_DB (the same hits but exact-t ties).
                Prints the phase's wall time.
 24. tiles    - the frame over row bands (parallel/tiles.py):
                bench.py:headline_tiled's sequence (the Cornell box at
                512^2, 2 warm-up + 8 timed frames, cam.uniform(1.0, i,
                2), static_ok from the second frame) over 4 bands of 128
                rows on this card (make_mesh(["cuda:0"] * 4)), and over 4
                cards where the host has them. The last LDR against the
                one-device frame of the same sequence, max abs <= 1e-5
                (the reference's bound, tests/test_tiles.py:49), rays
                within 1e-3 a frame; then 4 frames with the camera moved
                at frame 2, held the same way. K1, K2 and K7 launched in
                every band and no other trace kernel; launches a frame
                beside 4x phase 5's, fps and Mrays/s beside the one-device
                sequence's. Prints the measured gaps.
 25. graph    - the frame as CUDA graphs (render/graph.py:FrameGraph,
                render_frame and render_progressive captured with their
                state updated in place): phase 24's headline sequence and
                its moving camera through the graph and eagerly in
                lockstep, ldr, hdr, every state tensor and rays bit-equal
                on every frame; eager frames 1 and 2 (static, and with
                the G-buffer reused) under set_sync_debug_mode("error");
                the headline sequence timed eager and then replayed:
                fps, Mrays/s, launches (a replay counts its capture's;
                equal to the eager frames'), peak memory, and 2 frames of
                each under torch.profiler (busy share and host launches,
                as profile_frame.py reads them); the graph with gb_reuse
                against eager frames without it (within
                GRAPH_REUSE_ATOL, rays exactly W x H fewer after the
                first); config 1's PROGRESSIVE_FRAMES frames bit-equal and
                timed replayed; and GRAPH_ROUTE_FRAMES frames each of the
                knot (K3), the gallery (K4), Cornell under vpu (K5) and
                mxu3 (K6) and Cornell with brute_max=1 (K8), bit-equal,
                each route's kernels launched in the replay and no other.
                Prints the phase's wall time.
 26. graphs II - config 4 and the row bands replayed. Config 4's
                FLY_WARMUP + FLY_TIMED frames through
                FrameGraph(refit_changed=(CRYSTAL,)) (the refit written in
                place, ops/refit.py:update_instances_, and the frame in
                one replay) in lockstep with update_instances +
                render_frame: ldr, hdr, every state tensor, rays and the
                scene's refit fields bit-equal on every frame, replays
                after the first under set_sync_debug_mode("error"), the
                caller's scene unwritten; eager and replayed fps, Mrays/s,
                launches (equal), at most GRAPH_FLY_LAUNCHES host launches
                a replayed frame, its busy share over GRAPH_PROFILED
                frames under torch.profiler, peak memory. Then phase 24's
                headline sequence and moving camera through
                parallel/tiles.py:TiledFrameGraph over 4 bands of this card
                (and of 4 cards where the host has them) in lockstep with
                the eager bands and the one-device frames, every word
                equal; each band's launches its eager band's (K1, K2 and
                K7, no other trace kernel); the replayed bands timed
                (phase 24 times the eager ones), graph launches a
                replayed frame = bands x segments, other launches at
                most GRAPH_TILE_OTHER, peak memory; on 4 cards also
                `python -m tpu_raytracer_torch --tiles 4` (its frames
                replayed band graphs): exit 0, K1, K2 and K7 launched.
                Prints the phase's wall time.
 27. tap batch - batched spatial-tap visibility (ops/restir.py,
                `tap_batch`: the five taps' shadow rays as one any-hit call
                over a pixel-interleaved stream of 5R rays,
                `_tap_stream`). The Cornell box at 512^2, TAP_WARMUP +
                TAP_TIMED frames through FrameGraph(tap_batch=True) in
                lockstep with render_frame(tap_batch=True), every word
                equal, an eager batched frame under
                set_sync_debug_mode("error"); then timed in this process:
                batched replayed, sequential replayed and batched eager
                (fps, Mrays/s, K1/K2/K7 launches a frame: K2 4 fewer a
                frame batched, replayed launches equal to eager), and the
                replayed batched frame's host launches (2) and busy share
                under torch.profiler. The stream `_tap_stream` made in one
                eager frame (spied, not rebuilt) through K2 against plain
                closest-hit tri>=0, on every lane, t = t_max, timed by
                CUDA events beside plain with K2's bound; the knot's and
                the gallery's streams through K3's and K4's any hit
                against their plain versions. TAP_BAND_FRAMES frames of
                TiledFrameGraph(tap_batch=True) over 4 bands of this card
                against the one-device batched frames, every word equal.
                Then the Cornell box built with subdivide_max_diag=
                SUBDIV_DIAG: its triangles and chunks against the
                unsplit box's and its build time, K1 (tri equal, t
                bit-equal) and K2 against plain on its 512^2 primary
                rays, SUBDIV_WARMUP + SUBDIV_TIMED replayed frames (K1,
                K2 and K7 only; fps, Mrays/s). Prints the phase's wall
                time.
 28. reorder  - the ray-stream reorder (ops/compaction.py): the Cornell
                box at 512^2 through render_band with
                restir.make_ctx(reorder=m) for m in REORDER_MODES,
                REORDER_WARMUP + REORDER_TIMED eager frames a mode (fps,
                K1/K2/K7 launches a frame, no other kernel), every word of
                "live" and "bins" equal to "none"; one frame a mode under
                `vpu` (K5) and on the knot (K3), every word equal; under
                `mxu3` (K6) the words and pixels that differ from "none"
                counted. The streams one Cornell frame hands its queries
                (spied at trace_api._route): the temporal path's closest-hit
                calls 1, 4 and 7 (of 7), its last depth's any-hit and the
                first spatial tap's; on each, a mode's permuted stream
                through K1 (or K2), K5 and K6 (mxu3, closest streams),
                each restored result against "none" (K1/K2/K5 every word
                equal, K6's differing lanes counted, at most PLAIN_DIFF),
                timed with CUDA events over REORDER_REPS launches, and the
                permutation (partition, gathers and restore) timed apart,
                eager and replayed from a CUDA graph (its device time).
                The device ms of an eager frame a mode under
                torch.profiler, K1/K2 apart. One render_band call with a
                "bins" ctx captured in a CUDA graph under
                set_sync_debug_mode("error"), its replay every word equal
                to the eager frame. Prints the phase's wall time.
 29. K9       - run right after the build: the path tracer's shading
                (csrc/path_trace.cu) against the eager route: both
                trace_path calls (the temporal candidates and the spatial
                replay) of the second of two eager ReSTIR frames of the
                Cornell box and of the knot at PATH_SIZES, spied, each
                through trace_path_kernel and trace_path_plain on the same
                CUDA inputs: state and valid_v1 equal on every lane, rays
                equal, radiance, v1_pos and v1_normal bit-equal on every
                lane (max abs and ulps printed); K9 launches a frame (2
                prime, 14 bounce, 2 finish); one call under torch.profiler
                holds K9_CALL's launches (a session that drops events
                fails here) and only K9, the trace kernels and the stage
                mark; K9's device ms a call by launch kind, no less than
                its bytes bound (K9_*_B a lane, from the queries' live
                rays, at HBM_PEAK), and the eager route's ms; ptxas's
                registers and spills for K9's entries. Prints the phase's
                wall time.
 30. K10      - run after phase 29: the post pass (csrc/post.cu) against
                the eager route (post_process_plain on the card) on live
                post_process arguments of a Cornell and a truffle
                1280x720 still frame, a Cornell 1920x1080 frame under a
                moving camera (its counter 0, and 5 for the clipped-history
                branch) and every band of a 4-band split (halo 16) of the
                still and the moving frame: every ldr and accum word
                equal (max abs and ulps printed), one "post" launch a
                call; the still frame's bands together equal to its
                one-device call; one call under torch.profiler holds K10
                alone; K10's ms (CUDA events) beside its bytes bound
                (K10_PX_B a pixel at HBM_PEAK) and the eager route's;
                ptxas and cudaOccupancyMaxActiveBlocksPerMultiprocessor;
                "post" launches a replayed frame, 1 on one device and 4
                on 4 bands.
Every frame phase (5, 6, 8, 10, 11, 14, 15, 18, 19, 20, 22, 23, 24, 25,
26, 27, 28) also
checks that K7, K9 and K10 launched and prints K7's launches a frame; phase 25
checks K9's launches a replayed Cornell frame (2 x K9_CALL). Then one JSON
line of per-kernel results (K1-K6: time, plain time and bound at 524,288
random rays; K7: at 524,288 rows of Cornell's tri_table; K8: at the big
scene's 262,144 incoherent rays; launches on each kernel's frames; K1,
K2 and K7 also their launches a frame on config 4's, each stand-in's,
the 4-band Cornell and the replayed Cornell frames, and on the replayed
config 4, 4-band, batched-tap and subdivided Cornell frames, K8 on the
big scene's and the walked Cornell frames, K9 (`path_shade`) by launch
kind on the replayed Cornell, config 4 and 4-band frames, K10 (`post`),
`launches_per_frame`; K2
also its time, plain time and bound on phase 27's tap stream,
`tap_stream`), and last the device line {"ok": true, "device":
{...}}. Without a CUDA device it exits with 1 and prints no result.

A kernel's bound is the least time the card could take for the work
this run's rays need: the ray-triangle tests (MT_FLOPS each, counted from
csrc/mt.cuh:intersect with an FMA as 2) in every chunk or group whose
box the ray's final window (t_min, t_hit or t_max) passes, one test per
occluded any-hit ray, and for K4 one transform (XFORM_FLOPS) per ray and
instance box passed, at FP32_PEAK; or each input read once and each
output written once at HBM_PEAK, whichever is longer. K3 does the
work K1 does (its units, sort and exit only skip work), so both take
the same bound, and K5 (the same sweep) takes it too.
K6's bound is the longest of three: its products, 2 x 16 x 4 x 128 x
passes FLOP for each ray and chunk the ray's window passes, at
BF16_PEAK (the H100 SXM's dense bf16 tensor rate, 989 TFLOP/s, NVIDIA
data sheet); its window tests, WINDOW_FLOPS for each such ray and valid
triangle, at FP32_PEAK; and its bytes (rays, coefficient table, chunk
boxes, outputs) at HBM_PEAK. Any-hit counts one test
and one chunk for an occluded ray, as K2's bound does. K8's bound counts
the plain walk's steps on the same rays: SLAB_FLOPS a box record and
MT_FLOPS a triangle record at FP32_PEAK, or each record any lane touched
(48 bytes and its skip and id) read once, the rays read and the results
written once at HBM_PEAK. K7's bound is its
bytes alone: each index read once, each output word written once and
the table read once, at HBM_PEAK.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

T_ULPS = 2          # K1/K4 t against plain; measured 0 on the CPU twins
GOLDEN_DB = 38.0
WARMUP, TIMED = 2, 8
GALLERY_WARMUP, GALLERY_TIMED = 2, 4   # also the knot and bunny frames
KNOT_TRIANGLES = 100804   # 420 x 120 x 2 knot + floor + light quads
WIDTH = HEIGHT = 512
RANDOM_RAYS = 524288
TIMED_RAYS = (262144, 524288)
DEVICE = "cuda:0"
# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, and HBM3
FP32_PEAK = 67e12
HBM_PEAK = 3.35e12
BF16_PEAK = 989e12  # dense bf16 on the tensor cores
MT_FLOPS = 46       # one ray-triangle test
XFORM_FLOPS = 36    # one ray moved into an instance's object space
WINDOW_FLOPS = 15   # one window test on K6's products (csrc/trace_mxu.cu)
MODE_WARMUP, MODE_TIMED = 2, 4     # the Cornell frames under a mode
VPU_DB = 60.0       # vpu against the default frame (K5 returns K1's hits)
# K6 against K1: the reference's tolerance for its bf16 modes
# (tests/test_mxu_kernel.py:40-52)
AGREE, MEDIAN_REL = 0.999, 1e-4
# K6 against its plain version, per ray set: lanes that may differ in
# hit/miss and (separately) in tri, and the max relative t error where tri
# agrees; measured 0, 0 and 5.94e-5 on the card (PERF.md, PR 4)
PLAIN_DIFF, PLAIN_REL = 8, 1e-4
# K6's variants: (name, mode, grp (None: the in-kernel cull's 2 or 4),
# passes, in-kernel cull, the TPU kernel's line)
MXU_VARIANTS = (("mxu3", "mxu3", 1, 3, False, 1186),
                ("mxu1", "mxu1", 1, 1, False, 1186),
                ("mxuw8", "mxuw", 8, 3, False, 1070),
                ("incull", "mxuf2", None, 3, True, 701))
PROGRESSIVE_FRAMES = 34    # config 1 (bench.py:151-172), 2 untimed
SHOT_W, SHOT_H, SHOT_FRAMES = 3840, 2160, 32   # config 5 (bench.py:207-279)
# config 4 (bench.py:187-206): the 1080p fly-through, the crystal
# (instance 6) refit every frame
FLY_W, FLY_H, FLY_WARMUP, FLY_TIMED, CRYSTAL = 1920, 1080, 2, 6, 6
# the changed-instance refit against the full one; the same bound holds
# the port's refit tables to the reference's (tests/test_torch_refit.py)
REFIT_ATOL = 1e-6
REFIT_REPS = 5      # refits under torch.profiler for their device time
# the app (phase 21): the reference app's default size (src/main.rs:122)
APP_W, APP_H, APP_FRAMES, APP_SPP, APP_RESUME = 1280, 720, 12, 8, 2
# the procedural glTF stand-ins (phase 22): the app's scene name and the
# scene's world triangles at the generators' defaults (the asset's, plus
# the floor and light quads; the truffle: the floor and three sphere
# lights of 5,120 triangles)
STANDINS = (("avocado", 12268), ("helmet", 23364), ("vrm", 11908),
            ("truffle", 23258))
STANDIN_WARMUP, STANDIN_TIMED, STANDIN_APP_FRAMES = 2, 4, 4
# the BVH walk (phase 23): two create_sphere(8) bodies past the cap, and
# scripts/ucb_bigscene.py's three create_sphere(7) bodies; its ray sets
BIG_SUBDIV, BIG_TRIANGLES, UCB_TRIANGLES = 8, 2 * 1310720 + 4, 3 * 327680 + 4
WALK_RAYS, WALK_REPS = 262144, 5
WALK_WARMUP, WALK_TIMED = 2, 4
SLAB_FLOPS = 25     # one box record: csrc/trace_bvh.cu:box_hit
# row bands (phase 24): bench.py:headline_tiled's sequence (Cornell 512^2,
# 2 + 8 frames, cam.uniform(1.0, i, 2)) over 4 bands of 128 rows, the
# reference's bound against the one-device frame (tests/test_tiles.py:49),
# and test_tiled_matches_single_chip_with_motion's 4 frames (moved at 2)
TILE_BANDS, TILE_LDR_ATOL, TILE_RAYS_ATOL = 4, 1e-5, 1e-3
TILE_MOTION_FRAMES, TILE_MOVE_AT = 4, 2
# K7's index counts: the random sets, the app's, config 4's and config 5's
# frames
GATHER_RAYS = (262144, 524288, APP_W * APP_H, FLY_W * FLY_H, 3840 * 2160)
# the frame as CUDA graphs (phase 25): G-buffer reuse against the traced
# G-buffer within the reference test's bound (tests/test_dedup.py:49-69);
# 2 frames of each other route; 1 frame under torch.profiler
GRAPH_REUSE_ATOL = 2e-5
GRAPH_ROUTE_FRAMES, GRAPH_PROFILED = 2, 1
# config 4 and the row bands replayed (phase 26): host launches a
# replayed config-4 frame (the graph and its input copies), and a
# replayed tiled frame's launches besides its bands x segments graphs
# (frame_count a band and the gather of ldr, hdr and aux)
GRAPH_FLY_LAUNCHES, GRAPH_TILE_OTHER = 20, 4 * TILE_BANDS + 8
# batched spatial taps (phase 27): the Cornell frames eager and replayed,
# the 4-band frames, and the subdivided Cornell box's cut
# (subdivide_max_diag) and frames
TAP_WARMUP, TAP_TIMED, TAP_BAND_FRAMES = 2, 6, 2
SUBDIV_DIAG, SUBDIV_WARMUP, SUBDIV_TIMED = 0.1, 2, 4
# the ray-stream reorder (phase 28): the modes of make_ctx(reorder=), the
# eager Cornell frames a mode, launches a timing, and the streams of one
# frame's queries timed: (label, index in the frame's order of queries:
# 0 the G-buffer, 1-7 the temporal path's closest hits, 8 its last
# depth's any hit, 9-13 the spatial taps')
REORDER_MODES = ("none", "live", "bins")
REORDER_WARMUP, REORDER_TIMED, REORDER_REPS = 2, 2, 20
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


def _time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time_once(torch, fn):
    """(fn(), its device time in ms) for one call that is slow enough
    to time alone."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _profile_call(torch, fn):
    """The card's operations in one call of fn, as torch.profiler's
    key_averages() entries: the session runs fn once as its warm-up step,
    whose events it drops, and records the second call alone. A session's
    first call can lose its first kernel's event; the warm-up step takes
    that loss. The steps' own annotations are no device work and are left
    out."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.key_averages() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)]


def _nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def _bound(flops, nbytes):
    """(bound_ms, bound_by): the longer of the operations at FP32_PEAK and
    the bytes at HBM_PEAK."""
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_PEAK
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _window(torch, res, t_max):
    """Each ray's final window end: its hit's t, else t_max."""
    return torch.where(res["tri"] >= 0, torch.minimum(res["t"], t_max),
                       t_max)


def _flat_tests(trace_api, scene, o, d, t_min, t_hi):
    """(ray-triangle tests, ray-chunk pairs) a 128-triangle-chunk-culled
    sweep must make for windows (t_min, t_hi): valid triangles of every
    chunk each ray's window passes, and those chunks."""
    from tpu_raytracer_torch.utils.vec3 import V3

    ov, dv = V3(*o), V3(*d)
    inv = trace_api.safe_inv_dir(dv)
    per_chunk = scene.tri_planes[3, 0].reshape(-1, trace_api.CT).sum(1)
    n = pairs = 0
    for c, box in enumerate(scene.chunk_aabb.cpu().tolist()):
        lanes = (t_hi > 0) & trace_api.slab_pass(box, ov, inv, t_min, t_hi)
        n += int(per_chunk[c]) * int(lanes.sum())
        pairs += int(lanes.sum())
    return n, pairs


def _mxu_bound(tests, pairs, passes, nbytes):
    """(bound_ms, bound_by) of K6: the longest of its products (16 x 4
    x 128 multiply-adds per ray and chunk, a pass each) at BF16_PEAK, its
    window tests at FP32_PEAK and its bytes at HBM_PEAK."""
    t_dot = pairs * 2 * 16 * 4 * 128 * passes / BF16_PEAK
    t_ops = max(t_dot, tests * WINDOW_FLOPS / FP32_PEAK)
    t_bytes = nbytes / HBM_PEAK
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _inst_tests(torch, trace_api, trace_inst, scene, o, d, t_min, t_hi):
    """(ray-triangle tests, ray transforms) a sweep culled per instance
    box and per 256-triangle object group must make for windows (t_min,
    t_hi), in the unit order of trace_inst.trace_instanced_plain."""
    import itertools

    from tpu_raytracer_torch.utils.vec3 import V3

    ov, dv = V3(*o), V3(*d)
    inv = trace_api.safe_inv_dir(dv)
    per_group = scene.tri_planes[3, 0].reshape(-1, trace_inst.GROUP).sum(1)
    per_group = per_group.cpu().tolist()
    inst_boxes = scene.inst_aabb.cpu().tolist()
    group_boxes = scene.obj_group_aabb.T.cpu().tolist()
    units = zip(scene.unit_inst.cpu().tolist(),
                scene.unit_group.cpu().tolist())
    tests = transforms = 0
    for i, run in itertools.groupby(units, key=lambda u: u[0]):
        sel = (t_hi > 0) & trace_api.slab_pass(inst_boxes[i], ov, inv, t_min,
                                                t_hi)
        lanes = torch.nonzero(sel).squeeze(1)
        if lanes.numel() == 0:
            continue
        transforms += lanes.numel()
        oo, od = trace_inst.to_object(scene.inst_table[i],
                                      V3(*(x[lanes] for x in ov)),
                                      V3(*(x[lanes] for x in dv)))
        o_inv = trace_api.safe_inv_dir(od)
        for _, g in run:
            hit = trace_api.slab_pass(group_boxes[g], oo, o_inv,
                                      t_min[lanes], t_hi[lanes])
            tests += int(per_group[g]) * int(hit.sum())
    return tests, transforms


def _ptxas_of(ptxas, kernel):
    """ptxas's registers line for each entry (closest, any) of the kernels
    whose names hold `kernel` (a template's <true> entry, or a name with
    any_hit, is the any-hit one), from the build's ptxas lines."""
    out, compiling = [], ""
    for ln in ptxas:
        if "Compiling entry" in ln:
            compiling = ln
        elif kernel in compiling:
            any_hit = "ILb1" in compiling or "any_hit" in compiling
            out.append(f"{'any' if any_hit else 'closest'}:"
                       f"{ln.split(':', 1)[-1]}")
    return out


def _ptxas_entries(ptxas, kernel):
    """ptxas's registers line for each instance of the kernel template
    named `kernel`, labelled by its template arguments as the mangled
    name gives them (ints and bools in order), from the build's lines."""
    import re

    out, compiling = [], ""
    for ln in ptxas:
        if "Compiling entry" in ln:
            compiling = ln
        elif kernel in compiling:
            args = re.findall(r"L([ib])(\d+)E", compiling.split(kernel, 1)[1])
            label = ",".join(v if t == "i" else ("true", "false")[v == "0"]
                             for t, v in args)
            out.append(f"<{label}>:{ln.split(':', 1)[-1]}")
    return out


def _run_frames(torch, scene, dev, warmup, timed, name, on, off):
    """The main path: `warmup` + `timed` ReSTIR frames of `scene` at
    WIDTH x HEIGHT through render_frame (static_ok from the second frame
    on), with the launch counts set to 0 just before. Checks the output
    and that the kernels `on` and K7 (every frame's row fetches) launched
    and those `off` did not. Returns (seconds of the timed frames, rays
    per timed frame, launches, every frame's ldr)."""
    from tpu_raytracer_torch.ops import trace_api
    from tpu_raytracer_torch.render import camera, pipeline, renderer

    cam = camera.CameraController()
    state = pipeline.init_state(WIDTH, HEIGHT, dev)
    trace_api.reset_launch_counts()
    rays, ldrs = [], []
    for i in range(warmup + timed):
        uniform = renderer.camera_to_device(
            cam.uniform(WIDTH / HEIGHT, i, scene.num_lights), dev)
        ldr, hdr, state, aux = pipeline.render_frame(
            scene, uniform, i, state, WIDTH, HEIGHT, static_ok=i > 0)
        ldrs.append(ldr)
        if i == warmup - 1:
            torch.cuda.synchronize()
            t0 = time.time()
        elif i >= warmup:
            rays.append(aux["rays"])
    torch.cuda.synchronize()
    dt = time.time() - t0
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
    rays = [float(r) for r in rays]
    if min(rays) <= 0:
        raise AssertionError(f"{name} aux['rays'] is not positive")
    return dt, rays, launches, ldrs


def _k7_line(launches, frames):
    return (f"K7 {launches['table_gather'] / frames:.2f} launches/frame "
            f"over {frames} frames")


def _frame_line(what, timed, dt, rays, launches, card, frames):
    total = sum(rays)
    return (f"{what} {WIDTH}x{HEIGHT}, {timed} timed frames: "
            f"{timed / dt:.4f} fps, {total / dt / 1e6:.4f} Mrays/s, "
            f"{dt / timed * 1e3:.2f} ms/frame, {total / timed:.0f} "
            f"rays/frame; launches {launches}; {_k7_line(launches, frames)} "
            f"[{card}]")


def _psnr(a, b):
    """PSNR in dB of two images in [0, 1]; inf when they are equal."""
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return float("inf") if mse <= 0 else 10.0 * np.log10(1.0 / mse)


def _golden_psnr(torch, scene, dev, size, frames, path):
    """(PSNR of `frames` frames at size^2 against the golden LDR image,
    K7's launches over them); raises unless K7 launched."""
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
    return psnr, launches


def _check_closest(name, got, want, hit_keys=("tri",)):
    """Raise unless `got` has `want`'s hit keys on every lane and t within
    T_ULPS; returns (max ulps, max |dt| on hit lanes, hit share)."""
    for key in hit_keys:
        bad = int((got[key] != want[key]).sum())
        if bad:
            raise AssertionError(f"{name}: {key} differs on {bad} lanes")
    g_t, w_t = got["t"].cpu().numpy(), want["t"].cpu().numpy()
    hit = want["tri"].cpu().numpy() >= 0
    ulps = int(np.abs(_ulps(g_t, w_t)).max())
    if ulps > T_ULPS:
        raise AssertionError(f"{name}: t differs by {ulps} ulps")
    return ulps, float(np.abs(g_t - w_t)[hit].max(initial=0)), hit.mean()


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


def _gather_phase(torch, dev, card, tables, sizes):
    """Phase 16: K7 on each (name, [M, C] table) at each index count in
    `sizes`, against its plain version bit for bit, timed beside it and
    beside torch.index_select on the transposed table. Returns {(name,
    n): (max |err|, ms, plain ms, library ms, (bound ms, bound by))}."""
    from tpu_raytracer_torch.ops import table_gather

    gen = torch.Generator(device=dev).manual_seed(5)
    k7 = {}
    for tname, table in tables:
        m, c = table.shape
        table_cm = table.T.contiguous()      # the yardstick's layout
        for n in sizes:
            # random rows, an eighth of them past either end of the table
            idx = torch.randint(-(m // 8) - 1, m + m // 8 + 1, (n,),
                                dtype=torch.int32, device=dev, generator=gen)
            got = table_gather.table_gather_kernel(table, idx)
            want = table_gather.table_gather_plain(table, idx)
            torch.cuda.synchronize()
            same = got.view(torch.int32) == want.view(torch.int32)
            bad = int((~same).sum())
            if bad:
                raise AssertionError(f"K7 {tname} at {n} rows: {bad} words "
                                     f"differ from plain")
            err = float(torch.where(same, 0.0, (got - want).abs()).max())
            ms = _time_ms(torch, lambda: table_gather.table_gather_kernel(
                table, idx), 20)
            plain_ms = _time_ms(torch, lambda: table_gather.table_gather_plain(
                table, idx), 5)
            valid = idx.clamp(0, m - 1)      # index_select does not clamp
            lib_ms = _time_ms(torch, lambda: torch.index_select(
                table_cm, 1, valid), 20)
            bound = _bound(0, _nbytes(idx, got, table))
            k7[(tname, n)] = (err, ms, plain_ms, lib_ms, bound)
            print(f"K7: {tname} [{m}, {c}] at {n} random rows: equal to "
                  f"plain bit for bit; K7 {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms, index_select {lib_ms:.4f} ms, bound {bound[0]:.4f} "
                  f"ms ({bound[1]}) [{card}]", flush=True)
    return k7


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
          f"for bit; launches {launches}", flush=True)


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
    diff = max(float((a - b).abs().max()) for a, b in zip(ldrs, want_ldrs))
    psnr = min(_psnr(a.numpy(), b.numpy()) for a, b in zip(ldrs, want_ldrs))
    if not psnr >= VPU_DB:
        raise AssertionError(f"plain-fetch frames: PSNR {psnr:.2f} dB "
                             f"against K7's < {VPU_DB}")
    print(f"fetch: the first {len(ldrs)} Cornell {WIDTH}x{HEIGHT} frames "
          f"with the plain gather (K7 not launched) against the same frames "
          f"through K7: max |diff| {diff:.3g}, PSNR {psnr:.2f} dB (floor "
          f"{VPU_DB})", flush=True)


def _progressive_phase(torch, dev, card, width, height, frames):
    """Phase 18, bench.py's config 1: `frames` render_progressive frames
    of the diffuse Cornell box, the first 2 untimed. Returns the
    launches."""
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
        if f == 1:
            torch.cuda.synchronize()
            t0 = time.time()
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(trace_api.LAUNCHES)
    if not (launches["closest_hit"] > 0 and launches["table_gather"] > 0):
        raise AssertionError(f"config 1 must launch K1 and K7: {launches}")
    if not (torch.isfinite(accum).all() and accum.min() >= 0
            and accum.max() > 0 and torch.isfinite(rad).all()):
        raise AssertionError("config 1: accum is not finite, non-negative "
                             "and lit")
    print(f"config 1: diffuse Cornell ({scene.num_triangles} triangles) "
          f"{width}x{height}, {frames - 2} timed render_progressive frames: "
          f"fps_1spp_progressive {(frames - 2) / dt:.4f}, "
          f"{dt / (frames - 2) * 1e3:.2f} ms/frame; launches {launches}; "
          f"{_k7_line(launches, frames)} [{card}]", flush=True)
    return launches


def _screenshot_phase(torch, scene, dev, card, width, height, frames):
    """Phase 19, bench.py's config 5 at width x height as one frame:
    frame 0; frame 1 and a warm-up denoise; frame 2 and its denoise,
    timed; frames 3 to frames - 1 accumulate. The denoised frame 2 must
    beat the un-denoised one against the accumulation. Returns the
    launches."""
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
    t0 = time.time()
    _, hdr, state, _ = frame(0, state)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    _, hdr, state, _ = frame(1, state)
    torch.cuda.synchronize()
    frame_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    den = denoised_screenshot(state["gb"], hdr, width, height)   # warm-up
    torch.cuda.synchronize()
    den_peak = torch.cuda.max_memory_allocated()
    del den
    t0 = time.time()
    _, hdr, state, _ = frame(2, state)
    den = denoised_screenshot(state["gb"], hdr, width, height)
    torch.cuda.synchronize()
    s_per_frame = time.time() - t0
    _, den_ms = _time_once(torch, lambda: denoised_screenshot(
        state["gb"], hdr, width, height))
    den_tm = resolve_tonemap(den).cpu().numpy()
    raw_tm = resolve_tonemap(hdr.reshape(height, width, 3)).cpu().numpy()
    den_img = den.cpu().numpy()
    del den
    t0 = time.time()
    for f in range(3, frames):
        _, hdr, state, _ = frame(f, state)
    torch.cuda.synchronize()
    accum_s = time.time() - t0
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
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"config 5: Cornell {width}x{height} as one frame: frame 0 "
          f"{first_s:.2f} s; s_per_denoised_frame {s_per_frame:.4f} (frame "
          f"2 + its denoise), denoise alone {den_ms:.2f} ms; frames "
          f"3-{frames - 1} {accum_s / (frames - 3):.4f} s/frame; "
          f"denoised_psnr_vs_{frames}spp_{width}x{height} {den_psnr:.4f} dB "
          f"(frame 2 without the denoise {raw_psnr:.4f} dB); peak memory: "
          f"frame {frame_peak / 2**30:.2f} GiB, denoise "
          f"{den_peak / 2**30:.2f} GiB of {total / 2**30:.1f} GiB; PNG "
          f"{png_shape} read back; launches {launches}; "
          f"{_k7_line(launches, frames)} [{card}]", flush=True)
    return launches


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
    17 holds them. Returns (max |diff|, PSNR)."""
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
    diff, psnr = float(np.abs(got - want).max()), _psnr(got, want)
    if not psnr >= VPU_DB:
        raise AssertionError(f"{what}: the plain-fetch frame is at PSNR "
                             f"{psnr:.2f} dB of K7's, < {VPU_DB}")
    return diff, psnr


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


def _flythrough_phase(torch, dev, card):
    """Phase 20, bench.py's config 4: the Cornell box at FLY_W x FLY_H,
    FLY_WARMUP + FLY_TIMED frames; each frame presses `d` for 1/60 s
    (the accumulation restarts), moves the crystal by bench.py's wobble
    and refits with changed=(CRYSTAL,), then renders with static_ok
    False. From the second frame on every update_instances call runs
    under torch.cuda.set_sync_debug_mode("error"). Then the checks:
    the last refit against a full refit of the same transforms, K1/K2 on
    the refit scene against plain, the refit boxes, and a repack.
    Returns (launches, frames)."""
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
    frames = FLY_WARMUP + FLY_TIMED
    trace_api.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    rays, host_ms = [], []
    for i in range(frames):
        cam.press("d")
        cam.update(1.0 / 60.0)
        cam.release("d")
        tf = wobble(i)
        h0 = time.perf_counter()
        if i > 0:
            torch.cuda.set_sync_debug_mode("error")
        try:
            scene = refit.update_instances(scene, tf, changed=(CRYSTAL,))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        h1 = time.perf_counter()
        uniform = renderer.camera_to_device(
            cam.uniform(FLY_W / FLY_H, 0, scene.num_lights), dev)
        ldr, hdr, state, aux = pipeline.render_frame(
            scene, uniform, 0, state, FLY_W, FLY_H, static_ok=False)
        if i == FLY_WARMUP - 1:
            torch.cuda.synchronize()
            t0 = time.time()
        elif i >= FLY_WARMUP:
            rays.append(aux["rays"])
            host_ms.append((h1 - h0) * 1e3)
    torch.cuda.synchronize()
    dt = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
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
    tf = wobble(frames - 1)
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

    # the refit's device time and kernel launches, from torch.profiler
    # over REFIT_REPS refits
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(REFIT_REPS):
            refit.update_instances(scene, tf, changed=(CRYSTAL,))
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    refit_dev_ms = sum(e.self_device_time_total for e in avgs if e.device_type
                       == torch.autograd.DeviceType.CUDA) / 1e3 / REFIT_REPS
    refit_launches = sum(e.count for e in avgs if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")) \
        / REFIT_REPS
    if not (refit_dev_ms > 0 and refit_launches > 0):
        raise AssertionError("config 4: the profiler saw no refit kernels")

    # K1 / K2 on the refit scene's primary rays against plain, and its
    # frame with the plain fetch against K7's
    uniform = renderer.camera_to_device(
        cam.uniform(FLY_W / FLY_H, 0, scene.num_lights), dev)
    o, d, po, pd, t_min, t_max = _check_primary(torch, scene, uniform, FLY_W,
                                                FLY_H, "config 4")
    n = o.shape[1]
    fetch_diff, fetch_psnr = _check_fetch(torch, scene, uniform, FLY_W, FLY_H,
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
    total = torch.cuda.get_device_properties(0).total_memory
    per_frame = {k: round(launches[k] / frames, 2) for k in on}
    print(f"config 4: Cornell {FLY_W}x{FLY_H} fly-through, crystal refit "
          f"with changed=({CRYSTAL},) each frame, {FLY_TIMED} timed frames: "
          f"fps_1080p_flythrough_refit {FLY_TIMED / dt:.4f}, "
          f"{sum(rays) / dt / 1e6:.4f} Mrays/s, {dt / FLY_TIMED * 1e3:.2f} "
          f"ms/frame; refit a frame: {np.mean(host_ms):.4f} ms of host time "
          f"({min(host_ms):.4f}-{max(host_ms):.4f}), {refit_dev_ms:.4f} ms of "
          f"device time in {refit_launches:.0f} kernel launches "
          f"(torch.profiler, {REFIT_REPS} refits); no host sync in "
          f"update_instances from frame 1 on; peak memory "
          f"{peak / 2**30:.2f} GiB of {total / 2**30:.1f} GiB; launches a "
          f"frame {per_frame} [{card}]", flush=True)
    print(f"config 4 checks: changed refit against full, max |diff| "
          f"{max(gaps.values()):.3g} (bound {REFIT_ATOL}; "
          f"{', '.join(f'{k} {v:.3g}' for k, v in gaps.items())}); "
          f"{pairs} (box, triangle) pairs contained; K1 equal to plain on "
          f"{n} primary rays, t bit-equal, K2 occlusion equal; the frame "
          f"with the plain fetch against K7's: max |diff| {fetch_diff:.3g}, "
          f"PSNR {fetch_psnr:.2f} dB (floor {VPU_DB}); repack: K1 "
          f"hit/miss and t bit-equal, rows follow the order, "
          f"{lanes.numel()} winners moved within exact-t ties", flush=True)
    return launches, frames


def _app_phase(torch, root, dev, card):
    """Phase 21: first, in this process, K1/K2 on the app's default scene
    and camera at APP_W x APP_H against plain, and its first frame with
    the plain fetch against K7's; then `python -m tpu_raytracer_torch` at
    APP_W x APP_H for APP_FRAMES frames (no preview, stdin not a tty, an
    auto-screenshot at APP_SPP samples, a checkpoint), then APP_RESUME
    more frames resumed from its checkpoint. Returns the first run's
    launches."""
    from tpu_raytracer_torch.app import interactive
    from tpu_raytracer_torch.render import camera, checkpoint, renderer
    from tpu_raytracer_torch.utils import config, png

    cfg = config.RenderConfig()
    scene = interactive.load_scene(cfg.scene, dev)
    uniform = renderer.camera_to_device(camera.CameraController().uniform(
        APP_W / APP_H, 0, scene.num_lights), dev)
    _check_primary(torch, scene, uniform, APP_W, APP_H, "app")
    fetch_diff, fetch_psnr = _check_fetch(torch, scene, uniform, APP_W, APP_H,
                                          "app")
    print(f"app checks: the default scene ({cfg.scene}) at {APP_W}x{APP_H}: "
          f"K1 equal to plain on {APP_W * APP_H} primary rays, t bit-equal, "
          f"K2 occlusion equal; the first frame with the plain fetch against "
          f"K7's: max |diff| {fetch_diff:.3g}, PSNR {fetch_psnr:.2f} dB "
          f"(floor {VPU_DB})", flush=True)
    del scene

    with tempfile.TemporaryDirectory() as tmp:
        ck, out = os.path.join(tmp, "app.npz"), os.path.join(tmp, "shots")

        def app(frames):
            t0 = time.time()
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
            return lines, json.loads(lines[-1]), time.time() - t0

        lines, tel, wall = app(APP_FRAMES)
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
        r_lines, r_tel, r_wall = app(APP_RESUME)
        resumed = f"resumed from {ck} at frame {APP_FRAMES}"
        if resumed not in r_lines or (checkpoint.load(ck)[1]
                                      != APP_FRAMES + APP_RESUME):
            raise AssertionError(f"the app did not resume at frame "
                                 f"{APP_FRAMES}: {r_lines}")
    print(f"app: python -m tpu_raytracer_torch --scale={APP_W}x{APP_H}, "
          f"{APP_FRAMES} frames in {wall:.2f} s of wall time (process "
          f"included): fps {tel['fps']:.4f} and {tel['mrays_per_s']:.4f} "
          f"Mrays/s from its FrameStats (frames 2-{APP_FRAMES}); PNG {shape} read back; checkpoint frame_count "
          f"{frame_count}; resumed at frame {APP_FRAMES} for {APP_RESUME} "
          f"frames ({r_wall:.2f} s); launches {launches} [{card}]",
          flush=True)
    return launches


def _standins_phase(torch, root, dev, card, kernels):
    """Phase 22: each stand-in scene built through the app's load_scene,
    checked (triangles, the truffle's lights, K1/K2 on its primary rays)
    and rendered through _run_frames, launching `kernels` and none of the
    other trace kernels; then the app on the truffle. Returns {name:
    (launches, frames)}."""
    from tpu_raytracer_torch.app import interactive
    from tpu_raytracer_torch.render import camera, renderer

    t_phase = time.time()
    flat, others = kernels
    out = {}
    for name, want in STANDINS:
        t0 = time.time()
        scene = interactive.load_scene(name, dev)
        torch.cuda.synchronize()
        build_s = time.time() - t0
        slots = scene.tri_planes.shape[2]
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
        frames = STANDIN_WARMUP + STANDIN_TIMED
        dt, rays, launches, ldrs = _run_frames(
            torch, scene, dev, STANDIN_WARMUP, STANDIN_TIMED, name, flat,
            others)
        for i, ldr in enumerate(ldrs):
            if not (torch.isfinite(ldr).all() and float(ldr.max()) > 0.01):
                raise AssertionError(f"{name}: frame {i} is not finite or "
                                     f"is black (max {float(ldr.max())})")
        out[name] = (launches, frames)
        print(f"stand-in {name}: {scene.num_triangles} triangles in {slots} "
              f"slots, {scene.num_lights} lights, built in {build_s:.2f} s "
              f"on the host; K1 equal to plain on {WIDTH * HEIGHT} primary "
              f"rays, t bit-equal, K2 occlusion equal; "
              + _frame_line(name, STANDIN_TIMED, dt, rays, launches, card,
                            frames), flush=True)
        del scene, ldrs

    t0 = time.time()
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
          f"0 in {time.time() - t0:.2f} s of wall time (process included), "
          f"fps {tel['fps']:.4f} and {tel['mrays_per_s']:.4f} Mrays/s from "
          f"its FrameStats; launches {launches}; phase 22 took "
          f"{time.time() - t_phase:.2f} s [{card}]", flush=True)
    return out


def _walk_check(torch, scene, what, o, d, t_min, t_max):
    """K8 closest- and any-hit against the plain walk (with its step
    counts) on these rays: tri equal on every lane and t bit-equal, or
    raise. Returns {any_hit: (plain result, plain ms)}."""
    from tpu_raytracer_torch.ops import traversal
    from tpu_raytracer_torch.utils.vec3 import V3

    bvh = (scene.bvh_rec, scene.bvh_skip, scene.bvh_tri)
    out = {}
    for any_hit in (False, True):
        got = traversal.trace_bvh_kernel(*bvh, o, d, t_min, t_max, any_hit)
        want, plain_ms = _time_once(torch, lambda: traversal.trace_plain(
            *bvh, V3(*o), V3(*d), t_min, t_max, any_hit=any_hit, count=True))
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
        out[any_hit] = (want, plain_ms)
    hit = float((out[False][0]["tri"] >= 0).float().mean())
    print(f"K8: {what}: closest- and any-hit equal the plain walk on "
          f"{o.shape[1]} rays ({hit:.3f} hit): tri on every lane, t "
          f"bit-equal", flush=True)
    return out


def _walk_bound(want, n):
    """((bound ms, by), box steps, triangle steps, records touched) of a
    walk of n rays whose plain run counted its steps: SLAB_FLOPS a box
    record and MT_FLOPS a triangle record read; each touched record (48
    bytes, its skip and id) read once, the rays read and the results
    written once."""
    box = int(want["box_steps"].sum())
    tri = int(want["tri_steps"].sum())
    touched = int(want["touched"].sum())
    nbytes = touched * (12 * 4 + 8) + n * (6 * 4 + 8) + n * 8
    return _bound(box * SLAB_FLOPS + tri * MT_FLOPS, nbytes), box, tri, \
        touched


def _walk_phase(torch, dev, card, every, c_first, ptxas):
    """Phase 23: the BVH walk (K8) on the 2,621,444-triangle scene past the
    cap, on ucb_bigscene.py's own 983,044-triangle scene forced through
    it, and on the Cornell box built with brute_max=1 (its frames against
    `c_first`, phase 5's). Returns (K8's {(ray set, any_hit): (ms, plain
    ms, bound, the plain walk's step_stats)}, the big scene's launches and
    frames, the walked Cornell frames' launches and frames)."""
    from tpu_raytracer_torch.bigscene import (big_scene, stats_text,
                                              step_stats, walk_rays)
    from tpu_raytracer_torch.models import scenes
    from tpu_raytracer_torch.ops import gbuffer, trace_api, traversal
    from tpu_raytracer_torch.ops.trace_stream import trace_stream_kernel
    from tpu_raytracer_torch.render import camera, renderer

    t_phase = time.time()
    walk = ["bvh_closest_hit", "bvh_any_hit"]
    others = [k for k in every if k not in (*walk, *FRAME_SHADE)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    big = big_scene(dev, BIG_SUBDIV, (-0.3, 0.3))
    torch.cuda.synchronize()
    build_s = time.time() - t0
    tp = big.tri_planes.shape[2]
    s = big.bvh_rec.shape[0]
    route = trace_api.trace_route(big.kernel, big.incull, tp, False,
                                  big.brute_max)
    if big.num_triangles != BIG_TRIANGLES or route[0] != "bvh":
        raise AssertionError(f"big scene: {big.num_triangles} triangles, "
                             f"route {route}")
    print(f"walk: big scene {big.num_triangles} triangles in {tp} slots "
          f"(cap {big.brute_max}: route {route[0]}), built in {build_s:.2f} s "
          f"on the host; bvh_rec {s} records, "
          f"{_nbytes(big.bvh_rec, big.bvh_skip, big.bvh_tri)} bytes with "
          f"skip and tri; ptxas K8 "
          f"{' | '.join(_ptxas_of(ptxas, 'bvh_kernel')) or 'cached'} "
          f"[{card}]", flush=True)

    def k8(scene, rays, any_hit):
        return traversal.trace_bvh_kernel(scene.bvh_rec, scene.bvh_skip,
                                          scene.bvh_tri, *rays, any_hit)

    def k3(scene, rays, any_hit):
        return trace_stream_kernel(scene.tri_planes, scene.chunk_aabb, *rays,
                                   any_hit=any_hit)

    # K8 against the plain walk, and timed beside K3, on both ray sets
    rays = walk_rays(dev, WALK_RAYS)
    out = {}
    for name, r in rays.items():
        checked = _walk_check(torch, big, f"big scene {name}", *r)
        for any_hit in (False, True):
            want, plain_ms = checked[any_hit]
            ms = _time_ms(torch, lambda: k8(big, r, any_hit), WALK_REPS)
            k3_ms = _time_ms(torch, lambda: k3(big, r, any_hit), 1)
            bound, box, tri, touched = _walk_bound(want, WALK_RAYS)
            steps = step_stats(want)
            out[(name, any_hit)] = (ms, plain_ms, bound, steps)
            query = "any" if any_hit else "closest"
            print(f"timing big scene {name} {WALK_RAYS} rays, {query}: K8 "
                  f"{ms:.4f} ms, plain walk {plain_ms:.2f} ms, K3 "
                  f"{k3_ms:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]}) "
                  f"from {box} box and {tri} triangle steps over "
                  f"{touched} of {s} records; {stats_text(steps)} "
                  f"[{card}]", flush=True)
        k3_res, want = k3(big, r, False), checked[False][0]
        same_tri = float((k3_res["tri"] == want["tri"]).float().mean())
        same_t = float((k3_res["t"] == want["t"]).float().mean())
        print(f"K3 against K8, big scene {name}: tri equal on {same_tri:.6f} "
              f"of lanes, t bit-equal on {same_t:.6f}", flush=True)
        del checked

    # ucb_bigscene.py's own scene, forced through the walk
    t0 = time.time()
    ucb = big_scene(dev, 7, (-0.6, 0.0, 0.6), brute_max=1)
    torch.cuda.synchronize()
    print(f"walk: ucb_bigscene.py's scene {ucb.num_triangles} triangles, "
          f"{ucb.bvh_rec.shape[0]} records, built in {time.time() - t0:.2f} "
          f"s", flush=True)
    if ucb.num_triangles != UCB_TRIANGLES:
        raise AssertionError(f"ucb scene: {ucb.num_triangles} triangles")
    for name, r in rays.items():
        times = []
        for any_hit in (False, True):
            times += [_time_ms(torch, lambda: k8(ucb, r, any_hit), WALK_REPS),
                      _time_ms(torch, lambda: k3(ucb, r, any_hit), 1)]
        print(f"timing ucb scene {name} {WALK_RAYS} rays: closest K8 "
              f"{times[0]:.4f} ms, K3 {times[1]:.4f} ms; any K8 "
              f"{times[2]:.4f} ms, K3 {times[3]:.4f} ms [{card}]",
              flush=True)
    del ucb

    # the big scene's frames: K8 and K7 only
    dt, frame_rays, launches, ldrs = _run_frames(
        torch, big, dev, WALK_WARMUP, WALK_TIMED, "big scene", walk, others)
    for i, ldr in enumerate(ldrs):
        if not float(ldr.max()) > 0.01:
            raise AssertionError(f"big scene frame {i} is black")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print("walk frame: " + _frame_line(
        "big scene ReSTIR", WALK_TIMED, dt, frame_rays, launches, card,
        WALK_WARMUP + WALK_TIMED) + f"; peak {peak:.2f} GiB", flush=True)
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
    c_checked = _walk_check(torch, cornell, "Cornell random", *rnd)
    for any_hit in (False, True):
        ms = _time_ms(torch, lambda: k8(cornell, rnd, any_hit), 20)
        k1_ms = _time_ms(torch, lambda: trace_api.trace_kernel(
            cornell.tri_planes, cornell.chunk_aabb, *rnd, any_hit), 20)
        bound = _walk_bound(c_checked[any_hit][0], WALK_RAYS)[0]
        steps = step_stats(c_checked[any_hit][0])
        out[("cornell", any_hit)] = (ms, c_checked[any_hit][1], bound, steps)
        print(f"timing Cornell {WALK_RAYS} random rays, "
              f"{'any' if any_hit else 'closest'}: K8 {ms:.4f} ms, "
              f"{'K2' if any_hit else 'K1'} {k1_ms:.4f} ms on the same rays, "
              f"plain walk {c_checked[any_hit][1]:.2f} ms, bound "
              f"{bound[0]:.4f} ms ({bound[1]}); {stats_text(steps)} "
              f"[{card}]", flush=True)
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
          f"{psnr:.2f} dB (floor {VPU_DB}); launches {c_launches}; phase 23 "
          f"took {time.time() - t_phase:.2f} s [{card}]", flush=True)
    return out, launches, WALK_WARMUP + WALK_TIMED, c_launches, len(c_first)


def _tiled_sequence(torch, render, state, dev, frames, warmup,
                    move_at=None):
    """`frames` Cornell frames of bench.py:headline_tiled's camera
    sequence through `render(uniform, frame_count, state, static_ok)`,
    the camera moved (and the count reset) at frame `move_at`. Returns
    (the last ldr, seconds of the frames after `warmup`, their rays, the
    per-band launches summed over every frame or None)."""
    rays, bands, t0 = [], None, None
    for i, (uniform, fc, static_ok) in enumerate(
            _camera_seq(dev, frames, 2, move_at)):
        ldr, hdr, state, aux = render(uniform, fc, state, static_ok)
        if "band_launches" in aux:
            bands = [{k: (bands[b][k] if bands else 0) + v
                      for k, v in launched.items()}
                     for b, launched in enumerate(aux["band_launches"])]
        if i == warmup - 1:
            torch.cuda.synchronize()
            t0 = time.time()
        elif i >= warmup:
            rays.append(float(aux["rays"]))    # a host read, as the bench's
    torch.cuda.synchronize()
    dt = time.time() - t0 if t0 is not None else None
    if not (torch.isfinite(ldr).all() and ldr.min() >= 0 and ldr.max() <= 1
            and torch.isfinite(hdr).all()):
        raise AssertionError("tiled phase: ldr or hdr is not finite")
    return ldr, dt, rays, bands


def _tiles_phase(torch, dev, card, every, c_fps, c_launches):
    """24. the frame over row bands (parallel/tiles.py): 4 bands of the
    512^2 Cornell frame on this card (and on 4 cards where there are),
    held to the one-device frames of the same sequences. Returns the
    launches of the 4 bands on this card over their WARMUP + TIMED
    frames."""
    from tpu_raytracer_torch.models import scenes
    from tpu_raytracer_torch.ops import trace_api
    from tpu_raytracer_torch.parallel import tiles
    from tpu_raytracer_torch.render import pipeline

    t_phase = time.time()
    scene = scenes.create_cornell_box(dev)
    on = ["closest_hit", "any_hit", "table_gather", *FRAME_SHADE]
    off = [k for k in every if k not in on]
    frames = WARMUP + TIMED

    def one_device(uniform, fc, state, static_ok):
        return pipeline.render_frame(scene, uniform, fc, state, WIDTH,
                                     HEIGHT, static_ok=static_ok)

    def fresh():
        return pipeline.init_state(WIDTH, HEIGHT, dev)

    ldr1, dt1, rays1, _ = _tiled_sequence(torch, one_device, fresh(), dev,
                                          frames, WARMUP)
    moved1, _, _, _ = _tiled_sequence(torch, one_device, fresh(), dev,
                                      TILE_MOTION_FRAMES, TILE_MOTION_FRAMES,
                                      TILE_MOVE_AT)
    fps1 = TIMED / dt1
    print(f"tiles: one-device Cornell {WIDTH}x{HEIGHT} (bench.py:"
          f"headline_tiled's sequence), {TIMED} timed frames: {fps1:.4f} fps, "
          f"{sum(rays1) / dt1 / 1e6:.4f} Mrays/s (phase 5: {c_fps:.4f} fps) "
          f"[{card}]", flush=True)

    meshes = [("1 card", [dev] * TILE_BANDS)]
    if torch.cuda.device_count() >= TILE_BANDS:
        meshes.append((f"{TILE_BANDS} cards",
                       [torch.device("cuda", i) for i in range(TILE_BANDS)]))
    one_card = None
    for what, devices in meshes:
        mesh = tiles.make_mesh(devices)
        tiled = tiles.make_render_frame_tiled(mesh, WIDTH, HEIGHT)
        scene_r = tiles.replicate(scene, mesh)

        def render(uniform, fc, state, static_ok):
            return tiled(scene_r, uniform, fc, state, static_ok)

        def fresh_bands():
            return tiles.shard_state(fresh(), mesh)

        trace_api.reset_launch_counts()
        ldr, dt, rays, bands = _tiled_sequence(torch, render, fresh_bands(),
                                               dev, frames, WARMUP)
        launches = dict(trace_api.LAUNCHES)
        moved, _, _, _ = _tiled_sequence(torch, render, fresh_bands(), dev,
                                         TILE_MOTION_FRAMES,
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
        per_frame = {k: launches[k] / frames for k in on}
        print(f"tiles: {TILE_BANDS} bands of {HEIGHT // TILE_BANDS} rows on "
              f"{what}, Cornell {WIDTH}x{HEIGHT}, {TIMED} timed frames: "
              f"{TIMED / dt:.4f} fps, {sum(rays) / dt / 1e6:.4f} Mrays/s "
              f"(one device {fps1:.4f} fps); last ldr max abs {gap:.3g} "
              f"against the one-device frame, moved camera {gap_moved:.3g} "
              f"(bound {TILE_LDR_ATOL}), rays max gap {ray_gap:.3g} a frame; "
              f"launches a frame {per_frame} (4x phase 5's: "
              f"{ {k: TILE_BANDS * c_launches[k] / frames for k in on} }); "
              f"per band {[{k: b[k] for k in on} for b in bands]} [{card}]",
              flush=True)
        if one_card is None:
            one_card = launches
    print(f"tiles: phase 24 took {time.time() - t_phase:.1f} s [{card}]",
          flush=True)
    return one_card


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


def _timed_seq(torch, render, seq, warmup):
    """(seconds of the frames after `warmup`, their rays: none for the
    progressive frame) of `seq`, each frame render(*its inputs)."""
    rays = []
    for i, inputs in enumerate(seq):
        out = render(*inputs)
        if i == warmup - 1:
            torch.cuda.synchronize()
            t0 = time.time()
        elif i >= warmup and len(out) == 4:
            rays.append(out[3]["rays"])
    torch.cuda.synchronize()
    return time.time() - t0, [float(r) for r in rays]


def _memory(torch, dev):
    """(peak allocated bytes since the last reset, bytes reserved once the
    allocator's cache is emptied): a CUDA graph's pool stays reserved
    between replays while its temporaries count as freed, so the second
    holds what the graphs keep and the first does not."""
    peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()
    return peak, torch.cuda.memory_reserved(dev)


def _profiled(torch, render, seq):
    """profile_frame.py's readings of `seq`'s frames (each render(*its
    inputs)), the first half timed unprofiled and the second under
    torch.profiler: (wall ms a frame, device ms a frame, host launches a
    frame: kernels and graphs, of them graph launches, and copies)."""
    from tpu_raytracer_torch.profile_frame import _device_us

    half = len(seq) // 2
    torch.cuda.synchronize()
    t0 = time.time()
    for inputs in seq[:half]:
        render(*inputs)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3 / half
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for inputs in seq[half:]:
            render(*inputs)
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    device_ms = sum(_device_us(e) for e in avgs
                    if e.device_type == cuda) / 1e3 / half

    def count(*keys):
        return sum(e.count for e in avgs if e.key in keys) / half
    launches = count("cudaLaunchKernel", "cuLaunchKernel",
                     "cudaLaunchKernelExC", "cudaGraphLaunch")
    return (wall_ms, device_ms, launches, count("cudaGraphLaunch"),
            count("cudaMemcpyAsync", "cudaMemcpyPeerAsync"))


def _graph_phase(torch, dev, card, every):
    """25. the frame as CUDA graphs (render/graph.py:FrameGraph): the
    headline sequence, the moving camera, G-buffer reuse, config 1 and
    the other trace routes, each replayed frame held to the eager frame
    word for word; an eager frame under set_sync_debug_mode("error");
    eager and graph fps, launches, busy share and peak memory. Returns
    the launches of the replayed headline sequence."""
    from tpu_raytracer_torch.models import scenes
    from tpu_raytracer_torch.ops import trace_api
    from tpu_raytracer_torch.render import pipeline, renderer
    from tpu_raytracer_torch.render.graph import FrameGraph

    t_phase = time.time()
    scene = scenes.create_cornell_box(dev)
    frames = WARMUP + TIMED
    seq = _camera_seq(dev, frames, scene.num_lights)
    graph = FrameGraph(scene, WIDTH, HEIGHT, dev)
    gap = _lockstep(torch, _eager(scene, dev, WIDTH, HEIGHT), _replay(graph),
                    seq, "headline")
    moved = _camera_seq(dev, TILE_MOTION_FRAMES, scene.num_lights,
                        move_at=TILE_MOVE_AT)
    gap_moved = _lockstep(torch, _eager(scene, dev, WIDTH, HEIGHT),
                          _replay(graph), moved, "moving camera")
    print(f"graph: Cornell {WIDTH}x{HEIGHT}, the headline sequence ({frames} "
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

    # eager, then replayed, on the headline sequence in one process; the
    # eager frames' memory is read with the graphs deleted
    del graph
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    trace_api.reset_launch_counts()
    e_dt, e_rays = _timed_seq(torch, _eager(scene, dev, WIDTH, HEIGHT), seq,
                              WARMUP)
    e_launches = dict(trace_api.LAUNCHES)
    e_peak = _memory(torch, dev)
    graph = FrameGraph(scene, WIDTH, HEIGHT, dev)
    _lockstep(torch, _eager(scene, dev, WIDTH, HEIGHT), _replay(graph),
              seq[:2], "headline (recaptured)")
    torch.cuda.reset_peak_memory_stats(dev)
    trace_api.reset_launch_counts()
    g_dt, g_rays = _timed_seq(torch, _replay(graph), seq, WARMUP)
    g_launches = dict(trace_api.LAUNCHES)
    g_peak = _memory(torch, dev)
    if g_launches != e_launches or g_rays != e_rays:
        raise AssertionError(f"replayed frames launch {g_launches} and count "
                             f"{g_rays} rays; the eager frames {e_launches} "
                             f"and {e_rays}")
    on = ["closest_hit", "any_hit", "table_gather", *FRAME_SHADE]
    if min(g_launches[k] for k in on) <= 0 or any(
            g_launches[k] for k in every if k not in on):
        raise AssertionError(f"the replayed Cornell frames must launch {on} "
                             f"and no other kernel: {g_launches}")
    per_frame = {k: g_launches[k] / frames for k in on}
    if any(per_frame[k] != 2 * n for k, n in K9_CALL.items()):
        raise AssertionError(f"the replayed Cornell frames launch K9 "
                             f"{per_frame}: want 2 trace_path calls of "
                             f"{K9_CALL} a frame")
    tail = _camera_seq(dev, 2 * GRAPH_PROFILED, scene.num_lights,
                       start=frames)
    profiled = []
    for render in (_eager(scene, dev, WIDTH, HEIGHT), _replay(graph)):
        for u, fc, static_ok in seq:      # the state the tail follows
            render(u, fc, static_ok)
        profiled.append(_profiled(torch, render, tail))
    e_prof, g_prof = profiled
    for what, dt, rays, peak, (wall, dev_ms, launched, _, _) in (
            ("eager", e_dt, e_rays, e_peak, e_prof),
            ("graph", g_dt, g_rays, g_peak, g_prof)):
        print(f"graph: {what} Cornell {WIDTH}x{HEIGHT}, {TIMED} timed frames: "
              f"{TIMED / dt:.4f} fps, {sum(rays) / dt / 1e6:.4f} Mrays/s, "
              f"{dt / TIMED * 1e3:.2f} ms/frame; {GRAPH_PROFILED} frames under "
              f"torch.profiler: wall {wall:.2f} ms/frame, device {dev_ms:.2f} "
              f"ms/frame, busy {dev_ms / wall:.4f}, host launches "
              f"{launched:.0f}/frame; peak allocated {peak[0] / 2 ** 30:.3f} "
              f"GiB, reserved {peak[1] / 2 ** 30:.3f} GiB [{card}]",
              flush=True)
    print(f"graph: launches a frame, replayed and eager: {per_frame}",
          flush=True)

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
    accum = renderer.make_accum(WIDTH, HEIGHT, dev)
    p_fps = [(PROGRESSIVE_FRAMES - 2) / _timed_seq(torch, r, p_seq, 2)[0]
             for r in (progressive, _replay(p_graph))]
    print(f"graph: config 1, {PROGRESSIVE_FRAMES} render_progressive frames "
          f"through FrameGraph(progressive=True) against eager: accum and "
          f"radiance bit-equal on every frame (max abs gap {p_gap:.3g}); "
          f"fps_1spp_progressive eager {p_fps[0]:.4f}, replayed "
          f"{p_fps[1]:.4f} [{card}]", flush=True)
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
              f"{gap:.3g}); replayed launches {launched}", flush=True)
        del s, g, render
    print(f"graph: phase 25 took {time.time() - t_phase:.1f} s [{card}]",
          flush=True)
    return g_launches, frames

def _refit_graph(torch, dev, card, every):
    """26a. config 4 replayed (render/graph.py:FrameGraph with
    refit_changed): bench.py:187-206's sequence, each frame's crystal
    refit in place and the frame in one replay, held in lockstep to the
    eager sequence (update_instances, then render_frame): every output,
    state word and refit field equal; replays after the first under
    set_sync_debug_mode("error"). Then both timed in this process, and
    GRAPH_PROFILED replayed frames under torch.profiler. Returns the
    replayed launches and frames."""
    from tpu_raytracer_torch.models import scenes
    from tpu_raytracer_torch.ops import refit, trace_api
    from tpu_raytracer_torch.render import camera, pipeline, renderer
    from tpu_raytracer_torch.render.graph import FrameGraph

    scene0 = scenes.create_cornell_box(dev)
    names = refit.refit_fields(scene0)
    kept = {n: getattr(scene0, n).clone() for n in names}
    base = scene0.inst_transform.cpu().numpy()
    cam = camera.CameraController()
    frames = FLY_WARMUP + FLY_TIMED
    seq = []
    for i in range(frames + 2 * GRAPH_PROFILED):
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
    readings = {}
    for what in ("eager", "replayed"):
        if what == "eager":
            render, _ = eager()
        else:
            graph.load_state(pipeline.init_state(FLY_W, FLY_H, dev))
            render = replay
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        trace_api.reset_launch_counts()
        dt, rays = _timed_seq(torch, render, seq[:frames], FLY_WARMUP)
        launches = dict(trace_api.LAUNCHES)
        peak = _memory(torch, dev)
        readings[what] = (dt, rays, launches, peak, None if what == "eager"
                          else _profiled(torch, render, seq[frames:]))
    (_, e_rays, e_launches, _, _), (_, g_rays, g_launches, _, g_prof) = (
        readings["eager"], readings["replayed"])
    if g_launches != e_launches or g_rays != e_rays:
        raise AssertionError(f"config 4 replayed launches {g_launches} and "
                             f"counts {g_rays} rays; eager {e_launches}, "
                             f"{e_rays}")
    if min(g_launches[k] for k in on) <= 0 or any(
            g_launches[k] for k in every if k not in on):
        raise AssertionError(f"config 4 replayed must launch {on} and no "
                             f"other kernel: {g_launches}")
    if g_prof[2] > GRAPH_FLY_LAUNCHES:
        raise AssertionError(f"config 4 replayed: {g_prof[2]:.0f} host "
                             f"launches a frame (at most "
                             f"{GRAPH_FLY_LAUNCHES})")
    for what, (dt, rays, _, peak, prof) in readings.items():
        extra = ""
        if prof is not None:
            wall, dev_ms, launched, graphs, copies = prof
            extra = (f"; {GRAPH_PROFILED} frames under torch.profiler: wall "
                     f"{wall:.2f} ms/frame, device {dev_ms:.2f} ms/frame, "
                     f"busy {dev_ms / wall:.4f}, host launches "
                     f"{launched:.0f}/frame ({graphs:.0f} graphs), "
                     f"{copies:.0f} copies/frame")
        print(f"graph II: config 4 {what}, {FLY_TIMED} timed frames: "
              f"fps_1080p_flythrough_refit {FLY_TIMED / dt:.4f}, "
              f"{sum(rays) / dt / 1e6:.4f} Mrays/s, "
              f"{dt / FLY_TIMED * 1e3:.2f} ms/frame{extra}; peak allocated "
              f"{peak[0] / 2 ** 30:.3f} GiB, reserved {peak[1] / 2 ** 30:.3f} "
              f"GiB [{card}]", flush=True)
    print(f"graph II: config 4 launches a frame, replayed and eager: "
          f"{ {k: g_launches[k] / frames for k in on} }", flush=True)
    del graph
    return g_launches, frames


def _tiled_graph(torch, root, dev, card, every):
    """26b. the row bands replayed (parallel/tiles.py:TiledFrameGraph):
    phase 24's headline sequence and moving camera over 4 bands of this
    card, and of 4 cards where the host has them (there also `python -m
    tpu_raytracer_torch --tiles 4`), each frame held to the eager tiled
    frame and to the one-device frame. Returns the replayed launches over
    the headline sequence on this card and its frames."""
    from tpu_raytracer_torch.models import scenes

    scene = scenes.create_cornell_box(dev)
    one_card = _bands_replayed(torch, dev, card, every, scene, "1 card",
                               [dev] * TILE_BANDS)
    if torch.cuda.device_count() >= TILE_BANDS:
        _bands_replayed(torch, dev, card, every, scene,
                        f"{TILE_BANDS} cards",
                        [torch.device("cuda", i) for i in range(TILE_BANDS)])
        _tiled_app(root, card)
    return one_card, WARMUP + TIMED


def _bands_replayed(torch, dev, card, every, scene, what, devices):
    """TiledFrameGraph over `devices`: the headline sequence and the
    moving camera in lockstep with the eager bands and the one-device
    frames, every word equal; each band's launches its eager band's (K1,
    K2 and K7, no other trace kernel). Then the replayed headline
    sequence timed, GRAPH_PROFILED frames under torch.profiler (graph
    launches a frame = bands x segments, other launches at most
    GRAPH_TILE_OTHER), peak memory. Returns the timed launches."""
    from tpu_raytracer_torch.ops import trace_api
    from tpu_raytracer_torch.parallel import tiles
    from tpu_raytracer_torch.render import pipeline

    t0 = time.time()
    frames = WARMUP + TIMED
    seqs = (("headline", _camera_seq(dev, frames, scene.num_lights)),
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
    t_lock = time.time() - t0
    print(f"graph II: {TILE_BANDS} bands of {HEIGHT // TILE_BANDS} rows on "
          f"{what}, Cornell {WIDTH}x{HEIGHT}, {graph.segments} segments a "
          f"band, through TiledFrameGraph against the eager bands and the "
          f"one-device frames: ldr, hdr, every state word and rays "
          f"bit-equal on every frame (max abs {gaps}); replayed band "
          f"launches equal the eager bands' "
          f"({[{k: b[k] for k in on} for b in g_b]}); lockstep and "
          f"captures {t_lock:.1f} s [{card}]", flush=True)

    graph.load_state(pipeline.init_state(WIDTH, HEIGHT, dev))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    trace_api.reset_launch_counts()
    dt, rays = _timed_seq(torch, replay, seqs[0][1], WARMUP)
    launches = dict(trace_api.LAUNCHES)
    peak = _memory(torch, dev)
    wall, dev_ms, launched, graphs, copies = _profiled(
        torch, replay, _camera_seq(dev, 2 * GRAPH_PROFILED, scene.num_lights,
                                   start=frames))
    if graphs != TILE_BANDS * graph.segments or \
            launched - graphs > GRAPH_TILE_OTHER:
        raise AssertionError(
            f"{TILE_BANDS} bands replayed: {graphs:.0f} graph launches a "
            f"frame ({TILE_BANDS} x {graph.segments} expected) and "
            f"{launched - graphs:.0f} other launches (at most "
            f"{GRAPH_TILE_OTHER})")
    print(f"graph II: {TILE_BANDS} bands on {what} replayed, {TIMED} timed "
          f"frames: {TIMED / dt:.4f} fps, {sum(rays) / dt / 1e6:.4f} Mrays/s, "
          f"{dt / TIMED * 1e3:.2f} ms/frame; launches a frame "
          f"{ {k: launches[k] / frames for k in on} }; {GRAPH_PROFILED} "
          f"frames under torch.profiler: wall {wall:.2f} ms/frame, device "
          f"{dev_ms:.2f} ms/frame, busy {dev_ms / wall:.4f}, host launches "
          f"{launched:.0f}/frame ({graphs:.0f} graphs), {copies:.0f} "
          f"copies/frame; peak allocated {peak[0] / 2 ** 30:.3f} GiB, "
          f"reserved {peak[1] / 2 ** 30:.3f} GiB [{card}]", flush=True)
    return launches


def _tiled_app(root, card):
    """`python -m tpu_raytracer_torch --tiles 4` on 4 cards: the app's
    frames as replayed band graphs. Exit 0, K1, K2 and K7 launched."""
    t0 = time.time()
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
          f"{TILE_BANDS} cards in {time.time() - t0:.2f} s of wall time "
          f"(process included): fps {tel['fps']:.4f}, "
          f"{tel['mrays_per_s']:.4f} Mrays/s from its FrameStats; launches "
          f"{tel['launches']} [{card}]", flush=True)


def _graphs2_phase(torch, root, dev, card, every):
    """26. graphs II: config 4 and the row bands replayed. Returns
    ((config 4's launches, frames), (the bands', frames))."""
    t_phase = time.time()
    fly = _refit_graph(torch, dev, card, every)
    print(f"graph II: config 4 took {time.time() - t_phase:.1f} s",
          flush=True)
    bands = _tiled_graph(torch, root, dev, card, every)
    print(f"graph II: phase 26 took {time.time() - t_phase:.1f} s [{card}]",
          flush=True)
    return fly, bands


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
    with t = t_max; returns the occluded and the live shares."""
    bad = int(((got["tri"] >= 0) != want).sum())
    if bad:
        raise AssertionError(f"{what}: occlusion differs from plain on {bad} "
                             f"lanes")
    if not torch.equal(got["t"], t_max):
        raise AssertionError(f"{what}: t is not t_max")
    return float(want.float().mean()), float((t_max > 0).float().mean())


def _tap_batch_phase(torch, dev, card, every):
    """27. batched spatial taps (ops/restir.py:_tap_stream, tap_batch):
    the Cornell frames eager and replayed in lockstep, timed beside the
    sequential replayed frames, K2 on one frame's tap stream against
    plain and timed; K3 and K4 on the knot's and the gallery's streams;
    4 bands against one device; the subdivided Cornell box. Returns
    (the replayed batched frames' launches, their frames, K2 on the
    stream: (lanes, ms, plain ms, bound), the subdivided frames'
    launches, their frames)."""
    from tpu_raytracer_torch.models import scenes
    from tpu_raytracer_torch.ops import (gbuffer, restir, trace_api,
                                         trace_inst, trace_stream)
    from tpu_raytracer_torch.parallel import tiles
    from tpu_raytracer_torch.render import pipeline
    from tpu_raytracer_torch.render.graph import FrameGraph
    from tpu_raytracer_torch.utils.vec3 import V3

    t_phase = time.time()
    scene = scenes.create_cornell_box(dev)
    frames = TAP_WARMUP + TAP_TIMED
    seq = _camera_seq(dev, frames, scene.num_lights)
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
    print(f"tap batch: Cornell {WIDTH}x{HEIGHT}, {frames} frames through "
          f"FrameGraph(tap_batch=True) against render_frame(tap_batch=True): "
          f"ldr, hdr, every state tensor and rays bit-equal on every frame "
          f"(max abs gap {gap:.3g}); eager frame 1 under "
          f"set_sync_debug_mode('error'): no host sync", flush=True)

    # timed in this process: batched replayed, sequential replayed,
    # batched eager; each graph captured before its counts are reset
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
        dt, rays = _timed_seq(torch, render, seq, TAP_WARMUP)
        runs[what] = (dt, rays, dict(trace_api.LAUNCHES))
    b_launches, s_launches = (runs[k][2] for k in ("batched, replayed",
                                                   "sequential, replayed"))
    on = ["closest_hit", "any_hit", "table_gather", *FRAME_SHADE]
    if min(b_launches[k] for k in on) <= 0 or any(
            b_launches[k] for k in every if k not in on):
        raise AssertionError(f"the batched Cornell frames must launch {on} "
                             f"and no other kernel: {b_launches}")
    saved = s_launches["any_hit"] - b_launches["any_hit"]
    if saved != (restir.TAPS - 1) * frames:
        raise AssertionError(f"K2 launches: {b_launches['any_hit']} batched "
                             f"against {s_launches['any_hit']} sequential "
                             f"over {frames} frames")
    if runs["batched, replayed"][2] != runs["batched, eager"][2]:
        raise AssertionError(f"replayed batched frames launch "
                             f"{b_launches}; eager ones "
                             f"{runs['batched, eager'][2]}")
    for what, (dt, rays, launched) in runs.items():
        print(f"tap batch: Cornell {WIDTH}x{HEIGHT} {what}, {TAP_TIMED} "
              f"timed frames: {TAP_TIMED / dt:.4f} fps, "
              f"{sum(rays) / dt / 1e6:.4f} Mrays/s, "
              f"{dt / TAP_TIMED * 1e3:.2f} ms/frame; K1/K2/K7 launches a "
              f"frame {launched['closest_hit'] / frames:.2f} / "
              f"{launched['any_hit'] / frames:.2f} / "
              f"{launched['table_gather'] / frames:.2f} [{card}]",
              flush=True)
    tail = _camera_seq(dev, 2 * GRAPH_PROFILED, scene.num_lights,
                       start=frames)
    render = _replay(graph)
    for inputs in seq:
        render(*inputs)
    wall, dev_ms, launched, graphs, _ = _profiled(torch, render, tail)
    if launched > 2:
        raise AssertionError(f"a replayed batched frame makes {launched:.0f} "
                             f"host launches (2 expected)")
    print(f"tap batch: replayed, {GRAPH_PROFILED} frames under "
          f"torch.profiler: wall {wall:.2f} ms/frame, device {dev_ms:.2f} "
          f"ms/frame, busy {dev_ms / wall:.4f}, host launches "
          f"{launched:.0f}/frame ({graphs:.0f} graphs) [{card}]", flush=True)
    del graph, seq_graph, render

    # K2 on one frame's tap stream against plain, timed, bound
    o, d, t_min, t_max = _spied_stream(torch, scene, dev, seq[0])
    n = t_max.shape[0]

    def k2():
        return trace_api.trace_kernel(scene.tri_planes, scene.chunk_aabb, o,
                                      d, t_min, t_max, any_hit=True)

    def plain():
        return trace_api.trace_plain(scene.tri_planes, scene.chunk_aabb,
                                     V3(*o), V3(*d), t_min, t_max)

    want = plain()["tri"] >= 0
    occ, live = _occlusion_check(torch, "K2 on the tap stream", k2(), want,
                                 t_max)
    ms = _time_ms(torch, k2, 20)
    plain_ms = _time_ms(torch, lambda: plain()["tri"] >= 0, 3)
    tests = int(want.sum()) + _flat_tests(
        trace_api, scene, o, d, t_min, torch.where(want, 0.0, t_max))[0]
    bound = _bound(tests * MT_FLOPS, _nbytes(
        o, d, t_min, t_max, scene.tri_planes, scene.chunk_aabb) + n * 8)
    print(f"tap batch: K2 on one Cornell frame's tap stream ({n} rays, "
          f"pixel-interleaved, {live:.4f} live, {occ:.4f} occluded) equals "
          f"plain closest-hit tri>=0 on every lane, t = t_max; "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms "
          f"({bound[1]}, {tests} tests) [{card}]", flush=True)
    k2_stream = (n, ms, plain_ms, bound)

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
        t0 = time.time()
        s = build(dev)
        stream = _spied_stream(torch, s, dev,
                               _camera_seq(dev, 1, s.num_lights)[0])
        got = kernel(s, *stream)
        want = plain_fn(s, *stream)["tri"] >= 0
        occ, live = _occlusion_check(torch, f"{what} on the tap stream", got,
                                     want, stream[3])
        print(f"tap batch: {what} any-hit on one frame's tap stream "
              f"({stream[3].shape[0]} rays, {live:.4f} live, {occ:.4f} "
              f"occluded) equals plain on every lane, t = t_max "
              f"({time.time() - t0:.1f} s with the build)", flush=True)
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
    t0 = time.time()
    split = scenes.create_cornell_box(dev, subdivide_max_diag=SUBDIV_DIAG)
    t_build = time.time() - t0
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
    ulps, _, hit = _check_closest("K1 on the subdivided box", got, want)
    if ulps:
        raise AssertionError(f"K1 on the subdivided box: t differs from "
                             f"plain by {ulps} ulps")
    _occlusion_check(torch, "K2 on the subdivided box", trace_api.trace_kernel(
        split.tri_planes, split.chunk_aabb, po, pd, t_lo, t_hi,
        any_hit=True), want["tri"] >= 0, t_hi)
    s_frames = SUBDIV_WARMUP + SUBDIV_TIMED
    s_graph = FrameGraph(split, WIDTH, HEIGHT, dev)
    s_seq = _camera_seq(dev, s_frames, split.num_lights)
    _lockstep(torch, _eager(split, dev, WIDTH, HEIGHT), _replay(s_graph),
              s_seq[:2], "subdivided Cornell")
    trace_api.reset_launch_counts()
    dt, rays = _timed_seq(torch, _replay(s_graph), s_seq, SUBDIV_WARMUP)
    sub_launches = dict(trace_api.LAUNCHES)
    if min(sub_launches[k] for k in on) <= 0 or any(
            sub_launches[k] for k in every if k not in on):
        raise AssertionError(f"the subdivided Cornell frames must launch {on} "
                             f"and no other kernel: {sub_launches}")
    print(f"tap batch: subdivided Cornell (subdivide_max_diag={SUBDIV_DIAG}):"
          f" {n_tri} triangles in {chunks} chunks (unsplit "
          f"{scene.num_triangles} in {scene.chunk_aabb.shape[0]}), built in "
          f"{t_build:.2f} s; K1 on its {po.shape[1]} primary rays ({hit:.3f} "
          f"hit) tri equal on every lane and t bit-equal to plain, K2 "
          f"occlusion equal; {SUBDIV_TIMED} replayed frames: "
          f"{SUBDIV_TIMED / dt:.4f} fps, {sum(rays) / dt / 1e6:.4f} Mrays/s; "
          f"launches a frame "
          f"{ {k: sub_launches[k] / s_frames for k in on} } [{card}]",
          flush=True)
    print(f"tap batch: phase 27 took {time.time() - t_phase:.1f} s [{card}]",
          flush=True)
    return b_launches, frames, k2_stream, sub_launches, s_frames


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
    (seconds of the frames after REORDER_WARMUP or None, launches, the
    frames' words); raises where a mode launches a kernel outside `on`
    or leaves one of `on` out."""
    from tpu_raytracer_torch.ops import trace_api

    runs, on = {}, [*on, *FRAME_SHADE]
    for m in REORDER_MODES:
        render = _band(scene, dev, WIDTH, HEIGHT, m)
        trace_api.reset_launch_counts()
        frames, t0 = [], None
        for i, inputs in enumerate(seq):
            if i == REORDER_WARMUP:
                torch.cuda.synchronize()
                t0 = time.time()
            frames.append(render(*inputs))
        torch.cuda.synchronize()
        dt = time.time() - t0 if t0 is not None else None
        launched = dict(trace_api.LAUNCHES)
        if min(launched[k] for k in on) <= 0 or any(
                launched[k] for k in every if k not in on):
            raise AssertionError(f"{what} reorder={m}: want {on} launched "
                                 f"and no other kernel: {launched}")
        runs[m] = (dt, launched, frames)
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


def _stream_times(torch, scene, mxu_scene, streams, card):
    """REORDER_STREAMS through K1/K2, K5 and K6 under each mode, each
    restored result held to "none", each timed, and the permutation timed
    apart. Returns {(label, mode): {"lanes", "live", "k", "perm", "k5",
    "k6", "k6_diff"}}."""
    from tpu_raytracer_torch.ops import compaction, trace_api, trace_mxu
    from tpu_raytracer_torch.ops import trace_vpu

    planes, boxes = scene.tri_planes, scene.chunk_aabb
    out = {}
    for label, i in REORDER_STREAMS:
        _, any_hit, o, d, t_min, t_max = streams[i]
        n = t_max.shape[0]
        live = float((t_max > 0).float().mean())
        base = {}
        for m in REORDER_MODES:
            if m == "none":
                src = dest = torch.arange(n, device=o.device)
            else:
                src, dest = compaction.permutation(m, tuple(d), t_max)
            po, pd = o[:, src].contiguous(), d[:, src].contiguous()
            p0, p1 = t_min[src].contiguous(), t_max[src].contiguous()

            def k(po=po, pd=pd, p0=p0, p1=p1):
                return trace_api.trace_kernel(planes, boxes, po, pd, p0, p1,
                                              any_hit=any_hit)

            def k5(po=po, pd=pd, p0=p0, p1=p1):
                return trace_vpu.vpu_kernel(planes, boxes, po, pd, p0, p1)

            def k6(po=po, pd=pd, p0=p0, p1=p1):
                return trace_mxu.mxu_kernel(mxu_scene.coef48_t, boxes, po,
                                            pd, p0, p1, 1, 3, False, False)

            def perm(m=m, k_out=None):
                s, dst = compaction.permutation(m, tuple(d), t_max)
                ys = [x[s] for x in (*o, *d, t_min, t_max)]
                return ys, [y[dst] for y in k_out]

            got = {"k": k(), "k5": k5()}
            if not any_hit:
                got["k6"] = k6()
            got = {key: {f: v[dest] for f, v in r.items()}
                   for key, r in got.items()}
            row = {"lanes": n, "live": live}
            if m == "none":
                base = got
            for key, r in got.items():
                if key == "k6":
                    row["k6_diff"] = int(
                        ((r["tri"] >= 0) != (base[key]["tri"] >= 0)).sum()
                        + (r["tri"] != base[key]["tri"]).sum()
                        + (r["t"].view(torch.int32)
                           != base[key]["t"].view(torch.int32)).sum())
                    if row["k6_diff"] > 2 * PLAIN_DIFF:
                        raise AssertionError(f"K6 on {label} reorder={m}: "
                                             f"{row['k6_diff']} words differ"
                                             f" from none")
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
            row["k"] = _time_ms(torch, k, REORDER_REPS)
            row["k5"] = _time_ms(torch, k5, REORDER_REPS)
            if not any_hit:
                row["k6"] = _time_ms(torch, k6, REORDER_REPS)
            if m != "none":
                sample = (got["k"]["t"], got["k"]["tri"])
                row["perm"] = _time_ms(
                    torch, lambda m=m: perm(m, sample), REORDER_REPS)
                row["perm_graph"] = _replayed_ms(
                    torch, lambda m=m: perm(m, sample), REORDER_REPS)
            out[(label, m)] = row
            print(f"reorder: {label} ({n} rays, {live:.4f} live, "
                  f"{'any' if any_hit else 'closest'} hit) {m}: "
                  f"K{'2' if any_hit else '1'} {row['k']:.4f} ms, K5 "
                  f"{row['k5']:.4f} ms"
                  + (f", K6 {row['k6']:.4f} ms ({row['k6_diff']} words "
                     f"differ from none)" if not any_hit else "")
                  + (f", permutation {row['perm']:.4f} ms eager, "
                     f"{row['perm_graph']:.4f} ms replayed" if m != "none"
                     else "") + f"; restored results equal [{card}]",
                  flush=True)
    return out


def _replayed_ms(torch, fn, reps):
    """fn's device time: fn captured once in a CUDA graph, the graph
    replayed `reps` times between CUDA events (no host launch between
    its kernels)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = _time_ms(torch, graph.replay, reps)
    del graph
    return ms


def _profiled_modes(torch, scene, dev, seq):
    """Per mode of REORDER_MODES: (device ms a frame, K1 + K2 device ms a
    frame) of the eager frames of seq[1:] under torch.profiler, after
    seq[0] unprofiled."""
    import re

    from tpu_raytracer_torch.profile_frame import _device_us

    sweep = re.compile(r"^(?:void )?\(anonymous namespace\)::"
                       r"(?:closest_hit|any_hit)_kernel")
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for m in REORDER_MODES:
        render = _band(scene, dev, WIDTH, HEIGHT, m)
        render(*seq[0])
        torch.cuda.synchronize()
        # the device's activity alone: its kernels' times are all this
        # reads, and the host's 30k ops a frame cost seconds to record
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for inputs in seq[1:]:
                render(*inputs)
            torch.cuda.synchronize()
        avgs = [e for e in prof.key_averages() if e.device_type == cuda]
        n = len(seq) - 1
        out[m] = (sum(_device_us(e) for e in avgs) / 1e3 / n,
                  sum(_device_us(e) for e in avgs if sweep.match(e.key))
                  / 1e3 / n)
        if not out[m][1] > 0.0:
            raise AssertionError(f"torch.profiler shows no K1/K2 time in "
                                 f"the reorder={m} frame: {out[m]}")
    return out


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


def _reorder_phase(torch, dev, card, every):
    """28. the ray-stream reorder: make_ctx(reorder=) through render_band
    on the Cornell box (K1, K2), under vpu (K5) and mxu3 (K6), on the
    knot (K3); one frame's streams through K1/K2, K5 and K6 under each
    mode beside the permutation's own time; the device time of a frame
    a mode; a captured "bins" frame. Returns (the Cornell frames'
    launches a mode, their frames)."""
    from tpu_raytracer_torch.models import scenes

    t_phase = time.time()
    scene = scenes.create_cornell_box(dev)
    frames = REORDER_WARMUP + REORDER_TIMED
    seq = _camera_seq(dev, frames, scene.num_lights)
    on = ["closest_hit", "any_hit", "table_gather"]
    runs = _mode_frames(torch, scene, dev, seq, "Cornell", on, every)
    for m in REORDER_MODES:
        dt, launched, got = runs[m]
        for i, (g, w) in enumerate(zip(got, runs["none"][2])):
            diff, gap = _word_diff(torch, g, w)
            if diff:
                raise AssertionError(f"Cornell reorder={m} frame {i}: {diff} "
                                     f"words differ from none (max abs "
                                     f"{gap:.3g})")
        rays = sum(float(out[3]["rays"]) for out in got[REORDER_WARMUP:])
        print(f"reorder: Cornell {WIDTH}x{HEIGHT} through render_band with "
              f"make_ctx(reorder={m!r}), {frames} eager frames: every word "
              f"equal to none's; {REORDER_TIMED} timed: "
              f"{REORDER_TIMED / dt:.4f} fps, {rays / dt / 1e6:.4f} Mrays/s; "
              f"K1/K2/K7 launches a frame "
              f"{launched['closest_hit'] / frames:.2f} / "
              f"{launched['any_hit'] / frames:.2f} / "
              f"{launched['table_gather'] / frames:.2f} [{card}]",
              flush=True)
    c_launches = {m: runs[m][1] for m in REORDER_MODES}
    del runs
    print(f"reorder: the Cornell frames took {time.time() - t_phase:.1f} s",
          flush=True)

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
        t0 = time.time()
        s = build()
        one = _camera_seq(dev, 1, s.num_lights)
        runs = _mode_frames(torch, s, dev, one, what, kernels, every)
        notes = []
        for m in ("live", "bins"):
            diff, gap = _word_diff(torch, runs[m][2][0], runs["none"][2][0])
            ldr_px = int((runs[m][2][0][0] != runs["none"][2][0][0])
                         .any(dim=-1).sum())
            if exact and diff:
                raise AssertionError(f"{what} reorder={m}: {diff} words "
                                     f"differ from none (max abs {gap:.3g})")
            notes.append(f"{m}: {diff} words, {ldr_px} LDR pixels differ "
                         f"(max abs {gap:.3g})")
        print(f"reorder: {what} {WIDTH}x{HEIGHT}, 1 eager frame a mode "
              f"(launches {kernels} only) against none: "
              f"{'; '.join(notes)} ({time.time() - t0:.1f} s with the "
              f"build) [{card}]", flush=True)
        del s, runs

    # one frame's streams: the kernels a mode, the permutation apart
    t0 = time.time()
    streams = _recorded_streams(torch, scene, dev, seq)
    times = _stream_times(torch, scene, mxu_scene, streams, card)
    del streams
    print(f"reorder: the streams took {time.time() - t0:.1f} s", flush=True)

    # device time a frame a mode, and the captured bins frame
    t0 = time.time()
    prof = _profiled_modes(torch, scene, dev, _camera_seq(
        dev, 2, scene.num_lights))
    for m, (dev_ms, sweep_ms) in prof.items():
        print(f"reorder: Cornell {WIDTH}x{HEIGHT} reorder={m}, 1 eager "
              f"frame under torch.profiler: device {dev_ms:.4f} ms/frame, "
              f"K1 + K2 {sweep_ms:.4f} ms/frame [{card}]", flush=True)
    print(f"reorder: the profiled frames took {time.time() - t0:.1f} s",
          flush=True)
    launched, gap = _captured_band(torch, scene, dev, seq)
    print(f"reorder: one render_band call with make_ctx(reorder='bins') "
          f"captured in a CUDA graph under set_sync_debug_mode('error') "
          f"(launches recorded {launched['closest_hit']} K1, "
          f"{launched['any_hit']} K2, {launched['table_gather']} K7); its "
          f"replay equals the eager call in every word (max abs {gap:.3g})",
          flush=True)
    print(f"reorder: phase 28 took {time.time() - t_phase:.1f} s [{card}]",
          flush=True)
    return c_launches, frames, times, prof


PATH_K9 = ("path_prime", "path_bounce", "path_finish")
# the shading kernels of every ReSTIR frame: K9's and K10 ("post")
FRAME_SHADE = (*PATH_K9, "post")
# K9's bytes a lane at the least (csrc/path_trace.cu; table rows and
# texels come from L2 and are not counted): prime, every lane (the
# G-buffer row and seed in, the lane state, two rays with t_min, the last
# depth's zeroed shadow ray and the reconnection vertex out); a bounce, a
# live lane (flags, radiance, RNG, throughput, pdf, its ray and hit, its
# shadow answer in; its state, NEE term and two rays out), a lane with
# only a shadow answer pending, and an idle one (its flags); finish, every
# lane (flags, radiance, RNG in; radiance and state out) and a shadow lane
# (its NEE term and answer)
K9_PRIME_B, K9_LIVE_B, K9_SHADOW_B, K9_IDLE_B = 219, 176, 52, 4
K9_FINISH_B, K9_FINISH_SHADOW_B = 40, 16
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
    """K9's call with its queries spied: (outputs, [(live rays of the
    query's first half, of its second half)] in order; a query of one
    half gives (its live rays, 0))."""
    from tpu_raytracer_torch.ops import path_trace

    real, live = path_trace.scene_trace, []

    def spy(scene_, o, d, t_min, t_max, any_hit=False, **kw):
        r = call[2].shape[0]
        lv = t_max > 0
        live.append((int(lv[:r].sum()), int(lv[r:].sum())))
        return real(scene_, o, d, t_min, t_max, any_hit=any_hit, **kw)

    path_trace.scene_trace = spy
    try:
        out = path_trace.trace_path_kernel(scene, *call)
        torch.cuda.synchronize()
    finally:
        path_trace.scene_trace = real
    return out, live


def _k9_bound_ms(r, live, lights):
    """K9's bytes for one call at HBM_PEAK, from its queries' live rays:
    bounce d reads what query d - 1 left (live bounce lanes, pending
    shadow answers)."""
    nbytes = r * (K9_PRIME_B + K9_FINISH_B)
    for first, second in live[:-1] if lights else live:
        shadow, bounce = (first, second) if lights else (0, first)
        pending = max(shadow - bounce, 0)      # at the least
        nbytes += bounce * K9_LIVE_B + pending * K9_SHADOW_B \
            + (r - bounce - pending) * K9_IDLE_B
    nbytes += (live[-1][0] if lights else 0) * K9_FINISH_SHADOW_B
    return nbytes / HBM_PEAK * 1e3, nbytes


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


def _k9_ptxas():
    """{kernel: (registers, spill stores, spill loads)} of K9's entries
    from the build's ptxas lines, when this process built the library."""
    import re

    from tpu_raytracer_torch.runtime.build import BUILD_LOGS

    out, entry = {}, None
    for ln in BUILD_LOGS.get("trace_kernels", "").splitlines():
        if "Compiling entry" in ln:
            entry = next((k for k in PATH_K9 if k in ln), None)
        elif entry and "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            out[entry] = (out.get(entry, (0,))[0], int(st), int(ld))
        elif entry and "registers" in ln:
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            out[entry] = (regs, *out.get(entry, (0, 0, 0))[1:])
    return out


def _path_kernel_phase(torch, dev, card):
    """29. K9, the path tracer's shading (csrc/path_trace.cu), against the
    eager route on the card: both trace_path calls of a Cornell and a
    knot ReSTIR frame at 1280x720 (spied, the second frame's), through
    trace_path_kernel and trace_path_plain on the same CUDA inputs;
    launches a frame, only K9, the trace kernels and the stage mark in a
    call's device trace, K9 ms a launch beside its bytes bound, the eager
    route's ms, ptxas."""
    from tpu_raytracer_torch.models import scenes
    from tpu_raytracer_torch.ops import path_trace, trace_api
    from tpu_raytracer_torch.profile_frame import _device_us
    from tpu_raytracer_torch.render import camera, pipeline, renderer
    import re

    t_phase = time.time()
    trace_names = re.compile(r"\b(closest_hit|any_hit|stream|inst|vpu|mxu|"
                             r"bvh)_kernel\b")
    ptx = _k9_ptxas()
    for k, (regs, st, ld) in ptx.items():
        blocks = 65536 // (((regs * 32 + 255) // 256) * 256 * 4)
        print(f"K9 ptxas {k}: {regs} registers, {st} B spill stores, {ld} B "
              f"spill loads; {min(blocks, 16)} blocks of 128 an SM by "
              f"registers [{card}]", flush=True)
    results = {}
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
                got, live = _k9_queries(torch, scene, call)
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
                if len(live) != path_trace.MAX_DEPTH - (
                        scene.num_lights == 0):
                    raise AssertionError(f"K9 made {len(live)} queries")
                bound_ms, nbytes = _k9_bound_ms(r, live,
                                                scene.num_lights > 0)

                # one call under the profiler: only K9, the trace kernels
                # and the stage mark, and K9's device time by launch kind
                ops = _profile_call(torch, lambda: path_trace.trace_path(
                    scene, *call))
                ms, other = dict.fromkeys(PATH_K9, 0.0), []
                seen = dict.fromkeys(PATH_K9, 0)
                for e in ops:
                    if _device_us(e) <= 0:
                        continue
                    kind = next((k for k in PATH_K9 if k in e.key), None)
                    if kind:
                        ms[kind] += _device_us(e) / 1e3
                        seen[kind] += e.count
                    elif not (trace_names.search(e.key)
                              or "tpurt_mark_" in e.key):
                        other.append(e.key)
                if other:
                    raise AssertionError(f"K9 {what} {name}: a trace_path "
                                         f"call ran other device work: "
                                         f"{other}")
                k9_ms = sum(ms.values())
                # a session that drops events reads too few launches, or
                # less time than the bytes take
                if seen != K9_CALL or k9_ms < bound_ms:
                    raise AssertionError(
                        f"K9 {what} {name}: the profile holds {seen} "
                        f"launches in {k9_ms:.4f} ms, want {K9_CALL} in "
                        f"{bound_ms:.4f} ms (the bytes bound) at the least")
                _, plain_ms = _time_once(torch, lambda: path_trace
                                         .trace_path_plain(scene, *call))
                err = max(diff[k][2] for k in ("radiance", "v1_pos",
                                               "v1_normal"))
                results[(what, name)] = (k9_ms, bound_ms, plain_ms, err)
                print(f"K9 {what} {width}x{height} {name}: state and "
                      f"valid_v1 equal on {r} of {r} lanes, rays "
                      f"{float(got['rays']):.0f} equal; bit-equal lanes "
                      + ", ".join(f"{k} {diff[k][0]} (max abs "
                                  f"{diff[k][2]:.3g}, {diff[k][3]} ulps)"
                                  for k in ("radiance", "v1_pos",
                                            "v1_normal"))
                      + f"; K9 {k9_ms:.3f} ms a call (prime "
                      f"{ms['path_prime']:.3f}, bounces "
                      f"{ms['path_bounce']:.3f} over 7, finish "
                      f"{ms['path_finish']:.3f}), bound {bound_ms:.3f} ms "
                      f"({nbytes / 1e6:.1f} MB at HBM_PEAK); queries' live "
                      f"rays {live}; eager route {plain_ms:.2f} ms a call; "
                      f"no other device work [{card}]", flush=True)

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
              f"{per_frame} [{card}]", flush=True)
    print(f"phase 29 (K9) took {time.time() - t_phase:.1f} s", flush=True)
    return results


# 30. K10, the post pass (csrc/post.cu): the bytes a pixel needs, HDR 12 +
# the G-buffer row's position, oct normal, albedo and motion 40 + an
# accumulation word 12 in, LDR and accumulation 24 out (the packed rows
# being adjacent, DRAM moves all 56 B of each: 104 B in this layout)
K10_PX_B = 88
POST_SIZES = ((1280, 720), (1920, 1080))     # the one-card cells' sizes
POST_BANDS, POST_HALO = 4, 16                # the bands cell's split
POST_TIMED = 50                              # K10 launches timed a case


def _post_call(torch, scene, dev, width, height, frames, move=False):
    """The post_process arguments of the last of `frames` eager ReSTIR
    frames of `scene` at width x height, live: a still camera with the
    counter at the frame's index, static_ok and gb_reuse from the second
    frame on, as the app renders; with `move`, a camera moving each frame
    (the counter 0, as the app resets it)."""
    from tpu_raytracer_torch.ops import post
    from tpu_raytracer_torch.render import camera, pipeline, renderer

    real, calls = post.post_process, []

    def spy(*args):
        calls[:] = [args]
        return real(*args)

    cam = camera.CameraController()
    state = pipeline.init_state(width, height, dev)
    post.post_process = spy
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
        post.post_process = real
    torch.cuda.synchronize()
    return calls[0]


def _post_band(torch, args, band):
    """The post_process arguments of band `band` of POST_BANDS, halo
    POST_HALO, cut from a one-device call's: the views halo_exchange
    gives (zero rows outside the image), the band's motion rows."""
    from tpu_raytracer_torch.parallel.views import BandView

    hdr_view, gb, gb_view, hist_view, fc, ctx = args
    width, height = ctx["width"], ctx["height"]
    band_h = height // POST_BANDS
    y0 = band * band_h

    def view(v):
        rows = v.data.reshape(height, width, -1)
        ext = rows.new_zeros((band_h + 2 * POST_HALO, width, rows.shape[2]))
        lo, hi = max(y0 - POST_HALO, 0), min(y0 + band_h + POST_HALO, height)
        ext[lo - y0 + POST_HALO:hi - y0 + POST_HALO] = rows[lo:hi]
        return BandView(ext.reshape(-1, rows.shape[2]), y0, width, height,
                        band_h, POST_HALO)

    return (view(hdr_view), {"motion": gb["motion"][y0 * width:
                                                    (y0 + band_h) * width]},
            view(gb_view), view(hist_view), fc,
            dict(ctx, y0=y0, band_h=band_h))


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


def _k10_ptxas():
    """ptxas's lines for K10's entry, when this process built the
    library."""
    from tpu_raytracer_torch.runtime.build import BUILD_LOGS

    out, entry = [], False
    for ln in BUILD_LOGS.get("trace_kernels", "").splitlines():
        if "Compiling entry" in ln:
            entry = "post_pass" in ln
        elif entry and ("registers" in ln or "spill" in ln):
            out.append(ln.split(":", 1)[-1].strip())
    return out


def _post_kernel_phase(torch, dev, card):
    """30. K10, the post pass (csrc/post.cu), against the eager route
    (post_process_plain on the card) on live frame inputs: a Cornell and a
    truffle 1280x720 still frame, a Cornell 1920x1080 frame under a moving
    camera (as rendered, counter 0, and with the counter at 5, so the
    clipped-history branch runs), and every band of a 4-band split (halo
    16) of the Cornell still and the moving frame; every word of ldr and
    accum, max abs and ulps. The bands' K10 words against the one-device
    call's on the still frame; a call's device trace holds K10 alone; K10's
    ms beside its bytes bound and the eager route's; ptxas and occupancy;
    "post" launches a replayed frame, one device and 4 bands."""
    import ctypes

    from tpu_raytracer_torch.app import interactive
    from tpu_raytracer_torch.models import scenes
    from tpu_raytracer_torch.ops import post, trace_api
    from tpu_raytracer_torch.parallel import tiles
    from tpu_raytracer_torch.profile_frame import _device_us
    from tpu_raytracer_torch.render import graph as graph_mod
    from tpu_raytracer_torch.render import pipeline

    t_phase = time.time()
    lib = trace_api.load_kernels()
    blocks = ctypes.c_int(0)
    err = lib.tpurt_post_occupancy(ctypes.byref(blocks))
    print(f"K10 ptxas post_pass: {' | '.join(_k10_ptxas()) or 'cached'}; "
          f"{blocks.value} blocks of 32 x 8 threads an SM "
          f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor, error {err}) "
          f"[{card}]", flush=True)
    cornell = scenes.create_cornell_box(dev)
    truffle = interactive.load_scene("truffle", dev)
    (w1, h1), (w2, h2) = POST_SIZES
    still = _post_call(torch, cornell, dev, w1, h1, 4)
    moving = _post_call(torch, cornell, dev, w2, h2, 3, move=True)
    cases = [("Cornell still", still),
             ("truffle still", _post_call(torch, truffle, dev, w1, h1, 4)),
             ("Cornell moving", moving),
             ("Cornell moving, counter 5", moving[:4] + (5,) + moving[5:])]
    cases += [(f"Cornell still, band {b} of {POST_BANDS}",
               _post_band(torch, still, b)) for b in range(POST_BANDS)]
    cases += [(f"Cornell moving, counter 5, band {b} of {POST_BANDS}",
               _post_band(torch, cases[3][1], b)) for b in range(POST_BANDS)]
    results, outs, worst, alone = {}, {}, [0.0, 0], ""
    for what, args in cases:
        ctx = args[5]
        n = ctx["band_h"] * ctx["width"]
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
        worst = [max(worst[0], *(d[2] for d in diff)),
                 max(worst[1], *(d[3] for d in diff))]
        motion = args[1]["motion"]
        speed = (motion * torch.tensor([ctx["width"], ctx["height"]],
                                       device=dev)).norm(dim=-1)
        moving_px = int((speed >= 0.5).sum())
        if "band" in what:
            print(f"K10 {what}: {line} [{card}]", flush=True)
            continue

        # the first case's call under the profiler: K10 alone (one
        # session, so as to meet the profiler's lost events once at most)
        if not results:
            kernels = {e.key: e.count for e in _profile_call(
                torch, lambda: post.post_process(*args)) if _device_us(e) > 0}
            if list(kernels.values()) != [1] or "post_pass" not in \
                    next(iter(kernels)):
                raise AssertionError(f"K10 {what}: a post_process call ran "
                                     f"{kernels} on the card")
            alone = f"; the trace of a call holds {kernels} alone"
        k10_ms = _time_ms(torch, lambda: post.post_process(*args),
                          POST_TIMED)
        _, plain_ms = _time_once(torch, lambda: post.post_process_plain(
            *args))
        bound_ms = K10_PX_B * n / HBM_PEAK * 1e3
        results[what] = (k10_ms, bound_ms, plain_ms)
        print(f"K10 {what} {ctx['width']}x{ctx['height']} (counter "
              f"{int(args[4])}, {moving_px} of {n} pixels moving >= 0.5 px): "
              f"{line}; K10 {k10_ms:.4f} ms a call ({POST_TIMED} launches, "
              f"CUDA events), bound {bound_ms:.4f} ms ({K10_PX_B} B a pixel "
              f"at HBM_PEAK, {k10_ms / bound_ms:.1f}x), eager route "
              f"{plain_ms:.2f} ms a call, timed once{alone} [{card}]",
              flush=True)
        alone = ""

    # the still frame's bands, put together, are the one-device call's
    for k in (0, 1):
        bands = torch.cat([outs[f"Cornell still, band {b} of {POST_BANDS}"]
                           [k] for b in range(POST_BANDS)])
        if not torch.equal(bands.view(torch.int32),
                           outs["Cornell still"][k].view(torch.int32)):
            raise AssertionError("K10's 4 bands of the still frame differ "
                                 "from its one-device call")
    print(f"K10: the still frame's {POST_BANDS} bands put together equal "
          f"its one-device call in every ldr and accum word [{card}]",
          flush=True)

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
          f"{per_frame[1]:.0f} a replayed frame of {POST_BANDS} bands "
          f"[{card}]", flush=True)
    print(f"K10: every ldr and accum word of the {len(cases)} cases equal "
          f"to the eager route's (max abs {worst[0]:.3g}, {worst[1]} ulps) "
          f"[{card}]", flush=True)
    print(f"phase 30 (K10) took {time.time() - t_phase:.1f} s", flush=True)
    return {"times": results, "per_frame": per_frame,
            "max_abs_err": worst[0], "max_ulps": worst[1]}


def main() -> int:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = _card()
    print(f"device: {card} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})", flush=True)
    dev = torch.device(DEVICE)

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from tpu_raytracer_torch.models import dense_asset, scenes
    from tpu_raytracer_torch.ops import (gbuffer, trace_api, trace_inst,
                                         trace_mxu, trace_stream, trace_vpu,
                                         worklist)
    from tpu_raytracer_torch.render import camera, renderer
    from tpu_raytracer_torch.runtime.build import BUILD_LOGS
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
    t0 = time.time()
    trace_api.load_kernels()
    ptxas = [ln.strip() for ln in BUILD_LOGS.get("trace_kernels", "")
             .splitlines() if "registers" in ln or "Compiling entry" in ln]
    print(f"build: K1-K8 from csrc/{{trace,trace_stream,trace_inst,"
          f"trace_vpu,trace_mxu,gather,trace_bvh}}.cu in "
          f"{time.time() - t0:.2f} s (one nvcc call, sm_90a); ptxas: "
          f"{' | '.join(ptxas) or 'cached'}", flush=True)

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
    # sessions, and phase 30's, record after a warm-up step, _profile_call)
    k9 = _path_kernel_phase(torch, dev, card)
    # 30. K10, the post pass, against the eager route
    k10 = _post_kernel_phase(torch, dev, card)

    # 3. K1 against plain
    primary = primary_rays(scene)
    n_p = primary[0].shape[1]
    p_win = (torch.full((n_p,), 1e-3, device=dev),
             torch.full((n_p,), 1000.0, device=dev))
    ro, rd, rt_max = _random_rays(torch, RANDOM_RAYS, dev)
    r_tmin = torch.full((RANDOM_RAYS,), 1e-3, device=dev)
    r_plain = plain(ro, rd, r_tmin, rt_max)
    p_plain = plain(*primary, *p_win)
    k1_err, k1_ulps = 0.0, 0
    for name, (o, d), (t_min, t_max) in (
            ("primary 512^2", primary, p_win),
            ("random", (ro, rd), (r_tmin, rt_max))):
        got = kernel(o, d, t_min, t_max)
        want = r_plain if o is ro else p_plain
        torch.cuda.synchronize()
        ulps, err, _ = _check_closest(f"K1 {name}", got, want)
        k1_ulps, k1_err = max(k1_ulps, ulps), max(k1_err, err)
        if ulps:        # K1 runs the plain version's arithmetic
            raise AssertionError(f"K1 {name}: t differs from plain by "
                                 f"{ulps} ulps")
    print(f"K1: closest-hit equals plain on {n_p} primary + {RANDOM_RAYS} "
          f"random rays: tri equal on every lane, t bit-equal (max "
          f"{k1_ulps} ulps), max |dt| {k1_err:.3g}", flush=True)

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
              f"rays ({float(want.float().mean()):.3f} occluded), t = t_max",
              flush=True)
    k2_err = 0.0     # max |flag difference|

    # 5. frame: the Cornell path
    dt, rays, launches, c_ldrs = _run_frames(
        torch, scene, dev, WARMUP, TIMED, "Cornell", on=flat_kernels,
        off=[k for k in every if k not in (*flat_kernels, *FRAME_SHADE)])
    c_fps = TIMED / dt                            # for phase 24
    print("frame: " + _frame_line("Cornell ReSTIR", TIMED, dt, rays,
                                  launches, card, WARMUP + TIMED),
          flush=True)

    timings = {}
    for n in TIMED_RAYS:
        o, d, t_min, t_max = ro[:, :n], rd[:, :n], r_tmin[:n], rt_max[:n]
        o, d = o.contiguous(), d.contiguous()
        t_k1 = _time_ms(torch, lambda: kernel(o, d, t_min, t_max), 20)
        t_k2 = _time_ms(torch, lambda: kernel(o, d, t_min, t_max, True), 20)
        t_plain = _time_ms(torch, lambda: plain(o, d, t_min, t_max), 3)
        # the plain any-hit is closest-hit followed by `tri >= 0`
        t_plain2 = _time_ms(
            torch, lambda: plain(o, d, t_min, t_max)["tri"] >= 0, 3)
        timings[n] = (t_k1, t_plain, t_k2, t_plain2)
        print(f"timing {n} random rays: K1 {t_k1:.4f} ms vs plain "
              f"{t_plain:.4f} ms; K2 {t_k2:.4f} ms vs plain {t_plain2:.4f} ms "
              f"[{card}]", flush=True)

    # bounds at the last timed size, which is all of the random rays
    flat_io = _nbytes(ro, rd, r_tmin, rt_max, scene.tri_planes,
                      scene.chunk_aabb) + RANDOM_RAYS * 8
    k1_tests, k1_pairs = _flat_tests(trace_api, scene, ro, rd, r_tmin,
                                     _window(torch, r_plain, rt_max))
    occ = r_plain["tri"] >= 0
    k2_tests, k2_pairs = (x + int(occ.sum()) for x in _flat_tests(
        trace_api, scene, ro, rd, r_tmin, torch.where(occ, 0.0, rt_max)))
    k1_bound = _bound(k1_tests * MT_FLOPS, flat_io)
    k2_bound = _bound(k2_tests * MT_FLOPS, flat_io)
    print(f"bound {RANDOM_RAYS} random rays: K1 {k1_tests} tests, "
          f"{k1_bound[0]:.4f} ms ({k1_bound[1]}); K2 {k2_tests} tests, "
          f"{k2_bound[0]:.4f} ms ({k2_bound[1]})", flush=True)

    # K1/K2 on the primary rays beside the random rays, with their build
    t_p1 = _time_ms(torch, lambda: kernel(*primary, *p_win), 20)
    t_p2 = _time_ms(torch, lambda: kernel(*primary, *p_win, True), 20)
    p_io = _nbytes(*primary, *p_win, scene.tri_planes,
                   scene.chunk_aabb) + n_p * 8
    p_tests = _flat_tests(trace_api, scene, *primary, p_win[0],
                          _window(torch, p_plain, p_win[1]))[0]
    p_occ = p_plain["tri"] >= 0
    p2_tests = int(p_occ.sum()) + _flat_tests(
        trace_api, scene, *primary, p_win[0],
        torch.where(p_occ, 0.0, p_win[1]))[0]
    p1_bound = _bound(p_tests * MT_FLOPS, p_io)
    p2_bound = _bound(p2_tests * MT_FLOPS, p_io)
    c_grp, c_units = trace_stream.stream_units(
        scene.chunk_aabb.shape[0], trace_api.SWEPT_MAX_UNITS)
    print(f"timing Cornell primary 512^2 rays: K1 {t_p1:.4f} ms against "
          f"{p_tests} tests, bound {p1_bound[0]:.4f} ms ({p1_bound[1]}); K2 "
          f"{t_p2:.4f} ms against {p2_tests} tests, bound "
          f"{p2_bound[0]:.4f} ms ({p2_bound[1]}); SWEPT_MAX_UNITS "
          f"{trace_api.SWEPT_MAX_UNITS}: {c_units} units of {c_grp} "
          f"chunk(s); ptxas K1/K2 "
          f"{' | '.join(_ptxas_of(ptxas, 'hit_kernel')) or 'cached'} "
          f"[{card}]", flush=True)

    # 6. golden
    golden_dir = os.path.join(root, "tests", "golden")
    psnr, gl_launches = _golden_psnr(
        torch, scene, dev, 64, 8,
        os.path.join(golden_dir, "cornell_64_f8_ldr.npy"))
    restir = scenes.create_restir_scene(dev)
    r_psnr, rl_launches = _golden_psnr(
        torch, restir, dev, 48, 4,
        os.path.join(golden_dir, "restir_48_f4_ldr.npy"))
    print(f"golden: 64x64 Cornell, 8 frames: PSNR {psnr:.2f} dB vs "
          f"tests/golden/cornell_64_f8_ldr.npy, {_k7_line(gl_launches, 8)}; "
          f"48x48 restir ({restir.num_lights} lights, "
          f"{restir.num_triangles} triangles), 4 frames: PSNR "
          f"{r_psnr:.2f} dB vs tests/golden/restir_48_f4_ldr.npy, "
          f"{_k7_line(rl_launches, 4)} (floor {GOLDEN_DB})", flush=True)

    # 7. K4 against plain on the full-width gallery
    t0 = time.time()
    gal = scenes.create_instancing_gallery_scene(dev)
    print(f"gallery: {gal.num_instances} instances, {gal.num_triangles} "
          f"world triangles in {gal.tri_planes.shape[2]} object slots, "
          f"{gal.unit_inst.numel()} (instance, group) units, built in "
          f"{time.time() - t0:.2f} s", flush=True)

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
    g_plain = k4_plain(go, gd, r_tmin, gt_max)
    gp_plain = k4_plain(*g_primary, *p_win)
    k4_err, k4_ulps, k4a_bad = 0.0, 0, 0
    for name, (o, d), (t_min, t_max), want in (
            ("primary 512^2", g_primary, p_win, gp_plain),
            ("random", (go, gd), (r_tmin, gt_max), g_plain)):
        got = k4(o, d, t_min, t_max)
        got_a = k4(o, d, t_min, t_max, any_hit=True)
        torch.cuda.synchronize()
        ulps, err, hit = _check_closest(f"K4 {name}", got, want,
                                        ("tri", "inst"))
        k4_ulps, k4_err = max(k4_ulps, ulps), max(k4_err, err)
        occ = want["tri"] >= 0
        bad = int(((got_a["tri"] >= 0) != occ).sum())
        k4a_bad = max(k4a_bad, bad)
        if bad:
            raise AssertionError(f"K4 any-hit {name}: occlusion differs on "
                                 f"{bad} lanes")
        if not torch.equal(got_a["t"], t_max):
            raise AssertionError(f"K4 any-hit {name}: t is not t_max")
        if not torch.equal(got_a["inst"] >= 0, occ):
            raise AssertionError(f"K4 any-hit {name}: inst is not set "
                                 f"exactly on the occluded lanes")
        print(f"K4: closest-hit equals plain on the gallery's {name} rays "
              f"({hit:.3f} hit): tri and inst equal on every lane, "
              f"t max {k4_ulps} ulps (bound {T_ULPS}), max |dt| "
              f"{k4_err:.3g}; any-hit equals plain closest-hit tri>=0 "
              f"({float(occ.float().mean()):.3f} occluded), t = t_max, inst "
              f"set exactly on the occluded lanes", flush=True)
    k4a_err = float(k4a_bad > 0)   # max |flag difference|

    # 8. gallery frame: the instanced path
    dt, rays, g_launches, _ = _run_frames(
        torch, gal, dev, GALLERY_WARMUP, GALLERY_TIMED, "gallery",
        on=inst_kernels, off=flat_kernels + stream_kernels)
    print("gallery frame: " + _frame_line("instanced ReSTIR", GALLERY_TIMED,
                                          dt, rays, g_launches, card,
                                          GALLERY_WARMUP + GALLERY_TIMED),
          flush=True)

    for n in TIMED_RAYS:
        o, d, t_min, t_max = go[:, :n], gd[:, :n], r_tmin[:n], gt_max[:n]
        o, d = o.contiguous(), d.contiguous()
        t_k = _time_ms(torch, lambda: k4(o, d, t_min, t_max), 10)
        t_ka = _time_ms(torch, lambda: k4(o, d, t_min, t_max, True), 10)
        t_p = _time_ms(torch, lambda: k4_plain(o, d, t_min, t_max), 2)
        t_pa = _time_ms(
            torch, lambda: k4_plain(o, d, t_min, t_max)["tri"] >= 0, 2)
        timings[("k4", n)] = (t_k, t_p, t_ka, t_pa)
        print(f"timing {n} random gallery rays: K4 closest {t_k:.4f} ms vs "
              f"plain {t_p:.4f} ms; K4 any {t_ka:.4f} ms vs plain "
              f"{t_pa:.4f} ms [{card}]", flush=True)

    def k4_bounds(o, d, t_min, t_max, closest):
        """K4's closest- and any-hit (tests, transforms, bound) on these
        rays and their plain closest hits."""
        io = _nbytes(o, d, t_min, t_max, gal.tri_planes,
                     gal.obj_group_aabb, gal.inst_table, gal.inst_aabb,
                     gal.inst_group_span) + o.shape[1] * 12
        occ = closest["tri"] >= 0
        out = []
        for t_hi, extra in ((_window(torch, closest, t_max), 0),
                            (torch.where(occ, 0.0, t_max), int(occ.sum()))):
            tests, xf = _inst_tests(torch, trace_api, trace_inst, gal, o, d,
                                    t_min, t_hi)
            tests += extra
            out.append((tests, xf, _bound(tests * MT_FLOPS
                                          + xf * XFORM_FLOPS, io)))
        return out

    # K4 on the primary rays beside the random rays, with its build
    t_pk = _time_ms(torch, lambda: k4(*g_primary, *p_win), 10)
    t_pka = _time_ms(torch, lambda: k4(*g_primary, *p_win, True), 10)
    i_grp, i_units = trace_inst.inst_units(gal.num_instances)
    k4_ptxas = _ptxas_of(ptxas, "inst_kernel")
    for name, rays, closest, t in (
            ("primary 512^2", (*g_primary, *p_win), gp_plain, (t_pk, t_pka)),
            (f"{RANDOM_RAYS} random", (go, gd, r_tmin, gt_max), g_plain,
             timings[("k4", RANDOM_RAYS)][::2])):
        (k4_tests, k4_xf, k4_bound), (k4a_tests, k4a_xf, k4a_bound) = \
            k4_bounds(*rays, closest)
        print(f"bound gallery {name} rays: K4 closest {t[0]:.4f} ms against "
              f"{k4_tests} tests + {k4_xf} transforms, {k4_bound[0]:.4f} ms "
              f"({k4_bound[1]}); K4 any {t[1]:.4f} ms against {k4a_tests} "
              f"tests + {k4a_xf} transforms, {k4a_bound[0]:.4f} ms "
              f"({k4a_bound[1]}); MAX_UNITS {trace_inst.MAX_UNITS}: "
              f"{i_units} units of {i_grp} instance(s); ptxas K4 "
              f"{' | '.join(k4_ptxas) or 'cached'} [{card}]", flush=True)
    # k4_bound and k4a_bound stay at the random rays, for the kernels line
    gal_inst_table = gal.inst_table     # for phase 16
    del gal, g_plain, gp_plain, go, gd, gt_max

    # 9. K3 against the plain versions on the full-width knot
    t0 = time.time()
    knot = scenes.create_dense_knot_scene(dev)
    if knot.num_triangles != KNOT_TRIANGLES:
        raise AssertionError(f"the knot scene holds {knot.num_triangles} "
                             f"world triangles, not {KNOT_TRIANGLES}: did "
                             f"the .glb load?")
    tp = knot.tri_planes.shape[2]
    grp, units = trace_stream.stream_units(tp // trace_api.CT)
    print(f"knot: {knot.num_triangles} world triangles in {tp} slots "
          f"(> MXUF_MAX_TP {trace_api.MXUF_MAX_TP}: K3's route), "
          f"MAX_UNITS {trace_stream.MAX_UNITS}: {units} units of {grp} "
          f"chunk(s), textures {sorted(knot.tex_channels)}, built in "
          f"{time.time() - t0:.2f} s", flush=True)

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

    def k1_knot(o, d, t_min, t_max, any_hit=False):
        return trace_api.trace_kernel(knot.tri_planes, knot.chunk_aabb, o, d,
                                      t_min, t_max, any_hit=any_hit)

    k_primary = primary_rays(knot)
    pos = dense_asset.knot_mesh()[0] * 1.1 + np.float32([0.0, 1.2, 0.0])
    lo, hi = pos.min(0)[:, None], pos.max(0)[:, None]
    ko, kd, kt_max = _random_rays(torch, RANDOM_RAYS, dev, seed=2, lo=lo,
                                  hi=hi, t_far=float(np.linalg.norm(hi - lo)))
    k3_plain_r, k3_plain_ms = _time_once(
        torch, lambda: k3_plain(ko, kd, r_tmin, kt_max))
    k3a_plain_r, k3a_plain_ms = _time_once(
        torch, lambda: k3_plain(ko, kd, r_tmin, kt_max, True))
    k3_err, k3_ulps, k3a_bad = 0.0, 0, 0
    for name, (o, d), (t_min, t_max) in (
            ("primary 512^2", k_primary, p_win),
            ("random", (ko, kd), (r_tmin, kt_max))):
        got = k3(o, d, t_min, t_max)
        got_a = k3(o, d, t_min, t_max, any_hit=True)
        if o is ko:
            want, want_a = k3_plain_r, k3a_plain_r
        else:
            want = k3_plain(o, d, t_min, t_max)
            want_a = k3_plain(o, d, t_min, t_max, any_hit=True)
        scan = knot_scan(o, d, t_min, t_max)
        torch.cuda.synchronize()
        for ref_name, ref in (("streamed twin", want), ("chunk scan", scan)):
            ulps, err, hit = _check_closest(f"K3 {name} vs {ref_name}", got,
                                            ref)
            k3_ulps, k3_err = max(k3_ulps, ulps), max(k3_err, err)
        for ref_name, ref in (("streamed twin", want_a["tri"] >= 0),
                              ("chunk scan", scan["tri"] >= 0)):
            bad = int(((got_a["tri"] >= 0) != ref).sum())
            k3a_bad = max(k3a_bad, bad)
            if bad:
                raise AssertionError(f"K3 any-hit {name} vs {ref_name}: "
                                     f"occlusion differs on {bad} lanes")
        if not torch.equal(got_a["t"], t_max):
            raise AssertionError(f"K3 any-hit {name}: t is not t_max")
        print(f"K3: on the knot's {name} rays ({hit:.3f} hit) closest-hit "
              f"equals the streamed twin and the chunk scan: tri equal on "
              f"every lane, t max {k3_ulps} ulps (bound {T_ULPS}), max "
              f"|dt| {k3_err:.3g}; any-hit occlusion equal, t = t_max",
              flush=True)
    k3a_err = float(k3a_bad > 0)   # max |flag difference|

    # K3 beside K1 on the same scene and rays
    for name, (o, d), (t_min, t_max) in (
            ("primary 512^2", k_primary, p_win),
            (f"{TIMED_RAYS[0]} random", (ko[:, :TIMED_RAYS[0]].contiguous(),
                                        kd[:, :TIMED_RAYS[0]].contiguous()),
             (r_tmin[:TIMED_RAYS[0]], kt_max[:TIMED_RAYS[0]])),
            (f"{RANDOM_RAYS} random", (ko, kd), (r_tmin, kt_max))):
        t = [_time_ms(torch, lambda a=a: fn(o, d, t_min, t_max, a), 10)
             for fn in (k3, k1_knot) for a in (False, True)]
        timings[("k3", name)] = t
        print(f"timing knot {name} rays: closest K3 {t[0]:.4f} ms vs K1 "
              f"{t[2]:.4f} ms; any K3 {t[1]:.4f} ms vs K2 {t[3]:.4f} ms "
              f"[{card}]", flush=True)
    print(f"timing knot {RANDOM_RAYS} random rays, plain: streamed twin "
          f"closest {k3_plain_ms:.4f} ms, any {k3a_plain_ms:.4f} ms [{card}]",
          flush=True)

    def k3_bounds(o, d, t_min, t_max, closest, occluded):
        """K3's closest- and any-hit bounds on these rays and answers."""
        io = _nbytes(o, d, t_min, t_max, knot.tri_planes,
                     knot.chunk_aabb) + o.shape[1] * 8
        tests = _flat_tests(trace_api, knot, o, d, t_min,
                            _window(torch, closest, t_max))[0]
        tests_a = int(occluded.sum()) + _flat_tests(
            trace_api, knot, o, d, t_min,
            torch.where(occluded, 0.0, t_max))[0]
        return (tests, _bound(tests * MT_FLOPS, io),
                tests_a, _bound(tests_a * MT_FLOPS, io))

    k3_ptxas = _ptxas_of(ptxas, "stream_kernel")
    p_scan = knot_scan(*k_primary, *p_win)
    for name, rays, closest, occluded in (
            ("primary 512^2", (*k_primary, *p_win), p_scan,
             p_scan["tri"] >= 0),
            (f"{RANDOM_RAYS} random", (ko, kd, r_tmin, kt_max), k3_plain_r,
             k3a_plain_r["tri"] >= 0)):
        tests, bound, tests_a, bound_a = k3_bounds(*rays, closest, occluded)
        t = timings[("k3", name)]
        print(f"bound knot {name} rays: K3 closest {t[0]:.4f} ms (K1 "
              f"{t[2]:.4f}) against {tests} tests, {bound[0]:.4f} ms "
              f"({bound[1]}); K3 any {t[1]:.4f} ms (K2 {t[3]:.4f}) against "
              f"{tests_a} tests, {bound_a[0]:.4f} ms ({bound_a[1]}); "
              f"MAX_UNITS {trace_stream.MAX_UNITS}, grp {grp}; ptxas K3 "
              f"{' | '.join(k3_ptxas) or 'cached'} [{card}]",
              flush=True)
    k3_bound, k3a_bound = bound, bound_a     # at the random rays
    del k3_plain_r, k3a_plain_r, p_scan

    # 10. knot frame: the streamed path
    dt, rays, k_launches, k_ldrs = _run_frames(
        torch, knot, dev, GALLERY_WARMUP, GALLERY_TIMED, "knot",
        on=stream_kernels, off=flat_kernels + inst_kernels)
    print("knot frame: " + _frame_line("dense knot ReSTIR", GALLERY_TIMED,
                                       dt, rays, k_launches, card,
                                       GALLERY_WARMUP + GALLERY_TIMED),
          flush=True)

    # 10b. the first knot frames through K1/K2, against K3's
    _swept_knot_phase(knot, dev, [x.cpu() for x in k_ldrs[:2]])
    knot_tri_table = knot.tri_table     # for phase 16
    del knot, k_ldrs

    # 11. bunny frame: a second flattened scene on K1/K2's route
    bunny = scenes.create_bunny_scene(dev)
    dt, rays, b_launches, _ = _run_frames(
        torch, bunny, dev, GALLERY_WARMUP, GALLERY_TIMED, "bunny",
        on=flat_kernels, off=stream_kernels + inst_kernels)
    print(f"bunny frame ({bunny.num_triangles} triangles): "
          + _frame_line("bunny ReSTIR", GALLERY_TIMED, dt, rays, b_launches,
                        card, GALLERY_WARMUP + GALLERY_TIMED), flush=True)

    # K3 beside K1/K2 on the bunny and Cornell (data for MXUF_MAX_TP; the
    # route keeps both on K1/K2)
    bo, bd, bt_max = _random_rays(torch, RANDOM_RAYS, dev, seed=3)
    for sname, s, (o, d), (t_min, t_max) in (
            ("bunny", bunny, primary_rays(bunny), p_win),
            ("bunny", bunny, (bo, bd), (r_tmin, bt_max)),
            ("Cornell", scene, primary, p_win),
            ("Cornell", scene, (ro, rd), (r_tmin, rt_max))):
        name = ("primary 512^2" if o.shape[1] == n_p
                else f"{RANDOM_RAYS} random")
        nc = s.chunk_aabb.shape[0]
        units = [trace_stream.stream_units(nc, m) for m in (
            trace_stream.MAX_UNITS, trace_api.SWEPT_MAX_UNITS)]
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
        t = [_time_ms(torch, lambda a=a: fn(*args, any_hit=a), 10)
             for fn in (trace_stream.trace_stream_kernel,
                        trace_api.trace_kernel) for a in (False, True)]
        print(f"timing {sname} {name} rays ({nc} chunks: K3 {units[0][1]} "
              f"units of {units[0][0]}, K1 {units[1][1]} units of "
              f"{units[1][0]}), K3 equal to K1/K2 on every lane: closest K3 "
              f"{t[0]:.4f} ms vs K1 {t[2]:.4f} ms; any K3 {t[1]:.4f} ms vs "
              f"K2 {t[3]:.4f} ms [{card}]", flush=True)

    # 12. K5 against its plain version and K1
    ray_sets = [("Cornell primary 512^2", scene, primary, p_win),
                (f"Cornell {RANDOM_RAYS} random", scene, (ro, rd),
                 (r_tmin, rt_max)),
                (f"bunny {RANDOM_RAYS} random", bunny, (bo, bd),
                 (r_tmin, bt_max))]
    k1_ref = {name: trace_api.trace_kernel(s.tri_planes, s.chunk_aabb, o, d,
                                           t_min, t_max)
              for name, s, (o, d), (t_min, t_max) in ray_sets}
    k5_ulps, k5_err = 0, 0.0
    for name, s, (o, d), (t_min, t_max) in ray_sets:
        got = trace_vpu.vpu_kernel(s.tri_planes, s.chunk_aabb, o, d, t_min,
                                   t_max)
        want = trace_vpu.trace_vpu_plain(
            s.tri_planes, *trace_vpu.vpu_worklists(
                s.chunk_aabb, V3(*o), V3(*d), t_min, t_max),
            V3(*o), V3(*d), t_min, t_max)
        torch.cuda.synchronize()
        for ref_name, ref in (("plain", want), ("K1", k1_ref[name])):
            ulps, err, hit = _check_closest(f"K5 {name} vs {ref_name}", got,
                                            ref)
            k5_ulps, k5_err = max(k5_ulps, ulps), max(k5_err, err)
        if not torch.equal(got["t"], k1_ref[name]["t"]):
            raise AssertionError(f"K5 {name}: t is not K1's bit for bit")
        units = trace_stream.stream_units(
            s.chunk_aabb.shape[0],
            32 if s.tri_planes.shape[2] <= trace_api.MXUF_MAX_TP else 64)
        print(f"K5: on {name} rays ({hit:.3f} hit, {units[1]} units of "
              f"{units[0]} chunks) equals its plain version and K1: tri "
              f"equal on every lane, t bit-equal to K1's, max "
              f"{k5_ulps} ulps from plain (bound {T_ULPS}), max |dt| "
              f"{k5_err:.3g}", flush=True)

    # 13. K6, each variant, against its plain version and K1
    tables = {"Cornell": trace_mxu.kernel_table(scene.tri_planes),
              "bunny": trace_mxu.kernel_table(bunny.tri_planes)}

    def k6_chunks(s, grp, incull, o, d, t_min, t_max):
        """The (lane, chunk) set the kernel tests, for the plain version."""
        return trace_mxu.lane_chunks(s.chunk_aabb, grp, incull, V3(*o),
                                     V3(*d), t_min, t_max)

    k6 = {}     # (variant, any_hit) -> max |dt| or flag error, timings
    for vname, _, grp, passes, incull, _ in MXU_VARIANTS:
        for any_hit in ((False, True) if incull else (False,)):
            key = (vname, any_hit)
            err = 0.0
            for name, s, (o, d), (t_min, t_max) in ray_sets:
                table = tables[name.split()[0]]
                g = grp or (2 if s.chunk_aabb.shape[0] <= 48 else 4)
                chunks = k6_chunks(s, g, incull, o, d, t_min, t_max)
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
                cmp_k1 = _compare(got, k1)
                _check_plain(f"K6 {vname} {name} vs plain", cmp, any_hit)
                if vname != "mxu1":
                    _check_agree(f"K6 {vname} {name} vs K1", cmp_k1, any_hit)
                err = max(err, float(cmp["hit_diff"] > 0) if any_hit
                          else cmp["abs"])
                print(f"K6 {vname}{' any-hit' if any_hit else ''} (grp {g}, "
                      f"{passes} pass{'es' if passes > 1 else ''}, "
                      f"{float(chunks.sum()) / chunks.shape[0]:.3f} chunks "
                      f"a lane) on {name} "
                      f"rays: vs plain hit {cmp['hit']:.6f} "
                      f"({cmp['hit_diff']} lanes), tri {cmp['tri']:.6f} "
                      f"({cmp['tri_diff']} lanes, margin "
                      f"{cmp['margin']:.3g}), t rel median "
                      f"{cmp['median']:.3g} max {cmp['max']:.3g}; vs K1 hit "
                      f"{cmp_k1['hit']:.6f} ({cmp_k1['hit_diff']} lanes), "
                      f"tri {cmp_k1['tri']:.6f} ({cmp_k1['tri_diff']} "
                      f"lanes, margin {cmp_k1['margin']:.3g})", flush=True)
            k6[key] = [err]

    # timing at all of Cornell's random rays, where K1's bound is taken:
    # each kernel, its plain version, and its route's whole call as
    # scene_trace makes it (no prepass on the card)
    c_rays = (ro, rd, r_tmin, rt_max)
    c_v3 = (V3(*ro), V3(*rd), r_tmin, rt_max)

    def route_ms(kernel, incull, any_hit=False):
        s = scenes.create_cornell_box(dev, kernel=kernel, incull=incull)
        return _time_ms(torch, lambda: trace_api.scene_trace(
            s, *c_v3, any_hit=any_hit), 20)

    k5_ms = _time_ms(torch, lambda: trace_vpu.vpu_kernel(
        scene.tri_planes, scene.chunk_aabb, *c_rays), 20)
    wl = trace_vpu.vpu_worklists(scene.chunk_aabb, *c_v3)
    k5_plain_ms = _time_ms(torch, lambda: trace_vpu.trace_vpu_plain(
        scene.tri_planes, *wl, *c_v3), 3)
    print(f"timing {RANDOM_RAYS} random Cornell rays: K5 {k5_ms:.4f} ms vs "
          f"K1 {timings[RANDOM_RAYS][0]:.4f} ms; vpu route (scene_trace) "
          f"{route_ms('vpu', False):.4f} ms; plain {k5_plain_ms:.4f} ms; "
          f"ptxas {' | '.join(_ptxas_entries(ptxas, 'vpu_kernel'))} "
          f"[{card}]", flush=True)
    c_io = (_nbytes(ro, rd, r_tmin, rt_max, tables["Cornell"],
                    scene.chunk_aabb) + RANDOM_RAYS * 8)
    for vname, mode, grp, passes, incull, _ in MXU_VARIANTS:
        g = grp or 2
        chunks = k6_chunks(scene, g, incull, *c_rays)
        for any_hit in ((False, True) if incull else (False,)):
            ms = _time_ms(torch, lambda: trace_mxu.mxu_kernel(
                tables["Cornell"], scene.chunk_aabb, *c_rays, g, passes,
                incull, any_hit), 20)
            plain_ms = _time_ms(torch, lambda: trace_mxu.trace_mxu_plain(
                tables["Cornell"], chunks, *c_v3, passes, any_hit), 3)
            tests, pairs = ((k2_tests, k2_pairs) if any_hit
                            else (k1_tests, k1_pairs))
            bound = _mxu_bound(tests, pairs, passes, c_io)
            k6[(vname, any_hit)] += [ms, plain_ms, bound]
            print(f"timing {RANDOM_RAYS} random Cornell rays: K6 {vname}"
                  f"{' any-hit' if any_hit else ''} {ms:.4f} ms vs "
                  f"{'K2' if any_hit else 'K1'} "
                  f"{timings[RANDOM_RAYS][2 if any_hit else 0]:.4f} ms; "
                  f"{mode}{' + cull' if incull else ''} route (scene_trace) "
                  f"{route_ms(mode, incull, any_hit):.4f} ms; plain "
                  f"{plain_ms:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]}) "
                  f"[{card}]", flush=True)
    print(f"ptxas K6: {' | '.join(_ptxas_entries(ptxas, 'mxu_kernel'))} "
          f"[{card}]", flush=True)

    # 14. the Cornell frame under each mode, against the same frame of
    # phase 5's default run
    ldr_default = c_ldrs[MODE_WARMUP + MODE_TIMED - 1].cpu().numpy()
    c_first = [x.cpu() for x in c_ldrs[:2]]      # for phase 17
    del c_ldrs
    mode_launches = {}

    def no_prepass(*args, **kwargs):
        raise AssertionError("a mode's CUDA route ran the worklist prepass")

    # the CUDA routes of the modes build their units in the kernel: in this
    # phase the prepass (ops/worklist.py) raises if anything calls it
    prepass = worklist.block_entry, worklist.worklists
    worklist.block_entry = worklist.worklists = no_prepass
    for mode, kernel, incull, any_hit, want in (
            ("vpu", "vpu", False, False, "vpu_closest_hit"),
            ("vpu", "vpu", False, True, "vpu_closest_hit"),
            ("mxu3", "mxu3", False, False, "mxu_closest_hit"),
            ("mxu1", "mxu1", False, False, "mxu_closest_hit"),
            ("mxuw8", "mxuw", False, False, "mxu_closest_hit"),
            ("incull", "mxuf2", True, False, "mxu_closest_hit"),
            ("incull", "mxuf2", True, True, "mxu_any_hit")):
        # one trace call, one kernel launch
        s = scenes.create_cornell_box(dev, kernel=kernel, incull=incull)
        trace_api.reset_launch_counts()
        trace_api.scene_trace(s, V3(*primary[0]), V3(*primary[1]), *p_win,
                              any_hit=any_hit)
        torch.cuda.synchronize()
        got = {k: v for k, v in trace_api.LAUNCHES.items() if v}
        if got != {want: 1}:
            raise AssertionError(f"{mode} {'any' if any_hit else 'closest'}"
                                 f"-hit scene_trace launched {got}, not "
                                 f"{{{want!r}: 1}}")
        if mode == "mxu1":
            # mxu1 renders no frame (the reference's own note: broken for
            # rendering); its launches are those of one scene_trace call
            mode_launches["mxu1"] = dict(trace_api.LAUNCHES)
    print(f"modes: one scene_trace call under vpu, mxu3, mxu1, mxuw and the "
          f"cull (closest and any) launches its kernel once and nothing "
          f"else, with no prepass", flush=True)
    for mode, kernel, incull, on, floor in (
            ("vpu", "vpu", False, vpu_kernels, VPU_DB),
            ("mxu3", "mxu3", False, ["mxu_closest_hit", "any_hit"],
             GOLDEN_DB),
            ("mxuw8", "mxuw", False, ["mxu_closest_hit", "any_hit"],
             GOLDEN_DB),
            ("incull", "mxuf2", True, mxu_kernels, GOLDEN_DB)):
        s = scenes.create_cornell_box(dev, kernel=kernel, incull=incull)
        dt, rays, m_launches, ldrs = _run_frames(
            torch, s, dev, MODE_WARMUP, MODE_TIMED, f"Cornell {mode}", on=on,
            off=[k for k in every if k not in (*on, *FRAME_SHADE)])
        p = _psnr(ldrs[-1].cpu().numpy(), ldr_default)
        if not p >= floor:
            raise AssertionError(f"Cornell {mode} frame: PSNR {p:.2f} dB "
                                 f"against the default frame < {floor}")
        mode_launches[mode] = m_launches
        print(f"mode frame {mode}: "
              + _frame_line(f"Cornell ReSTIR under {kernel}"
                            f"{' + in-kernel cull' if incull else ''}",
                            MODE_TIMED, dt, rays, m_launches, card,
                            MODE_WARMUP + MODE_TIMED)
              + f"; PSNR {p:.2f} dB against the default frame (floor "
              f"{floor})", flush=True)
    worklist.block_entry, worklist.worklists = prepass

    # 15. the 64^2 golden under mxu3
    m_psnr, ml_launches = _golden_psnr(
        torch, scenes.create_cornell_box(dev, kernel="mxu3"), dev, 64, 8,
        os.path.join(golden_dir, "cornell_64_f8_ldr.npy"))
    print(f"golden under mxu3: 64x64 Cornell, 8 frames: PSNR {m_psnr:.2f} dB "
          f"vs tests/golden/cornell_64_f8_ldr.npy, {_k7_line(ml_launches, 8)} "
          f"(floor {GOLDEN_DB})", flush=True)

    # 16. K7 against its plain version, beside one index_select call
    k7 = _gather_phase(torch, dev, card, (
        ("Cornell tri_table", scene.tri_table),
        ("Cornell mat_table", scene.mat_table),
        ("knot tri_table", knot_tri_table),
        ("gallery inst_table", gal_inst_table),
        ("restir light_table", restir.light_table)), GATHER_RAYS)

    # 17. the first Cornell frames with the plain fetch, against phase 5's
    _fetch_phase(torch, scene, dev, c_first)

    # 18. config 1: the 1-spp progressive diffuse Cornell box
    p_launches = _progressive_phase(torch, dev, card, WIDTH, HEIGHT,
                                    PROGRESSIVE_FRAMES)

    # 19. config 5: the denoised 3840 x 2160 screenshot as one frame
    s_launches = _screenshot_phase(torch, scene, dev, card, SHOT_W, SHOT_H,
                                   SHOT_FRAMES)

    # 20. config 4: the 1080p fly-through with the crystal refit each frame
    f_launches, f_frames = _flythrough_phase(torch, dev, card)

    # 21. the app, its screenshot, checkpoint and resume
    _app_phase(torch, root, dev, card)

    # 22. the procedural glTF stand-ins and the truffle app
    standins = _standins_phase(
        torch, root, dev, card,
        (flat_kernels, [k for k in every if k not in (*flat_kernels,
                                                      *FRAME_SHADE)]))

    # 23. the BVH walk: K8 past the cap and on the Cornell box forced to it
    k8, w_launches, w_frames, cw_launches, cw_frames = _walk_phase(
        torch, dev, card, every, c_first, ptxas)

    # 24. the frame over 4 row bands, against the one-device frame
    t_launches = _tiles_phase(torch, dev, card, every, c_fps, launches)

    # 25. the frame as CUDA graphs, against the eager frames
    gr_launches, gr_frames = _graph_phase(torch, dev, card, every)

    # 26. config 4 and the row bands replayed, against their eager frames
    (gf_launches, gf_frames), (gt_launches, gt_frames) = _graphs2_phase(
        torch, root, dev, card, every)

    # 27. batched spatial taps, and the subdivided Cornell box
    tb_launches, tb_frames, k2_stream, sd_launches, sd_frames = \
        _tap_batch_phase(torch, dev, card, every)

    # 28. the ray-stream reorder through render_band's ctx
    ro_launches, ro_frames, _, _ = _reorder_phase(torch, dev, card, every)


    n = TIMED_RAYS[-1]

    def entry(name, src, line, launched, err, times, bound):
        return {"name": name, "route": "cuda",
                "source": f"tpu_raytracer_torch/csrc/{src}",
                "replaces": f"tpu_raytracer/ops/pallas_trace.py:{line}",
                "launches": launched, "max_abs_err": err, "ms": times[0],
                "plain_ms": times[1], "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": None}

    k4_times = timings[("k4", n)]
    k3_times = timings[("k3", f"{RANDOM_RAYS} random")]
    k7_err, k7_ms, k7_plain, k7_lib, k7_bound = k7[("Cornell tri_table", n)]
    k7_frames = {
        "Cornell": (launches, WARMUP + TIMED), "golden Cornell": (gl_launches, 8),
        "golden restir": (rl_launches, 4),
        "gallery": (g_launches, GALLERY_WARMUP + GALLERY_TIMED),
        "knot": (k_launches, GALLERY_WARMUP + GALLERY_TIMED),
        "bunny": (b_launches, GALLERY_WARMUP + GALLERY_TIMED),
        **{f"mode {m}": (mode_launches[m], MODE_WARMUP + MODE_TIMED)
           for m in ("vpu", "mxu3", "mxuw8", "incull")},
        "golden mxu3": (ml_launches, 8),
        "config 1": (p_launches, PROGRESSIVE_FRAMES),
        "config 5": (s_launches, SHOT_FRAMES),
        "config 4": (f_launches, f_frames),
        **{f"stand-in {k}": v for k, v in standins.items()},
        "tiled Cornell (4 bands)": (t_launches, WARMUP + TIMED),
        "replayed Cornell (CUDA graph)": (gr_launches, gr_frames),
        "replayed config 4": (gf_launches, gf_frames),
        "replayed tiled Cornell (4 bands)": (gt_launches, gt_frames),
        "replayed Cornell, tap_batch": (tb_launches, tb_frames),
        "replayed subdivided Cornell": (sd_launches, sd_frames),
        **{f"Cornell reorder={m}": (ro_launches[m], ro_frames)
           for m in REORDER_MODES}}
    per_frame = {k: {"config 4": f_launches[k] / f_frames,
                     **{f"stand-in {n}": v[k] / f
                        for n, (v, f) in standins.items()},
                     "tiled Cornell (4 bands)": t_launches[k]
                     / (WARMUP + TIMED),
                     "replayed Cornell (CUDA graph)": gr_launches[k]
                     / gr_frames,
                     "replayed config 4": gf_launches[k] / gf_frames,
                     "replayed tiled Cornell (4 bands)": gt_launches[k]
                     / gt_frames,
                     "replayed Cornell, tap_batch": tb_launches[k]
                     / tb_frames,
                     "replayed subdivided Cornell": sd_launches[k]
                     / sd_frames,
                     **{f"Cornell reorder={m}": ro_launches[m][k] / ro_frames
                        for m in REORDER_MODES}}
                 for k in ("closest_hit", "any_hit")}
    print(json.dumps({"kernels": [
        {**entry("closest_hit", "trace.cu", 392, launches["closest_hit"],
                 k1_err, timings[n][:2], k1_bound),
         "launches_per_frame": per_frame["closest_hit"]},
        {**entry("any_hit", "trace.cu", 611, launches["any_hit"], k2_err,
                 timings[n][2:], k2_bound),
         "launches_per_frame": per_frame["any_hit"],
         "tap_stream": {"rays": k2_stream[0], "ms": k2_stream[1],
                        "plain_ms": k2_stream[2],
                        "bound_ms": k2_stream[3][0],
                        "bound_by": k2_stream[3][1],
                        "launches": tb_launches["any_hit"]}},
        entry("inst_closest_hit", "trace_inst.cu", 1916,
              g_launches["inst_closest_hit"], k4_err, k4_times[:2],
              k4_bound),
        entry("inst_any_hit", "trace_inst.cu", 1916,
              g_launches["inst_any_hit"], k4a_err, k4_times[2:], k4a_bound),
        entry("stream_closest_hit", "trace_stream.cu", 800,
              k_launches["stream_closest_hit"], k3_err,
              (k3_times[0], k3_plain_ms), k3_bound),
        entry("stream_any_hit", "trace_stream.cu", 800,
              k_launches["stream_any_hit"], k3a_err,
              (k3_times[1], k3a_plain_ms), k3a_bound),
        entry("vpu_closest_hit", "trace_vpu.cu", 1257,
              mode_launches["vpu"]["vpu_closest_hit"], k5_err,
              (k5_ms, k5_plain_ms), k1_bound),
        *(entry(f"mxu_{'any' if a else 'closest'}_hit[{v}]", "trace_mxu.cu",
                line, mode_launches[v][f"mxu_{'any' if a else 'closest'}_hit"],
                k6[(v, a)][0], k6[(v, a)][1:3], k6[(v, a)][3])
          for v, _, _, _, incull, line in MXU_VARIANTS
          for a in ((False, True) if incull else (False,))),
        *({"name": f"bvh_{q}_hit", "route": "cuda",
           "source": "tpu_raytracer_torch/csrc/trace_bvh.cu",
           "replaces": "tpu_raytracer/ops/traversal.py:28",
           "note": "the reference's walk is an XLA while_loop, not a "
                   "pallas_call",
           "launches": w_launches[f"bvh_{q}_hit"], "max_abs_err": 0.0,
           "ms": k8[("incoherent", a)][0],
           "plain_ms": k8[("incoherent", a)][1],
           "bound_ms": k8[("incoherent", a)][2][0],
           "bound_by": k8[("incoherent", a)][2][1], "library_ms": None,
           "walk_steps": k8[("incoherent", a)][3],
           "launches_per_frame": {
               "big scene": w_launches[f"bvh_{q}_hit"] / w_frames,
               "Cornell brute_max=1": cw_launches[f"bvh_{q}_hit"]
               / cw_frames}}
          for q, a in (("closest", False), ("any", True))),
        {"name": "path_shade", "route": "cuda",
         "source": "tpu_raytracer_torch/csrc/path_trace.cu",
         "replaces": None,
         "note": "K9 replaces no TPU kernel: the reference's path tracer "
                 "is XLA elementwise code; plain_ms is the port's eager "
                 "route, trace_path_plain, on the card",
         "launches": sum(launches[k] for k in PATH_K9),
         "launches_per_frame": {
             what: {k: v[k] / f for k in PATH_K9}
             for what, (v, f) in (
                 ("replayed Cornell (CUDA graph)", (gr_launches, gr_frames)),
                 ("replayed config 4", (gf_launches, gf_frames)),
                 ("replayed tiled Cornell (4 bands)",
                  (gt_launches, gt_frames)))},
         "max_abs_err": max(v[3] for v in k9.values()),
         "ms": k9[("Cornell", "candidates")][0],
         "plain_ms": k9[("Cornell", "candidates")][2],
         "bound_ms": k9[("Cornell", "candidates")][1], "bound_by": "bytes",
         "library_ms": None},
        {"name": "post", "route": "cuda",
         "source": "tpu_raytracer_torch/csrc/post.cu",
         "replaces": None,
         "note": "K10 replaces no TPU kernel: the reference's post pass is "
                 "XLA elementwise and roll code; plain_ms is the port's "
                 "eager route, post_process_plain, on the card",
         "launches": launches["post"],
         "launches_per_frame": {
             "replayed Cornell (CUDA graph)": k10["per_frame"][0],
             "replayed tiled Cornell (4 bands)": k10["per_frame"][1]},
         "max_abs_err": k10["max_abs_err"],
         "ms": k10["times"]["Cornell still"][0],
         "plain_ms": k10["times"]["Cornell still"][2],
         "bound_ms": k10["times"]["Cornell still"][1], "bound_by": "bytes",
         "library_ms": None},
        {"name": "table_gather", "route": "cuda",
         "source": "tpu_raytracer_torch/csrc/gather.cu",
         "replaces": "tpu_raytracer/ops/pallas_gather.py:51",
         "launches": launches["table_gather"],
         "max_abs_err": max(v[0] for v in k7.values()), "ms": k7_ms,
         "plain_ms": k7_plain, "bound_ms": k7_bound[0],
         "bound_by": k7_bound[1], "library_ms": k7_lib,
         "launches_per_frame": {k: v["table_gather"] / f
                                for k, (v, f) in k7_frames.items()}},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
