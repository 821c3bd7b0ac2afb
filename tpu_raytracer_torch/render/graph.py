"""A frame as one CUDA graph: the port's counterpart of the reference's
`jax.jit(..., donate_argnums=(3,))` on `render/pipeline.py:render_frame`
and `render/renderer.py:render_progressive`.

Run eagerly, a 512^2 frame is ~29,500 launches that the host dispatches
one by one while the card idles (PERF.md §5). A `FrameGraph` captures the
whole frame once and replays it: one host call a frame.

  - Static inputs: the camera uniform's tensors, `frame_count` as a 0-dim
    int64 tensor, and the frame state (the ReSTIR state dict, or the
    progressive frame's {"accum"}). A call copies its inputs into them.
  - Donation: the captured frame ends by copying its new state into the
    static state, so the state is updated in place, as donation does.
  - One graph per (static_ok, reuse of the G-buffer, refit), each
    captured on first use, all in one memory pool. Batched spatial taps
    (`tap_batch`) are the FrameGraph's, not a key: one graph holds one
    mode.
  - The scene is read through the addresses captured: a new scene needs a
    new FrameGraph. Moving instances is config 4's refit, captured with
    the frame (`refit_changed`): the graph owns a copy of the scene's
    refit fields and writes the refit into them in place
    (`ops/refit.py:update_instances_`), from a static transforms buffer,
    before the frame reads them; the caller's scene is never written.
  - Stage marks (`utils/profiling.py:stage`): each graph captures its
    frame's marks with a stamp row of its own, which every replay
    overwrites; `stage_ms` reads the last replay's.

Nothing falls back: a frame that reads the device from the host, or any
other capture error, raises.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import refit, trace_api
from ..utils import profiling
from . import pipeline, renderer

# eager frames on a side stream before a capture, as torch.cuda.graph
# asks: what initialises lazily (kernel modules, allocator pools) must
# not do so inside the capture
WARMUP_ITERS = 2


class FrameGraph:
    """The ReSTIR frame (`pipeline.render_frame`) or, with `progressive`,
    the progressive frame (`renderer.render_progressive`) of one scene at
    one size on one CUDA device, replayed from CUDA graphs. `state` is
    the static frame state: `load_state` copies a saved one in.

    refit_changed: the ids of the instances a frame may move (a tuple),
    or "all"; then `self.scene` is a copy of `scene` whose refit fields
    the graph owns, and a call with `transforms` refits them before its
    frame (config 4). The changed ids resolve on the host here, once.
    tap_batch: every ReSTIR frame batches its spatial taps, as
    `pipeline.render_frame(tap_batch=True)` does."""

    def __init__(self, scene, width: int, height: int, device,
                 progressive: bool = False, refit_changed=None,
                 tap_batch: bool = False):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"FrameGraph captures CUDA graphs; {device} is "
                             f"not a CUDA device")
        self.changed = self.transforms = self._indices = None
        if refit_changed is not None:
            scene = dataclasses.replace(scene, **{
                name: getattr(scene, name).clone()
                for name in refit.refit_fields(scene)})
            self.transforms = scene.inst_transform.clone()
            if refit_changed != "all":
                self.changed = tuple(sorted(refit_changed))
                if self.changed and not scene.instanced:
                    # resolved on the host now; the graph keeps the
                    # indices it captures
                    self._indices = refit.changed_indices(scene,
                                                          self.changed)
        self.scene, self.width, self.height = scene, width, height
        self.device, self.progressive = device, progressive
        self.tap_batch = tap_batch
        self.state = ({"accum": renderer.make_accum(width, height, device)}
                      if progressive
                      else pipeline.init_state(width, height, device))
        self.frame_count = torch.zeros((), dtype=torch.int64, device=device)
        self.camera = None
        self._pool = torch.cuda.graph_pool_handle()
        # (static_ok, reuse, refit) -> (graph, its outputs, its launches,
        # its stamps)
        self._graphs = {}
        self._last = None       # the key of the last replay

    def load_state(self, state: dict) -> None:
        """Copy `state` (keys of `self.state`) into the static state."""
        for k, v in self.state.items():
            v.copy_(torch.as_tensor(state[k]))

    def _render(self, state, static_ok: bool, reuse: bool, moved: bool):
        """One frame from the static inputs, the refit first where
        `moved`: (new state, outputs)."""
        if moved:
            with profiling.stage("refit"):
                refit.update_instances_(self.scene, self.transforms,
                                        self.changed)
        if self.progressive:
            accum, radiance = renderer.render_progressive(
                self.scene, self.camera, self.frame_count, state["accum"],
                self.width, self.height)
            return {"accum": accum}, (radiance,)
        ldr, hdr, new_state, aux = pipeline.render_frame(
            self.scene, self.camera, self.frame_count, state, self.width,
            self.height, static_ok=static_ok, gb_reuse=reuse,
            tap_batch=self.tap_batch)
        return new_state, (ldr, hdr, aux)

    def _capture(self, key):
        trace_api.load_kernels()
        # the warm-up launches for real, so it renders a scratch copy of
        # the state: the caller's state advances only through replays
        scratch = {k: v.clone() for k, v in self.state.items()}
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), profiling.marking(self.device):
            for _ in range(WARMUP_ITERS):
                self._render(scratch, *key)
        torch.cuda.current_stream(self.device).wait_stream(side)
        del scratch
        graph = torch.cuda.CUDAGraph()
        stamps = profiling.Stamps(self.device)
        with trace_api.captured_launches() as launches, \
                profiling.marking(self.device, stamps):
            with torch.cuda.graph(graph, pool=self._pool):
                new_state, outs = self._render(self.state, *key)
                with profiling.stage("state_copy"):
                    for k, v in self.state.items():
                        v.copy_(new_state[k])
        self._graphs[key] = (graph, outs, dict(launches), stamps)

    def __call__(self, camera: dict, frame_count, static_ok: bool = False,
                 gb_reuse: bool = False, transforms=None):
        """One frame: camera is a device uniform
        (`renderer.camera_to_device`), frame_count a Python int or a 0-dim
        int64 tensor; static_ok and gb_reuse as `pipeline.render_frame`
        takes them (the progressive frame ignores both); transforms, on a
        graph made with `refit_changed`: every instance's [I, 3, 4] or
        [I, 4, 4] affine, as `refit.update_instances` takes them, which
        the replay refits the scene to before its frame. Returns
        (ldr, hdr, state, aux) as render_frame does, or (accum, radiance)
        as render_progressive does; `state` and `accum` are the static
        state, and ldr, hdr and radiance are graph buffers that the next
        call overwrites, so a caller that keeps a frame clones it. aux is
        a copy of the graph's."""
        moved = transforms is not None
        if moved and self.transforms is None:
            raise ValueError("transforms given to a FrameGraph made without "
                             "refit_changed")
        with profiling.span("frame.call"), torch.cuda.device(self.device):
            with profiling.span("frame.inputs"):
                if moved:
                    self.transforms.copy_(torch.as_tensor(
                        transforms, dtype=torch.float32)[:, :3, :4])
                if self.camera is None:
                    self.camera = {k: v.clone() for k, v in camera.items()}
                else:
                    for k, v in self.camera.items():
                        v.copy_(camera[k])
                if isinstance(frame_count, torch.Tensor):
                    self.frame_count.copy_(frame_count)
                else:
                    self.frame_count.fill_(frame_count)
            key = ((False, False, moved) if self.progressive
                   else (bool(static_ok), bool(gb_reuse and static_ok),
                         moved))
            if key not in self._graphs:
                self._capture(key)
            graph, outs, launches, _ = self._graphs[key]
            with profiling.span("frame.replay"):
                graph.replay()
            self._last = key
            trace_api.add_launches(launches)
            if self.progressive:
                return self.state["accum"], outs[0]
            ldr, hdr, aux = outs
            with profiling.span("frame.outputs"):
                aux = {k: v.clone() for k, v in aux.items()}
        return ldr, hdr, self.state, aux

    def stage_ms(self) -> list:
        """The last replay's device ms of each stage, from its stamps
        (`profiling.Stamps.ms`): one dict a card, so one here; [] before
        the first replay. Reads the device: call it once the frame has
        been waited for."""
        if self._last is None:
            return []
        return [self._graphs[self._last][3].ms()]
