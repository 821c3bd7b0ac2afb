"""The program's eager frame on the CPU, in the call shape of the
harness's CUDA frame path (`run.GraphFrame`), so the tests drive a whole
run without a card; and the faults the check must catch, planted in it."""

from __future__ import annotations

import torch

from tpu_raytracer_torch.ops import refit as refit_ops
from tpu_raytracer_torch.ops import trace_api
from tpu_raytracer_torch.render import pipeline


class EagerFrame:
    def __init__(self, scene, traffic, devices):
        self.base = self.scene = scene
        self.traffic = traffic
        self.state = pipeline.init_state(traffic["width"], traffic["height"],
                                         devices[0])

    def render(self, uniform, frame_count, static_ok, transforms):
        t = self.traffic
        if transforms is not None:
            self.scene = refit_ops.update_instances(
                self.base, torch.as_tensor(transforms),
                changed=tuple(t["refit"]["ids"]))
        return pipeline.render_frame(
            self.scene, uniform, frame_count, self.state, t["width"],
            t["height"], static_ok=static_ok, gb_reuse=t["gb_reuse"],
            tap_batch=t["tap_batch"])

    def __call__(self, uniform, frame_count, static_ok, transforms):
        ldr, hdr, self.state, aux = self.render(uniform, frame_count,
                                                static_ok, transforms)
        return ldr, hdr, self.state, aux

    def refit_fields(self):
        return {k: getattr(self.scene, k).clone() for k in (
            "tri_planes", "chunk_aabb", "tri_table", "inst_transform",
            "inst_normal_mat")}

    @staticmethod
    def whole(state):
        return {k: v.clone() for k, v in state.items()}


class StateUnchanged(EagerFrame):
    """A frame that hands back the state it started from."""

    def __call__(self, uniform, frame_count, static_ok, transforms):
        ldr, hdr, _, aux = self.render(uniform, frame_count, static_ok,
                                       transforms)
        return ldr, hdr, self.state, aux


class RefitSkipped(EagerFrame):
    """A frame that leaves the moved instances where they were: the
    scene's refit state unchanged."""

    def render(self, uniform, frame_count, static_ok, transforms):
        return super().render(uniform, frame_count, static_ok, None)


class HalfBatch(EagerFrame):
    """A frame that renders the top half of its rows and leaves the rest
    out: black there, the state as it was."""

    def __call__(self, uniform, frame_count, static_ok, transforms):
        ldr, hdr, new, aux = self.render(uniform, frame_count, static_ok,
                                         transforms)
        half = ldr.shape[0] // 2
        ldr, hdr = ldr.clone(), hdr.clone()
        ldr[half:] = 0.0
        hdr[half:] = 0.0
        for k, v in new.items():
            v[half:] = self.state[k][half:]
        self.state = new
        return ldr, hdr, self.state, aux


def altered_answers(every: int = 16):
    """A patch of the program's queries that turns every `every`-th
    lane's answer into a miss where the answers are produced
    (`trace_api._route`); returns a function that undoes it."""
    real = trace_api._route

    def route(*args, **kwargs):
        res = dict(real(*args, **kwargs))
        tri = res["tri"].clone()
        tri[::every] = -1
        res["tri"] = tri
        res["t"] = torch.where(tri < 0, trace_api.INF, res["t"])
        return res

    trace_api._route = route

    def undo():
        trace_api._route = real
    return undo


class EagerBands:
    """The app's `--tiles N` path on the CPU: N row bands as threads
    (`parallel/tiles.py:make_render_frame_tiled`), the eager counterpart
    of the harness's `BandsFrame`."""

    def __init__(self, scene, traffic, devices, bands: int = 4):
        from tpu_raytracer_torch.parallel import tiles
        self.tiles = tiles
        mesh = tiles.make_mesh([devices[0]] * bands)
        self.traffic = traffic
        self.scene = tiles.replicate(scene, mesh)
        self.frame = tiles.make_render_frame_tiled(
            mesh, traffic["width"], traffic["height"], traffic["halo"],
            tap_batch=traffic["tap_batch"])
        self.state = tiles.shard_state(pipeline.init_state(
            traffic["width"], traffic["height"], devices[0]), mesh)

    def __call__(self, uniform, frame_count, static_ok, transforms):
        ldr, hdr, self.state, aux = self.frame(
            self.scene, uniform, frame_count, self.state, static_ok,
            gb_reuse=self.traffic["gb_reuse"])
        return ldr, hdr, self.state, aux

    def whole(self, state):
        return self.tiles.gather_state(state)


class BandsWithoutExchange(EagerBands):
    """Row bands whose halo exchange is left out: each band reads zeros
    where its neighbours' rows belong."""

    def __call__(self, uniform, frame_count, static_ok, transforms):
        from tpu_raytracer_torch.parallel import views
        real = views.halo_exchange

        class Silent:
            """Meets the neighbours at the exchange, keeps nothing."""

            def __init__(self, exchange):
                self.exchange, self.n = exchange, exchange.n

            def __call__(self, top, bottom):
                above, below = self.exchange(top, bottom)
                return torch.zeros_like(above), torch.zeros_like(below)

        def no_exchange(flat, width, band_h, halo, exchange, y0):
            return real(flat, width, band_h, halo, Silent(exchange), y0)

        views.halo_exchange = no_exchange
        try:
            return super().__call__(uniform, frame_count, static_ok,
                                    transforms)
        finally:
            views.halo_exchange = real
