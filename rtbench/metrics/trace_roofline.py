"""trace_roofline: the traversal kernels' share of their bytes roofline,
in %: the least time the frame's trace bytes need at the card's memory
bandwidth (`rtbench/peaks.py`), over trace_ms_per_frame.

The bytes are the work's, whatever kernel, route or number of launches
does it: each query's inputs read once (origin and direction, 3 f32
each; t_min and t_max, f32) and its answer written once (t f32, triangle
int32), and the scene's triangles (v0, e1, e2: 9 f32) read once by each
trace stage of the frame. The queries and stages are those the
reference counts in the frames it compares. Layer: trace. Moves fps."""

from rtbench import peaks

QUERY_BYTES = 4 * (3 + 3 + 1 + 1) + 4 + 4
TRIANGLE_BYTES = 4 * 9


def trace_bytes(queries: float, stages: float, triangles: int) -> float:
    """Bytes a frame's traversal must move at the least."""
    return queries * QUERY_BYTES + stages * triangles * TRIANGLE_BYTES


def read(run):
    from rtbench.cells import metric_reader
    ms = metric_reader("trace_ms_per_frame")(run)
    peak = peaks.hbm_bytes_per_s(run.device_kind)
    if ms is None or peak is None or not run.reference:
        return None
    ref = run.reference
    bound_s = trace_bytes(ref["queries_per_frame"], ref["stages_per_frame"],
                          ref["triangles"]) / peak
    return 100.0 * bound_s / (ms * 1e-3)
