"""halo_copy_ms_per_frame: device milliseconds a frame of the copies
between cards (the row bands' halo rows, `parallel/tiles.py:_Links.fill`
-> `parallel/views.py:halo_exchange`), summed over the cards. Layer: row
bands. Moves fps."""

import re

PEER = re.compile(r"PtoP|Peer", re.IGNORECASE)


def read(run):
    t = run.trace
    if t is None or t.frames == 0:
        return None
    ms = sum(b - a for n, _, a, b in t.copies if PEER.search(n)) * 1e3
    return ms / t.frames if ms > 0 else None
