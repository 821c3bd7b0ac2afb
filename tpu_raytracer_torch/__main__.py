"""`python -m tpu_raytracer_torch` - the interactive app (main.rs).

    python -m tpu_raytracer_torch --scale=1280x720            # cuda:0
    python -m tpu_raytracer_torch --device cpu --scale=64x64  # plain CPU

The last line of its output is the run's telemetry as one JSON object:
fps and Mrays/s (FrameStats over the last 60 frames, the first frame
left out), the frames rendered and the kernel launches.
"""

import json

from .app import interactive
from .utils.config import parse_args


def main():
    print(json.dumps(interactive.run(parse_args())), flush=True)


if __name__ == "__main__":
    main()
