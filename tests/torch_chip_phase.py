"""One phase of chip_smoke.py on the card, alone: 8 (bench.py's loop stage)
or 12 (the weight-free feature presets).

    PYTHONPATH=. python3 tests/torch_chip_phase.py 8|12

Builds the kernels, renders the phase's frames as chip_smoke.py does and
runs its function for the phase; prints what the phase prints.  Run from
the root of a tree (the repository, or an unpacked ``git archive`` of
another commit, to compare two commits in one call on one card).
"""

import json
import subprocess
import sys
import time

import chip_smoke as cs


def main():
    import torch

    from pyslam_tpu_torch import _build
    from pyslam_tpu_torch.slam.camera import PinholeCamera

    phase = int(sys.argv[1])
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.load()
    ds = cs.bench_stream()
    t0 = time.time()
    if phase == 8:
        frames = cs.render(cs.render_loop_frames, cs.LOOP_FRAMES)
        cs.loop_phase(dev, (ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy), frames)
    elif phase == 12:
        cam = PinholeCamera(ds.w, ds.h, ds.fx, ds.fy, ds.cx, ds.cy, fps=ds.fps,
                            bf=ds.fx * ds.baseline, depth_threshold=35.0)
        frames = [(ds.getImage(i), ds.getImageRight(i), ds.getTimestamp(i))
                  for i in range(cs.N_FRAMES)]
        t0 = time.time()
        print(json.dumps({"features": cs.features_phase(dev, frames, cam, ds)}, default=float),
              flush=True)
    else:
        raise SystemExit(f"phase {phase}: only 8 and 12 run alone")
    print(f"phase {phase}: {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
