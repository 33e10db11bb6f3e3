"""The CPU witness of chip_smoke.py's phase 13: the main stage's 60 stereo
frames (376x1241) written as a KITTI sequence with chip_smoke.py's
settings and config.yaml, then a package's ``main_slam`` run on it with
``--config`` (and ``--volumetric`` unless ``--no-volumetric``).

    JAX_PLATFORMS=cpu python -m tests.torch_entry_witness --package jax [--out DIR]
    python -m tests.torch_entry_witness --package port [--out DIR]

``--package jax`` runs the JAX package's root ``main_slam.py`` (x64 off,
as it runs outside the tests); ``port`` runs ``pyslam_tpu_torch.main_slam``
with ``--device cpu``.  Prints the run's last lines (tracked frames, loops,
ATE).  The frames are rendered by worker processes.
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def render_stereo(first, last):
    """Frames [first, last) of the main stage's stream (a worker process)."""
    ds = cs.bench_stream()
    return [(ds.getImage(i), ds.getImageRight(i), ds.getTimestamp(i))
            for i in range(first, last)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=["jax", "port"], required=True)
    ap.add_argument("--out", default=None, help="folder for the sequence (default: a temp dir)")
    ap.add_argument("--no-volumetric", action="store_true")
    args = ap.parse_args()
    root = args.out or tempfile.mkdtemp(prefix="entry_witness_")
    t0 = time.time()
    cfg = os.path.join(root, "config.yaml")
    if not os.path.exists(cfg):
        frames = cs.render(render_stereo, cs.N_FRAMES)
        cfg = cs.write_kitti_sequence(root, frames, cs.bench_stream())
    print(f"[witness] sequence in {root} ({time.time() - t0:.1f} s)", flush=True)
    extra = [] if args.no_volumetric else ["--volumetric"]
    traj = os.path.join(root, f"trajectory_{args.package}.txt")
    if args.package == "jax":
        cmd = [sys.executable, os.path.join(ROOT, "main_slam.py"), "--config", cfg,
               "--save_trajectory", traj] + extra
    else:
        cmd = [sys.executable, "-m", "pyslam_tpu_torch.main_slam", "--config", cfg,
               "--save_trajectory", traj, "--device", "cpu"] + extra
    t0 = time.time()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    lines = [ln for ln in (res.stdout + res.stderr).splitlines()
             if ln.startswith(("done:", "loops closed", "ATE", "LOOP", "metrics", "Traceback",
                               "tracking failure", "relocalized"))
             or "Error" in ln]
    print("\n".join(lines))
    print(f"[witness] {args.package} main_slam --config: exit {res.returncode} in "
          f"{time.time() - t0:.1f} s", flush=True)
    return res.returncode


if __name__ == "__main__":
    raise SystemExit(main())
