"""The spread of the SuperPoint trainer's quality floors over seeds and
data orders, on the card (chip_smoke.py 20a trains once, on the JAX
trainer's own draws: ``--indices tests/data/superpoint_reference_draws.npy``).

    PYTHONPATH=. python3 tests/torch_train_spread.py [--seeds 0,1,2,3] [--steps 1500]
        [--nondeterministic N] [--bundled] [--indices FILE.npy]

For each seed, trains ``pyslam_tpu_torch.models.train_superpoint`` at its
defaults (cuDNN's deterministic algorithms) and prints the floors of
tests/test_superpoint_trained.py on the result through the port's
extractor (``chip_smoke._superpoint_floors``): corner precision against
random weights, mutual matches and the descriptor inlier fraction.
``--nondeterministic N`` trains seed 0 N more times with cuDNN's default
algorithms (run to run the result moves); ``--bundled`` also prints the
floors of the JAX package's bundled ``superpoint_tiny.npz``.  ``--indices``
trains seed 0 once more on the batch indices of a (steps, 8) array, e.g.
the JAX trainer's own draws (``python -m tests.torch_jax_draws``).  ~20 s
a run.
"""

import argparse
import contextlib
import os
import tempfile

import numpy as np
import torch

import chip_smoke as cs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--nondeterministic", type=int, default=0)
    ap.add_argument("--bundled", action="store_true")
    ap.add_argument("--indices", default=None)
    args = ap.parse_args()
    from pyslam_tpu_torch import interop
    from pyslam_tpu_torch.models import train_superpoint as tsp
    from pyslam_tpu_torch.utils import device as device_utils

    dev = torch.device("cuda", 0)
    if args.bundled:
        print("bundled", cs._superpoint_floors(dev, interop.bundled_checkpoint("superpoint_tiny")),
              flush=True)
    runs = [(int(s), True) for s in args.seeds.split(",") if s]
    runs += [(0, False)] * args.nondeterministic
    indices = None if args.indices is None else np.load(args.indices)
    if indices is not None:
        runs.append((0, "indices"))
    with tempfile.TemporaryDirectory() as tmp:
        for seed, deterministic in runs:
            path = os.path.join(tmp, f"sp_{seed}.npz")
            saved = device_utils.deterministic_cudnn
            if deterministic is False:   # train() imports it at call time
                device_utils.deterministic_cudnn = contextlib.nullcontext
            try:
                state = tsp.train(steps=args.steps, seed=seed, device=dev, log_every=10 ** 9,
                                  indices=indices if deterministic == "indices" else None)
            finally:
                device_utils.deterministic_cudnn = saved
            tsp.save_checkpoint(path, state)
            how = {True: "deterministic", False: "default cuDNN",
                   "indices": f"deterministic, indices of {args.indices}"}[deterministic]
            print(f"seed {seed} {how}",
                  cs._superpoint_floors(dev, path), flush=True)


if __name__ == "__main__":
    main()
