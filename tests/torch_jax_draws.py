"""The JAX SuperPoint trainer's own batch draws, saved for the port.

    python -m tests.torch_jax_draws

``pyslam_tpu/models/train_superpoint.py::train`` draws each step's batch
indices on the device: ``key, k = jax.random.split(key)`` from
``PRNGKey(seed + 1)``, then ``jax.random.randint(k, (batch,), 0,
n_dataset)``.  The port's trainer draws from a ``torch.Generator`` and
takes injected ``indices``.  This writes the reference's draws at its
defaults (seed 0, 1500 steps, batch 8, 1024 pairs; JAX on the CPU, x64
off) to ``tests/data/superpoint_reference_draws.npy`` (int16, (1500, 8)),
which ``chip_smoke.py`` phase 20a feeds the port's trainer, so the card
trains on the reference's data order with nothing of JAX installed;
``tests/test_torch_trainers.py`` checks the file against JAX.
"""

import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "superpoint_reference_draws.npy")


def superpoint_draws(seed: int = 0, steps: int = 1500, batch: int = 8,
                     n_dataset: int = 1024) -> np.ndarray:
    import jax

    split = jax.jit(jax.random.split)
    randint = jax.jit(lambda k: jax.random.randint(k, (batch,), 0, n_dataset))
    with jax.enable_x64(False):
        key = jax.random.PRNGKey(seed + 1)
        out = []
        for _ in range(steps):
            key, k = split(key)
            out.append(np.asarray(randint(k)))
    return np.stack(out).astype(np.int16)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    draws = superpoint_draws()
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    np.save(PATH, draws)
    print(f"{PATH}: {draws.shape} {draws.dtype}")


if __name__ == "__main__":
    main()
