"""The per-seed deviation of each package's float32 essential-matrix
inlier counts from the float64 count of the same minimal samples, on the
hypotheses ``tests/test_torch_epipolar.py`` keeps (its well-conditioned
ones), as that test holds them.

    JAX_PLATFORMS=cpu python -m tests.torch_essential_deviation

Prints, per seed: the valid points, the kept hypotheses, the largest and
mean deviation of the JAX package's count and of the port's, and the
largest difference between the two float32 counts (what the test held
before it was measured against float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pyslam_tpu.ops import epipolar as jepi
from pyslam_tpu_torch.ops import epipolar
from tests import test_torch_epipolar as T


def main():
    jax.config.update("jax_enable_x64", True)          # as the test suite runs
    for seed in T.SEEDS:
        xy1, xy2, valid = T._two_view(seed)
        s = T._ref_essential(seed, xy1, xy2, valid)[0]
        with jax.enable_x64(False):
            x1j, x2j = jnp.asarray(xy1), jnp.asarray(xy2)
            Es = jax.vmap(jepi._eight_point)(x1j[s], x2j[s])
            errs = jax.vmap(lambda E: jepi._sampson_error(E, x1j, x2j))(Es)
            ref = np.asarray(jnp.sum((errs < T.TH_E) & jnp.asarray(valid)[None], 1))
        st = torch.from_numpy(s.astype(np.int64))
        x1, x2, vt = torch.from_numpy(xy1), torch.from_numpy(xy2), torch.from_numpy(valid)[None]

        def count(a, b):
            E = epipolar._eight_point(a[st], b[st])
            return torch.sum((epipolar._sampson_error(E, a, b) < T.TH_E) & vt, 1).numpy()

        got, exact = count(x1, x2), count(x1.double(), x2.double())
        good = T._well_conditioned(epipolar._epipolar_rows(x1.double()[st], x2.double()[st]))
        dr, dp = np.abs(ref - exact)[good], np.abs(got - exact)[good]
        print(f"seed {seed}: {int(valid.sum())} valid, {int(good.sum())} kept; JAX package "
              f"largest {dr.max()} mean {dr.mean():.3f}; port largest {dp.max()} mean "
              f"{dp.mean():.3f}; JAX - port largest {np.abs(got - ref)[good].max()}")


if __name__ == "__main__":
    main()
