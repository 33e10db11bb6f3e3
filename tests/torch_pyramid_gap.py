"""Measure what is left of the pyramid gap between the port and the JAX
package, on the CPU, with the reference run as the package runs (x64 off):

    JAX_PLATFORMS=cpu python -m tests.torch_pyramid_gap

For each level of a 376x1241 frame (a seeded random image and the synthetic
stream's frame) it prints the largest |port - reference| in grey levels,
the share of pixels that differ, whether the row pass is identical, and,
for the column pass alone (fed the reference's row pass), the share of
outputs that each fixed order reproduces: one fused multiply-add chain in
increasing input order (P = 1), or P interleaved chains by input index
mod P, summed pairwise (P = 2, 4).  Then the shares that the parity tests
hold to floors: identical keypoints and descriptor bits of a 240x320
extraction (``test_torch_orb2.py``) and of the tracking step from the
port's own features (``test_torch_tracking_step.py``).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from pyslam_tpu.io.dataset import SyntheticDataset  # noqa: E402
from pyslam_tpu.ops import image as jimage  # noqa: E402
from pyslam_tpu_torch.ops import image as timage  # noqa: E402

F32, F64 = np.float32, np.float64


def _column_pass(a: np.ndarray, wt: np.ndarray, p: int) -> np.ndarray:
    """a (h, K) @ wt (K, m) as p interleaved FMA chains (index mod p)."""
    out = np.zeros((a.shape[0], wt.shape[1]), F32)
    for o in range(wt.shape[1]):
        acc = [np.zeros(a.shape[0], F32) for _ in range(p)]
        for k in np.nonzero(wt[:, o])[0]:
            acc[k % p] = (a[:, k].astype(F64) * F64(wt[k, o]) + acc[k % p]).astype(F32)
        while len(acc) > 1:
            acc = [(acc[i] + acc[i + 1]).astype(F32) for i in range(0, len(acc), 2)]
        out[:, o] = acc[0]
    return out


def main():
    frame = SyntheticDataset(num_frames=2, h=376, w=1241, fx=718.856, baseline=0.54,
                             trajectory="line", step=0.8).getImage(1)
    images = {"random": np.random.default_rng(0).uniform(0, 255, (376, 1241)).astype(F32),
              "synthetic": np.asarray(frame, F32)}
    with jax.enable_x64(False):
        for name, img in images.items():
            h, w = img.shape
            ref = jax.jit(lambda im: jimage.build_pyramid(im, 8, 1.2))(jnp.asarray(img))
            got = timage.build_pyramid(torch.from_numpy(img), 8, 1.2)
            for lv in range(1, 8):
                r, g = np.asarray(ref[lv]), got[lv].numpy()
                hh, ww = r.shape
                wh = timage.resize_weights(h, hh).T.copy()
                rows_ref = np.asarray(jax.jit(lambda a, b: jax.lax.dot_general(
                    a, b, (((0,), (0,)), ((), ())), precision="highest"))(
                        jnp.asarray(wh), jnp.asarray(img)))
                rows = timage._resize_axis(torch.from_numpy(img), hh, 0,
                                           timage.depth_panel(h)).numpy()
                line = (f"{name} level {lv} {hh}x{ww}: max |port - ref| "
                        f"{np.abs(g - r).max():.3g}, differing {np.mean(g != r) * 100:.2f} %, "
                        f"row pass identical {np.array_equal(rows, rows_ref)}")
                if name == "random":
                    wt = timage.resize_weights(w, ww).T.copy()
                    shares = [np.mean(_column_pass(rows_ref, wt, p) == r) * 100
                              for p in (1, 2, 4)]
                    line += ", column pass reproduced by P=1/2/4: " + " / ".join(
                        f"{x:.2f} %" for x in shares)
                print(line, flush=True)


def shares():
    from tests import test_torch_orb2 as orb2
    from tests import test_torch_tracking_step as step

    frame = orb2.frame.__wrapped__()
    ref, got = orb2.single.__wrapped__(frame)
    same = orb2._same(ref, got)
    shared = same & ref.valid
    bits = got[5][shared] == ref.desc[shared]
    print(f"extraction 240x320: identical keypoints {same.mean() * 100:.2f} %, descriptor "
          f"bits {bits.mean() * 100:.2f} %, descriptors with a flipped bit "
          f"{np.mean(~bits.all(1)) * 100:.2f} %", flush=True)
    meta, _, _, ur, _ = orb2.stereo.__wrapped__(frame)
    both = (ur >= 0) & (meta[:, 7] >= 0) & (ur == meta[:, 7])
    either = (ur >= 0) | (meta[:, 7] >= 0)
    print(f"stereo 240x320: same right keypoint on {both.sum() / either.sum() * 100:.2f} % "
          f"of those either package matched", flush=True)
    _, _, (_, tf), jf, _ = step.both.__wrapped__()
    same_kp = np.all(jf.kps == tf.kps, 1)
    matched = same_kp & ((jf.points >= 0) | (tf.points >= 0))
    dt, dr = step._pose_err(jf.Tcw, tf.Tcw)
    print(f"tracking step, own features: identical keypoints {same_kp.mean() * 100:.2f} %, "
          f"same map point {(jf.points[matched] == tf.points[matched]).mean() * 100:.2f} %, "
          f"pose {dt * 100:.3f} cm / {dr:.2e} rad", flush=True)


if __name__ == "__main__":
    main()
    shares()
