"""An XFEAT stereo session in both packages with the same weights (the
JAX package's ``PRNGKey(0)`` draws carried across), as
tests/test_torch_slice_learned.py runs ORB2_HARDNET: the 240x320 line
stream of tests/test_slam_e2e.py, 20 frames, 300 keypoint slots.  XFeat's
keypoints come from its own score map, identical in both packages, so the
port is held to the reference's frames tracked, resets and keyframes
exactly, and its ATE within 1e-3 m.
"""

import numpy as np
import pytest

from tests.test_torch_slice_learned import two_package_sessions

ATE_TOL = 1e-3


@pytest.fixture(scope="module")
def runs():
    return two_package_sessions("XFEAT")


def test_same_frames_resets_and_keyframes(runs):
    ref, got = runs
    assert got["tracked"] == ref["tracked"] and len(ref["tracked"]) >= 2
    assert got["resets"] == ref["resets"]
    assert got["keyframes"] == ref["keyframes"], (ref, got)


def test_ate_against_the_reference(runs):
    ref, got = runs
    assert np.isfinite(got["ate"]) and abs(got["ate"] - ref["ate"]) <= ATE_TOL, (ref, got)
