"""One-call frontend step (port of ``pyslam_tpu/pipeline.py``).

ORB2 extraction of one image (its pyramid's FAST scores in one launch of
the CUDA kernel on the card, the plain version on the CPU), Hamming
matching against a local map with the ratio test, and motion-only LM pose
optimisation: the hot path of ``Tracking.track`` as one function.  Where the
reference compiles it into one XLA program, here it is a sequence of
PyTorch calls on the device of its inputs.
"""

from __future__ import annotations

import torch

from pyslam_tpu_torch.features.orb2 import FeatureData, extract_batch
from pyslam_tpu_torch.ops import hamming, matching, optim


def frontend_step(img, map_pos, map_desc, map_valid, Tcw_pred, K, num_features: int = 2000,
                  num_levels: int = 8, scale: float = 1.2, fast_th: float = 20.0, *,
                  device: torch.device | str = "cuda"):
    """Extract, match and optimise one frame.

    img (H, W) grey image; map_pos (M, 3) local-map points; map_desc (M,
    256) int8 bits; map_valid (M,); Tcw_pred (4, 4) the motion model's
    prediction; K (3, 3).  Arrays or tensors, moved to ``device`` (the
    card unless the caller asks for the CPU).  Returns (feats, the matched
    map row of each keypoint or -1, Tcw_opt, number of inliers)."""
    dev = torch.device(device)

    def put(x, dtype):
        return torch.as_tensor(x).to(device=dev, dtype=dtype)

    img = put(img, torch.float32)
    map_pos, map_desc = put(map_pos, torch.float32), put(map_desc, torch.int8)
    map_valid = put(map_valid, torch.bool)
    Tcw_pred, K = put(Tcw_pred, torch.float32), put(K, torch.float32)
    f = extract_batch(img[None], num_features, num_levels, scale, fast_th, 16, 6)
    feats = FeatureData(*[t[0] for t in f])

    dmat = hamming.hamming_distance_matrix(map_desc, feats.desc)
    idx, _ = matching.match_ratio_test(dmat, 100.0, ratio=0.9, valid_a=map_valid,
                                       valid_b=feats.valid)
    # each keypoint's matched map row (the cross-check makes them unique);
    # unmatched rows write -1 into a spare slot N
    M, N = map_pos.shape[0], feats.xy.shape[0]
    kp_match = torch.full((N + 1,), -1, dtype=torch.int64, device=dev)
    rows = torch.arange(M, device=dev)
    kp_match[torch.where(idx >= 0, idx, N)] = torch.where(idx >= 0, rows, -1)
    kp_match = kp_match[:N]
    pts3d = map_pos[torch.clamp(kp_match, 0, M - 1)]
    sigma2 = (scale ** feats.level.to(torch.float32)) ** 2
    Tcw_opt, _, n_inl = optim.pose_optimization(
        Tcw_pred, pts3d, feats.xy, torch.full((N,), -1.0, device=dev), sigma2,
        (kp_match >= 0) & feats.valid, K, bf=0.0)
    return feats, kp_match, Tcw_opt, n_inl
