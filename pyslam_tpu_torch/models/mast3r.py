"""MASt3R-class two-view matching network (port of
``pyslam_tpu/models/mast3r.py``).

MASt3R is DUSt3R (``models.dust3r``: the shared CroCo encoder, the
entangled decoders, the linear pointmap heads) with a local-feature head
per view: the ``catmlp`` MLP over [final decoder token ; encoder token]
(``downstream_head{1,2}.head_local_features``), pixel-shuffled to
per-pixel unit descriptors (``desc_dim`` 24) and a descriptor confidence
``1 + exp``.  ``reciprocal_nn_matches`` takes the ``k`` most
descriptor-confident pixels of each view (ties to the lower index, as
``jax.lax.top_k``), one L2 distance matrix
(``ops.hamming.descriptor_distance_matrix``) and the mutual argmin (first
index on ties).  ``Mast3rExtractor`` is the MAST3R tracker preset's
per-image extraction: the two-view network on (img, img), the
``num_features`` most confident pixels (a stable sort) as keypoints.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from pyslam_tpu_torch.models.dust3r import Dust3rConfig, Dust3rModel, Dust3rNet, Mlp
from pyslam_tpu_torch.models.layers import feature_data, single_level
from pyslam_tpu_torch.ops import hamming
from pyslam_tpu_torch.ops.nms import _topk_stable


@dataclass
class Mast3rConfig(Dust3rConfig):
    desc_dim: int = 24


class Mast3rNet(Dust3rNet):
    def __init__(self, cfg: Mast3rConfig):
        super().__init__(cfg)
        c = cfg
        for head in (self.downstream_head1, self.downstream_head2):
            head.head_local_features = Mlp(c.dec_dim + c.enc_dim, c.dec_dim,
                                           c.patch * c.patch * (c.desc_dim + 1))

    def desc_head(self, dec, enc, head):
        """catmlp: MLP([dec ; enc]) -> pixel shuffle -> unit descriptors
        (H, W, desc_dim) and their confidence (H, W)."""
        D = self.cfg.desc_dim
        out = self.unshuffle(head.head_local_features(torch.cat([dec, enc], -1)), D + 1)
        desc = out[..., :D]
        desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-9)
        return desc, 1.0 + torch.exp(out[..., D])

    def forward(self, img1, img2):
        """img: (H, W, 3) in [-1, 1].  Returns per view (pts3d (H, W, 3),
        conf (H, W), desc (H, W, desc_dim), desc_conf (H, W))."""
        e1, e2, d1, d2 = self.trunk(img1, img2)
        h1, h2 = self.downstream_head1, self.downstream_head2
        return ((*self.pts_head(d1, h1), *self.desc_head(d1, e1, h1)),
                (*self.pts_head(d2, h2), *self.desc_head(d2, e2, h2)))


def reciprocal_nn_matches(desc1, conf1, desc2, conf2, k: int = 4096):
    """(H, W, D) descriptor maps and (H, W) confidences -> (pix1 (k,),
    pix2 (k,), mutual (k,)): flat pixel indices of the ``k`` most confident
    pixels of view 1, their nearest neighbours among view 2's ``k``, and
    whether the pair is mutual."""
    D = desc1.shape[-1]
    _, top1 = _topk_stable(conf1.reshape(-1), k)
    _, top2 = _topk_stable(conf2.reshape(-1), k)
    dm = hamming.descriptor_distance_matrix(desc1.reshape(-1, D)[top1],
                                            desc2.reshape(-1, D)[top2])
    nn12 = torch.argmin(dm, 1)
    nn21 = torch.argmin(dm, 0)
    mutual = nn21[nn12] == torch.arange(k, device=dm.device)
    return top1.to(torch.int32), top2[nn12].to(torch.int32), mutual


class Mast3rModel(Dust3rModel):
    """Two-view facade on ``device``: pointmaps, dense descriptors and
    matching."""

    net_class = Mast3rNet
    always_8bit = False

    @staticmethod
    def default_config():
        return Mast3rConfig()

    def match_pair(self, img1, img2, max_matches: int = 2000, conf_min: float = 1.05):
        """Dense reciprocal NN filtered by descriptor confidence -> (xy1,
        xy2, scores) host arrays at the network's resolution."""
        (_, _, d1, c1), (_, _, d2, c2) = self.infer_pair(img1, img2)
        pix1, pix2, mutual = (t.cpu().numpy() for t in reciprocal_nn_matches(
            d1, c1, d2, c2, k=min(4096, d1.shape[0] * d1.shape[1])))
        c1 = c1.cpu().numpy()
        W = d1.shape[1]
        keep = mutual & (c1.reshape(-1)[pix1] > conf_min)
        i1, i2 = pix1[keep], pix2[keep]
        if len(i1) > max_matches:
            order = np.argsort(-c1.reshape(-1)[i1], kind="stable")[:max_matches]
            i1, i2 = i1[order], i2[order]
        xy1 = np.stack([i1 % W, i1 // W], 1).astype(np.float32)
        xy2 = np.stack([i2 % W, i2 // W], 1).astype(np.float32)
        return xy1, xy2, c1.reshape(-1)[i1]


class Mast3rExtractor:
    """(H, W) image -> FeatureData on the model's device: the two-view
    network on (img, img), keypoints at the ``num_features`` most
    descriptor-confident pixels (stable order), mapped back to input
    pixels; size 16, level 0, the confidences as responses."""

    def __init__(self, model: Mast3rModel, num_features: int):
        single_level(self, num_features, model.device, model.trained)
        self.model = model

    def __call__(self, img) -> object:
        (_, _, d1, c1), _ = self.model.infer_pair(img, img)
        h_in, w_in = np.asarray(img).shape[:2]
        H, W = c1.shape
        n = self.num_features
        resp, flat = _topk_stable(c1.reshape(-1), min(n, H * W))
        k = flat.shape[0]
        xy = torch.stack([(flat % W).double() * (w_in / W),
                          (flat // W).double() * (h_in / H)], 1).to(torch.float32)
        pad = n - k

        def padded(x):
            return F.pad(x, (0, 0, 0, pad) if x.dim() == 2 else (0, pad))

        valid = padded(torch.ones(k, dtype=torch.bool, device=flat.device))
        return feature_data(padded(xy), padded(resp), valid,
                            padded(d1.reshape(-1, d1.shape[-1])[flat]), size=16.0)
