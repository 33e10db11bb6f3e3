"""VLAD global descriptor over local descriptors, and the weight-free SAD
descriptor (port of ``pyslam_tpu/loop_closing/vlad.py``).

VLAD: K centres over the descriptor space; an image's descriptor is, per
centre, the sum of the residuals (descriptor - centre) of the descriptors
assigned to it (the nearest centre by ``|c|^2 - 2 d.c``, first index on
ties), intra-normalised (L2 per centre; an empty centre stays 0), then
globally L2-normalised.  The assignment is one (N, K) product and an
argmin, the residual sums a one-hot product.  ``VladVocabulary`` trains
its centres on the session: the first ``train_after`` keyframes'
descriptors seed 8 k-means rounds, drawn from ``np.random.default_rng``
in the reference's order, so both packages train the same centres from
the same descriptors but at near-ties of the float32 argmin.  Until then
a keyframe gets the reference's placeholder (the normalised mean
descriptor in centre 0's slot), and the loop closer re-describes the
stored keyframes once training fires (``consume_just_trained``).

SAD: the image average-pooled to 64x64, standardised, flattened and
L2-normalised (similarity by dot product).  Both run on the device of
their inputs (the vocabulary's ``device``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pyslam_tpu_torch.loop_closing.vocabulary import _host


def _assign(desc: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(N, D) float descriptors, (K, D) centres -> (N,) nearest centre ids
    (|d - c|^2 without |d|^2)."""
    c2 = torch.sum(centers * centers, 1)
    return torch.argmin(c2[None, :] - 2.0 * (desc @ centers.T), 1)


def vlad_descriptor(desc: torch.Tensor, valid: torch.Tensor,
                    centers: torch.Tensor) -> torch.Tensor:
    """(N, D) local descriptors -> (K * D,) VLAD vector."""
    k = centers.shape[0]
    desc = desc.to(torch.float32)
    onehot = F.one_hot(_assign(desc, centers), k).to(torch.float32)
    onehot = onehot * valid.to(torch.float32)[:, None]
    counts = onehot.sum(0)
    res = onehot.T @ desc - counts[:, None] * centers
    res = res / torch.clamp(torch.linalg.vector_norm(res, dim=1, keepdim=True), min=1e-12)
    res = torch.where(counts[:, None] > 0, res, torch.zeros_like(res))
    v = res.reshape(-1)
    return v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)


def _kmeans(desc: torch.Tensor, init: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` Lloyd rounds from ``init`` (K, D); an empty centre stays."""
    centers = init
    k = init.shape[0]
    for _ in range(iters):
        onehot = F.one_hot(_assign(desc, centers), k).to(torch.float32)
        counts = onehot.sum(0)[:, None]
        centers = torch.where(counts > 0, (onehot.T @ desc) / torch.clamp(counts, min=1.0),
                              centers)
    return centers


class VladVocabulary:
    """K centres trained on the session (the first ``train_after``
    keyframes' descriptors seed k-means), on ``device``."""

    def __init__(self, num_clusters: int = 64, seed: int = 5, train_after: int = 4, *,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self.k = num_clusters
        self.train_after = train_after
        self._buffer: list[np.ndarray] = []
        self._rng = np.random.default_rng(seed)
        self.centers: np.ndarray | None = None
        self._centers_dev = None
        self._just_trained = False
        # the reference's draw for its procedural init (kept: later draws
        # follow it)
        self._init_centers = self._rng.uniform(0, 1, None)

    @property
    def trained(self) -> bool:
        return self.centers is not None

    def _set_centers(self, centers: np.ndarray):
        self.centers = np.asarray(centers, np.float32)
        self._centers_dev = torch.from_numpy(self.centers).to(self.device)

    def consume_just_trained(self) -> bool:
        """True exactly once, right after training fired."""
        jt = self._just_trained
        self._just_trained = False
        return jt

    def maybe_train(self, desc):
        """Accumulate host descriptors; train once enough keyframes were
        seen (k-means on the device)."""
        if self.trained:
            return
        self._buffer.append(np.asarray(_host(desc), np.float32))
        if len(self._buffer) >= self.train_after:
            data = np.concatenate(self._buffer, axis=0)
            sel = self._rng.choice(len(data), size=min(self.k, len(data)), replace=False)
            init = data[sel]
            if len(sel) < self.k:                # degenerate tiny session
                init = np.concatenate([init, np.tile(init[:1], (self.k - len(sel), 1))], 0)
            dev = self.device
            self._set_centers(_kmeans(torch.from_numpy(data).to(dev),
                                      torch.from_numpy(init).to(dev), 8).cpu().numpy())
            self._buffer.clear()
            self._just_trained = True

    def global_descriptor(self, desc, valid) -> np.ndarray:
        """A frame's (N, D) descriptors and (N,) valid mask (host arrays or
        tensors on the vocabulary's device) -> the host (K * D,) vector."""
        if not self.trained:
            d, m = np.asarray(_host(desc), np.float32), _host(valid).astype(bool)
            self.maybe_train(d[m])
            if not self.trained:
                # the placeholder at full dimensionality: the normalised mean
                # descriptor in centre 0's slot
                v = d[m].mean(axis=0) if m.any() else d.mean(0)
                n = np.linalg.norm(v)
                out = np.zeros((self.k * d.shape[1],), np.float32)
                out[: d.shape[1]] = v / n if n > 0 else v
                return out
        dev = self.device
        desc = torch.as_tensor(desc).to(dev)
        valid = torch.as_tensor(valid).to(dev)
        return vlad_descriptor(desc, valid, self._centers_dev).cpu().numpy()

    def to_json(self):
        return {"k": self.k,
                "centers": None if self.centers is None else self.centers.tolist()}

    @staticmethod
    def from_json(d, *, device: torch.device | str = "cuda") -> "VladVocabulary":
        v = VladVocabulary(num_clusters=d["k"], device=device)
        if d.get("centers") is not None:
            v._set_centers(np.asarray(d["centers"], np.float32))
        return v


def sad_descriptor(img: torch.Tensor) -> torch.Tensor:
    """(H, W) image -> the unit SAD vector: 64x64 average pool,
    standardisation (population std, floor 1e-6), L2."""
    h, w = img.shape
    gh, gw = 64, 64
    ph, pw = max(h // gh, 1), max(w // gw, 1)
    x = img[: ph * gh, : pw * gw].reshape(gh, ph, gw, pw).mean(dim=(1, 3))
    x = (x - x.mean()) / torch.clamp(x.std(correction=0), min=1e-6)
    v = x.reshape(-1)
    return v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)
