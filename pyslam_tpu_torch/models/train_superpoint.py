"""In-framework SuperPoint training (port of
``pyslam_tpu/models/train_superpoint.py``).

The reference runs the official ``superpoint_v1.pth`` checkpoint; with no
network and no mounted checkpoints, the framework trains its own small
SuperPoint-class checkpoint from scratch:

1. **Detector** (the MagicPoint stage): random synthetic shapes (quads,
   triangles, stars, line junctions, checkerboards) rendered with exact
   corner ground truth; a per-8x8-cell 65-way cross-entropy (64 cell
   positions + dustbin), corner cells weighted 8.
2. **Descriptor** (the SuperPoint stage): homography-warped image pairs and
   a dense cell-level hinge loss: descriptors of corresponding cells pulled
   together, non-corresponding ones pushed below a margin.

The shape renderer, the homographies and the batch maker are the JAX
package's numpy code, copied.  The data is rendered on the host and
uploaded once; each step samples its batch on the device, from an explicit
``torch.Generator`` seeded ``seed + 1`` (the reference draws
``jax.random.randint`` from a split ``PRNGKey(seed + 1)``) or from injected
``indices``.  The loss's gradient comes from autograd and the step is
``optax.adam``'s (``ops/adam.py``); convolutions run in float32 with TF32
off (the package's setting), as the serving path.  The architecture is the port's
``SuperPointNet``, so the checkpoint (the JAX package's flat names,
``interop.superpoint_flat``) loads through both packages' extractors.

    python -m pyslam_tpu_torch.models.train_superpoint [--device cpu]

writes ``pyslam_tpu_torch/models/checkpoints/superpoint_tiny.npz``
(``SP_TRAIN_STEPS``, ``SP_TRAIN_SEED``, ``SP_TRAIN_LR``,
``SP_TRAIN_DESC_WEIGHT`` and ``SP_TRAIN_RESUME=1`` as in the reference).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

H, W = 120, 160
HC, WC = H // 8, W // 8


# ---------------------------------------------------------------- rendering
def _draw_line(img, p0, p1, val):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) * 2
    t = np.linspace(0.0, 1.0, n)
    xs = np.clip(np.round(p0[0] + (p1[0] - p0[0]) * t).astype(int), 0, W - 1)
    ys = np.clip(np.round(p0[1] + (p1[1] - p0[1]) * t).astype(int), 0, H - 1)
    img[ys, xs] = val
    img[np.clip(ys + 1, 0, H - 1), xs] = val


def _fill_poly(img, pts, val):
    from numpy import minimum as mn

    ys, xs = np.mgrid[0:H, 0:W]
    inside = np.ones((H, W), bool)
    n = len(pts)
    ok = True
    for i in range(n):
        x0, y0 = pts[i]
        x1, y1 = pts[(i + 1) % n]
        cross = (x1 - x0) * (ys - y0) - (y1 - y0) * (xs - x0)
        inside &= cross >= 0
    if not inside.any():  # wrong winding
        inside = np.ones((H, W), bool)
        for i in range(n):
            x0, y0 = pts[i]
            x1, y1 = pts[(i + 1) % n]
            cross = (x1 - x0) * (ys - y0) - (y1 - y0) * (xs - x0)
            inside &= cross <= 0
    img[inside] = val
    return inside.any()


def render_shapes(rng: np.random.Generator):
    """One synthetic training image -> (img uint8 (H,W), corners (K,2) xy)."""
    img = np.full((H, W), float(rng.integers(30, 120)), np.float32)
    corners: list[tuple[float, float]] = []
    kind = rng.integers(0, 4)
    if kind == 0:  # random convex quads / triangles
        for _ in range(rng.integers(1, 4)):
            nv = int(rng.integers(3, 5))
            cx, cy = rng.uniform(25, W - 25), rng.uniform(20, H - 20)
            r = rng.uniform(8, 28)
            angs = np.sort(rng.uniform(0, 2 * np.pi, nv))
            pts = np.stack(
                [cx + r * np.cos(angs), cy + r * np.sin(angs)], 1
            )
            _fill_poly(img, pts, float(rng.integers(140, 255)))
            corners.extend(map(tuple, pts))
    elif kind == 1:  # star of line segments from a junction
        cx, cy = rng.uniform(30, W - 30), rng.uniform(25, H - 25)
        for _ in range(rng.integers(3, 6)):
            a = rng.uniform(0, 2 * np.pi)
            r = rng.uniform(15, 45)
            p1 = (cx + r * np.cos(a), cy + r * np.sin(a))
            _draw_line(img, (cx, cy), p1, float(rng.integers(150, 255)))
            corners.append(p1)
        corners.append((cx, cy))
    elif kind == 2:  # checkerboard patch
        c = int(rng.integers(8, 16))
        x0, y0 = rng.integers(5, 40), rng.integers(5, 30)
        nx, ny = rng.integers(3, 7), rng.integers(3, 6)
        for i in range(ny):
            for j in range(nx):
                if (i + j) % 2 == 0:
                    y, x = y0 + i * c, x0 + j * c
                    img[y : y + c, x : x + c] = float(rng.integers(160, 255))
        for i in range(ny + 1):
            for j in range(nx + 1):
                corners.append((x0 + j * c, y0 + i * c))
    else:  # axis-aligned rectangles
        for _ in range(rng.integers(1, 4)):
            x0 = rng.integers(5, W - 40)
            y0 = rng.integers(5, H - 35)
            w = rng.integers(12, 35)
            h = rng.integers(10, 28)
            img[y0 : y0 + h, x0 : x0 + w] = float(rng.integers(140, 255))
            corners.extend(
                [(x0, y0), (x0 + w - 1, y0), (x0, y0 + h - 1),
                 (x0 + w - 1, y0 + h - 1)]
            )
    img += rng.normal(0, 4.0, img.shape)
    k = rng.integers(0, 2)
    if k:  # cheap blur
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)
               + np.roll(img, -1, 0) + np.roll(img, -1, 1)) / 5.0
    cs = [
        (x, y) for x, y in corners
        if 2 <= x < W - 2 and 2 <= y < H - 2
    ]
    return np.clip(img, 0, 255), np.asarray(cs, np.float32).reshape(-1, 2)


def cells_target(corners: np.ndarray) -> np.ndarray:
    """(HC,WC) int32: 0..63 corner position in cell, 64 = dustbin."""
    tgt = np.full((HC, WC), 64, np.int32)
    for x, y in corners:
        cx, cy = int(x) // 8, int(y) // 8
        if 0 <= cx < WC and 0 <= cy < HC:
            tgt[cy, cx] = (int(y) % 8) * 8 + (int(x) % 8)
    return tgt


def random_homography(rng: np.random.Generator) -> np.ndarray:
    """Mild random homography (rotation + scale + perspective + shift)."""
    a = rng.uniform(-0.35, 0.35)
    s = rng.uniform(0.85, 1.2)
    tx, ty = rng.uniform(-12, 12, 2)
    px, py = rng.uniform(-4e-4, 4e-4, 2)
    c, sn = np.cos(a), np.sin(a)
    Hm = np.array(
        [[s * c, -s * sn, tx], [s * sn, s * c, ty], [px, py, 1.0]], np.float64
    )
    # keep the warp roughly centered
    cx, cy = W / 2, H / 2
    T = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1.0]])
    Ti = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]])
    return T @ Hm @ Ti


def warp_image(img: np.ndarray, Hm: np.ndarray) -> np.ndarray:
    """Inverse-warp with nearest sampling (enough for training data)."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    Hi = np.linalg.inv(Hm)
    d = Hi @ np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)])
    u = d[0] / d[2]
    v = d[1] / d[2]
    ok = (u >= 0) & (u < W - 1) & (v >= 0) & (v < H - 1)
    ui = np.clip(np.round(u).astype(int), 0, W - 1)
    vi = np.clip(np.round(v).astype(int), 0, H - 1)
    out = np.where(ok, img[vi, ui], 0.0)
    return out.reshape(H, W).astype(np.float32)


def warp_points(pts: np.ndarray, Hm: np.ndarray) -> np.ndarray:
    if len(pts) == 0:
        return pts
    d = Hm @ np.concatenate([pts.T, np.ones((1, len(pts)))])
    return (d[:2] / d[2]).T.astype(np.float32)


def make_batch(rng, batch: int):
    imgs, tgts, imgs2, tgts2, Hs = [], [], [], [], []
    for _ in range(batch):
        img, corners = render_shapes(rng)
        Hm = random_homography(rng)
        img2 = warp_image(img, Hm)
        c2 = warp_points(corners, Hm)
        c2 = c2[(c2[:, 0] >= 2) & (c2[:, 0] < W - 2)
                & (c2[:, 1] >= 2) & (c2[:, 1] < H - 2)] if len(c2) else c2
        imgs.append(img)
        tgts.append(cells_target(corners))
        imgs2.append(img2)
        tgts2.append(cells_target(c2))
        Hs.append(Hm)
    return (
        np.stack(imgs).astype(np.float32),
        np.stack(tgts),
        np.stack(imgs2).astype(np.float32),
        np.stack(tgts2),
        np.stack(Hs).astype(np.float32),
    )


# ----------------------------------------------------------------- training
def cell_centers() -> np.ndarray:
    """(HC*WC, 2) xy pixel centers of the 8x8 cells."""
    ys, xs = np.mgrid[0:HC, 0:WC]
    return np.stack([xs.ravel() * 8 + 4.0, ys.ravel() * 8 + 4.0], 1).astype(
        np.float32
    )


def _centers(device) -> torch.Tensor:
    """``cell_centers()`` built on ``device`` (the same values)."""
    ys, xs = torch.meshgrid(torch.arange(HC, device=device), torch.arange(WC, device=device),
                            indexing="ij")
    return torch.stack([xs.reshape(-1) * 8 + 4.0, ys.reshape(-1) * 8 + 4.0], 1).float()


def det_loss(det: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """det (B, 65, HC, WC) logits, tgt (B, HC, WC) -> (B,) cross-entropy,
    corner cells weighted 8 (they are rare)."""
    ll = torch.gather(F.log_softmax(det, dim=1), 1, tgt[:, None])[:, 0]
    w = torch.where(tgt < 64, 8.0, 1.0)
    return -(ll * w).sum((1, 2)) / w.sum((1, 2))


def desc_loss(desc1: torch.Tensor, desc2: torch.Tensor, hms: torch.Tensor,
              margin_pos: float = 1.0, margin_neg: float = 0.2) -> torch.Tensor:
    """Dense cell hinge loss of (B, 256, HC, WC) descriptor pairs related by
    the homographies hms (B, 3, 3) -> (B,)."""
    b = desc1.shape[0]
    centers = _centers(desc1.device)                                  # (C, 2)
    d1 = desc1.permute(0, 2, 3, 1).reshape(b, -1, desc1.shape[1])
    d2 = desc2.permute(0, 2, 3, 1).reshape(b, -1, desc2.shape[1])
    d1 = d1 / torch.clamp(torch.linalg.vector_norm(d1, dim=2, keepdim=True), min=1e-9)
    d2 = d2 / torch.clamp(torch.linalg.vector_norm(d2, dim=2, keepdim=True), min=1e-9)
    # correspondence: each cell centre of image 1 warped into image 2
    ones = torch.ones((centers.shape[0], 1), device=centers.device)
    w = hms @ torch.cat([centers, ones], 1).T                         # (B, 3, C)
    uv = (w[:, :2] / torch.clamp(torch.abs(w[:, 2:3]), min=1e-9)
          * torch.sign(w[:, 2:3])).transpose(1, 2)                    # (B, C, 2)
    sim = d1 @ d2.transpose(1, 2)                                     # (B, C, C)
    dist = torch.linalg.vector_norm(uv[:, :, None, :] - centers[None, None], dim=-1)
    pos = dist <= 8.0
    in_view = (uv[..., 0] >= 0) & (uv[..., 0] < W) & (uv[..., 1] >= 0) & (uv[..., 1] < H)
    lpos = torch.relu(margin_pos - sim) * pos * in_view[:, :, None]
    lneg = torch.relu(sim - margin_neg) * (~pos) * (dist > 16.0)
    return (lpos.sum((1, 2)) / torch.clamp(pos.sum((1, 2)), min=1.0)
            + lneg.sum((1, 2)) / torch.clamp((~pos).sum((1, 2)), min=1.0))


def batch_loss(net, imgs, tgts, imgs2, tgts2, hms, desc_weight: float = 1.0,
               margin_pos: float = 1.0, margin_neg: float = 0.2):
    """The reference step's loss of a batch: (B, H, W) images and their
    warps (grey levels), (B, HC, WC) int64 cell targets, (B, 3, 3)
    homographies -> (total, detector, descriptor).  Both images of every
    pair go through the net as one batch."""
    from pyslam_tpu_torch.models.superpoint import _INV_255

    b = imgs.shape[0]
    det, desc = net(torch.cat([imgs, imgs2])[:, None] * _INV_255)
    ld = det_loss(det[:b], tgts).mean() + det_loss(det[b:], tgts2).mean()
    lm = desc_loss(desc[:b], desc[b:], hms, margin_pos, margin_neg).mean()
    return ld + desc_weight * lm, ld, lm


def train(
    steps: int = 1500,
    batch: int = 8,
    lr: float = 1e-3,
    seed: int = 0,
    desc_weight: float = 1.0,
    margin_pos: float = 1.0,
    margin_neg: float = 0.2,
    log_every: int = 100,
    n_dataset: int = 1024,
    init_params: dict | None = None,
    *,
    device: torch.device | str = "cuda",
    indices=None,
    losses: list | None = None,
) -> dict:
    """Train a ``SuperPointNet`` and return its state dict (on the CPU).

    ``init_params``: a port state dict to start from (a fresh init draws
    ``interop.seeded_init_(net, seed)``).  ``indices``: one (batch,) array
    of dataset indices a step, instead of the generator's draws.
    ``losses``: a list that gets each step's (total, detector, descriptor)
    losses, as a (3,) device tensor (no synchronisation)."""
    from pyslam_tpu_torch import interop
    from pyslam_tpu_torch.models.superpoint import SuperPointNet
    from pyslam_tpu_torch.ops import adam
    from pyslam_tpu_torch.utils.device import deterministic_cudnn

    device = torch.device(device)
    net = SuperPointNet()
    if init_params is not None:
        net.load_state_dict(init_params)
    else:
        interop.seeded_init_(net, seed)
    net.to(device)
    params = dict(net.named_parameters())
    state = adam.init_state(params)
    rng = np.random.default_rng(seed)
    print(f"rendering {n_dataset} training pairs ...", flush=True)
    imgs_all, tgts_all, imgs2_all, tgts2_all, hs_all = (
        torch.from_numpy(a).to(device) for a in make_batch(rng, n_dataset))   # one upload
    tgts_all, tgts2_all = tgts_all.long(), tgts2_all.long()
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    with deterministic_cudnn():
        for i in range(steps):
            if indices is not None:
                idx = torch.as_tensor(np.array(indices[i], np.int64), device=device)
            else:
                idx = torch.randint(0, n_dataset, (batch,), generator=gen, device=device)
            loss, ld, lm = batch_loss(net, imgs_all[idx], tgts_all[idx], imgs2_all[idx],
                                      tgts2_all[idx], hs_all[idx], desc_weight, margin_pos,
                                      margin_neg)
            loss = adam.minimise_step_(params, loss, state, lr)
            ld, lm = ld.detach(), lm.detach()
            if losses is not None:
                losses.append(torch.stack([loss, ld, lm]))
            if i % log_every == 0 or i == steps - 1:
                print(f"step {i}: loss={float(loss):.4f} det={float(ld):.4f} "
                      f"desc={float(lm):.4f}", flush=True)
    return {k: v.detach().cpu() for k, v in net.state_dict().items()}


DEFAULT_CHECKPOINT = os.path.join(os.path.dirname(__file__), "checkpoints",
                                  "superpoint_tiny.npz")


def save_checkpoint(path: str, state: dict):
    """The JAX package's ``save_variables_npz`` layout (``params/Conv_i``)."""
    from pyslam_tpu_torch import interop

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **interop.superpoint_flat(state))


def main(steps: int | None = None, out: str | None = None,
         device: torch.device | str = "cuda"):
    steps = steps or int(os.environ.get("SP_TRAIN_STEPS", 1500))
    out = out or DEFAULT_CHECKPOINT
    init = None
    if os.environ.get("SP_TRAIN_RESUME") == "1" and os.path.exists(out):
        from pyslam_tpu_torch.models.superpoint import SuperPointExtractor

        init = SuperPointExtractor(num_features=64, checkpoint=out, device="cpu").net.state_dict()
        print(f"resuming from {out}")
    state = train(
        steps=steps, init_params=init,
        seed=int(os.environ.get("SP_TRAIN_SEED", 0)),
        lr=float(os.environ.get("SP_TRAIN_LR", 1e-3)),
        desc_weight=float(os.environ.get("SP_TRAIN_DESC_WEIGHT", 1.0)),
        device=device,
    )
    save_checkpoint(out, state)
    print(f"saved {out}")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    main(out=args.out, device=args.device)
