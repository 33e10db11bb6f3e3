"""In-framework CosPlace-class VPR training (port of
``pyslam_tpu/models/train_cosplace.py``).

The reference's score-based loop detectors download gmberton/CosPlace hub
checkpoints; with no network, the framework trains its own tiny
``GeoLocalizationNet`` (resnet9 trunk, width 16, GeM + linear head) on
procedural places, as ``train_superpoint.py`` and ``train_lightglue.py``
do for their models.

Each place is a procedural texture (Gaussian blobs on a global gradient,
from a place seed); views are rotated, scaled crops with photometric
jitter (the JAX package's numpy code, copied; a step's 32 views are
sampled on the device by ``normalized_views``, identical to
``render_view`` one by one on the host, whose rendering bounded the step).  Training is CosFace
classification over the places (logits ``16 * (cos - 0.2 * onehot)``,
softmax cross-entropy), with Adam as ``optax.adam`` steps it
(``ops/adam.py``) over the net and the place centres.  The JAX package's
batch norm holds its running statistics as params, which its Adam steps
with the weights, so the port's trainer makes them parameters too
(``resnet.trainable_statistics_``): all four tensors of every batch norm
train, still in the inference form.  The centres are drawn N(0, 0.05^2)
from a ``torch.Generator`` seeded ``seed + 1`` (the reference draws
``jax.random.normal(PRNGKey(seed + 1))``), or injected.  Recall@1 is
evaluated on held-out places.

    python -m pyslam_tpu_torch.models.train_cosplace [--device cpu]

writes ``pyslam_tpu_torch/models/checkpoints/cosplace_tiny.npz`` (the JAX
package's flat names and ``__arch__`` / ``__width__`` / ``__out_dim__``).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

VIEW_H, VIEW_W = 96, 128    # network input (divisible by 32)
TEX_H, TEX_W = 192, 256     # place texture
ARCH = "resnet9"
WIDTH = 16
OUT_DIM = 128
N_PLACES = 64


def place_texture(seed: int) -> np.ndarray:
    """Procedural (TEX_H, TEX_W, 3) texture for one place."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:TEX_H, 0:TEX_W].astype(np.float32)
    img = np.zeros((TEX_H, TEX_W, 3), np.float32)
    # global gradient (orientation cue)
    g = rng.normal(size=(2, 3)).astype(np.float32)
    img += (ys[..., None] / TEX_H) * g[0] + (xs[..., None] / TEX_W) * g[1]
    for _ in range(40):
        cy, cx = rng.uniform(0, TEX_H), rng.uniform(0, TEX_W)
        s = rng.uniform(6, 30)
        col = rng.normal(size=3)
        img += col * np.exp(
            -((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * s * s)
        )[..., None]
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return (img * 255.0).astype(np.float32)


def render_view(tex: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Random rotated/scaled crop + photometric jitter -> (VIEW_H, VIEW_W, 3)."""
    ang = rng.uniform(-0.3, 0.3)
    scale = rng.uniform(0.55, 0.85)
    cy = rng.uniform(0.35, 0.65) * TEX_H
    cx = rng.uniform(0.35, 0.65) * TEX_W
    c, s = np.cos(ang), np.sin(ang)
    ys, xs = np.mgrid[0:VIEW_H, 0:VIEW_W].astype(np.float32)
    ys = (ys - VIEW_H / 2) * scale * (TEX_H / VIEW_H)
    xs = (xs - VIEW_W / 2) * scale * (TEX_W / VIEW_W)
    sy = cy + c * ys - s * xs
    sx = cx + s * ys + c * xs
    y0 = np.clip(sy.astype(np.int64), 0, TEX_H - 2)
    x0 = np.clip(sx.astype(np.int64), 0, TEX_W - 2)
    fy = np.clip(sy - y0, 0, 1)[..., None]
    fx = np.clip(sx - x0, 0, 1)[..., None]
    v = (
        tex[y0, x0] * (1 - fy) * (1 - fx)
        + tex[y0 + 1, x0] * fy * (1 - fx)
        + tex[y0, x0 + 1] * (1 - fy) * fx
        + tex[y0 + 1, x0 + 1] * fy * fx
    )
    v = v * rng.uniform(0.7, 1.3) + rng.uniform(-20, 20)
    v += rng.normal(scale=4.0, size=v.shape)
    return np.clip(v, 0, 255).astype(np.float32)


def _normalize(v: np.ndarray) -> np.ndarray:
    mean = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
    std = np.array([0.229, 0.224, 0.225], np.float32) * 255.0
    return (v - mean) / std


def normalized_views(textures: torch.Tensor, which, rng: np.random.Generator) -> torch.Tensor:
    """``np.stack([_normalize(render_view(tex[i], rng)) for i in which])``
    with the sampling on ``textures``' device: the draws are made on the
    host in ``render_view``'s order, then the same operations run batched
    (each one rounded alone, float64 where numpy promotes to it), so the
    views are identical.  textures: (P, TEX_H, TEX_W, 3) float32."""
    dev = textures.device
    n = len(which)
    ang, scale, cy, cx, gain, offset = (np.empty(n) for _ in range(6))
    noise = np.empty((n, VIEW_H, VIEW_W, 3))
    for i in range(n):
        ang[i] = rng.uniform(-0.3, 0.3)
        scale[i] = rng.uniform(0.55, 0.85)
        cy[i] = rng.uniform(0.35, 0.65) * TEX_H
        cx[i] = rng.uniform(0.35, 0.65) * TEX_W
        gain[i] = rng.uniform(0.7, 1.3)
        offset[i] = rng.uniform(-20, 20)
        noise[i] = rng.normal(scale=4.0, size=(VIEW_H, VIEW_W, 3))

    def col(a, dtype=torch.float64):   # (n,) -> (n, 1, 1) on the device
        return torch.as_tensor(a, dtype=dtype, device=dev)[:, None, None]

    c, s = col(np.cos(ang)), col(np.sin(ang))
    sc = col(scale.astype(np.float32), torch.float32)   # a float meeting float32
    ys, xs = torch.meshgrid(torch.arange(VIEW_H, dtype=torch.float32, device=dev),
                            torch.arange(VIEW_W, dtype=torch.float32, device=dev),
                            indexing="ij")
    ys = (ys - VIEW_H / 2) * sc * (TEX_H / VIEW_H)
    xs = (xs - VIEW_W / 2) * sc * (TEX_W / VIEW_W)
    sy = col(cy) + c * ys - s * xs
    sx = col(cx) + s * ys + c * xs
    y0 = torch.clamp(sy.to(torch.int64), 0, TEX_H - 2)
    x0 = torch.clamp(sx.to(torch.int64), 0, TEX_W - 2)
    fy = torch.clamp(sy - y0, 0, 1)[..., None]
    fx = torch.clamp(sx - x0, 0, 1)[..., None]
    t = torch.as_tensor(np.asarray(which, np.int64), device=dev)[:, None, None]
    v = (
        textures[t, y0, x0] * (1 - fy) * (1 - fx)
        + textures[t, y0 + 1, x0] * fy * (1 - fx)
        + textures[t, y0, x0 + 1] * (1 - fy) * fx
        + textures[t, y0 + 1, x0 + 1] * fy * fx
    )
    v = v * col(gain)[..., None] + col(offset)[..., None]
    v = v + torch.from_numpy(noise).to(dev)
    v = torch.clamp(v, 0, 255).to(torch.float32)
    mean = torch.from_numpy(np.array([0.485, 0.456, 0.406], np.float32) * 255.0).to(dev)
    std = torch.from_numpy(np.array([0.229, 0.224, 0.225], np.float32) * 255.0).to(dev)
    return (v - mean) / std


def build_net():
    from pyslam_tpu_torch.models.cosplace import GeoLocalizationNet

    return GeoLocalizationNet(arch=ARCH, out_dim=OUT_DIM, width=WIDTH)


def batch_loss(net, centers: torch.Tensor, x: torch.Tensor, labels: torch.Tensor):
    """CosFace loss of a batch: (B, 3, VIEW_H, VIEW_W) normalised views,
    the (N_PLACES, OUT_DIM) place centres and the (B,) place labels: cosine
    logits with an additive margin of 0.2 on the target class, scale 16,
    softmax cross-entropy."""
    d = net(x)                                                       # (B, D) unit
    cn = centers / torch.clamp(torch.linalg.vector_norm(centers, dim=1, keepdim=True),
                               min=1e-9)
    cos = d @ cn.T                                                   # (B, P)
    onehot = F.one_hot(labels, N_PLACES).to(cos.dtype)
    return F.cross_entropy(16.0 * (cos - 0.2 * onehot), labels)


def train(steps: int = 300, batch: int = 32, lr: float = 1e-3, seed: int = 0,
          log_every: int = 50, *, init_params: dict | None = None, centers=None,
          device: torch.device | str = "cuda", losses: list | None = None):
    """Train the place network; returns (net on ``device``, its state dict
    on the CPU).  ``init_params``: a port state dict to start from (a
    fresh init draws ``interop.seeded_init_(net, seed)``); ``centers``:
    the (N_PLACES, OUT_DIM) initial place centres; ``losses`` gets each
    step's loss as a 0-d device tensor (no synchronisation)."""
    from pyslam_tpu_torch import interop
    from pyslam_tpu_torch.models.resnet import trainable_statistics_
    from pyslam_tpu_torch.ops import adam
    from pyslam_tpu_torch.utils.device import deterministic_cudnn

    device = torch.device(device)
    net = build_net()
    if init_params is not None:
        net.load_state_dict(init_params)
    else:
        interop.seeded_init_(net, seed)
    trainable_statistics_(net).to(device)
    rng = np.random.default_rng(seed)
    textures = torch.from_numpy(np.stack([place_texture(1000 + p)
                                          for p in range(N_PLACES)])).to(device)
    if centers is None:
        gen = torch.Generator().manual_seed(seed + 1)
        centers = torch.randn((N_PLACES, OUT_DIM), generator=gen) * 0.05
    centers = torch.from_numpy(np.array(centers, np.float32)).to(device).requires_grad_(True)
    params = {f"net.{n}": p for n, p in net.named_parameters()}
    params["centers"] = centers
    state = adam.init_state(params)
    with deterministic_cudnn():
        for i in range(steps):
            labels = rng.integers(0, N_PLACES, batch)
            x = normalized_views(textures, labels, rng).permute(0, 3, 1, 2)
            y = torch.from_numpy(labels).to(device)
            loss = adam.minimise_step_(params, batch_loss(net, centers, x, y), state, lr)
            if losses is not None:
                losses.append(loss)
            if i % log_every == 0 or i == steps - 1:
                print(f"step {i}: loss {float(loss):.4f}", flush=True)
    return net, {k: v.detach().cpu() for k, v in net.state_dict().items()}


def evaluate(net, n_places: int = 24, seed: int = 7777):
    """Recall@1 on held-out places (disjoint from the training set): one
    gallery view a place, then one query view a place, rendered in the
    reference's order and described in one batch each."""
    rng = np.random.default_rng(seed)
    texs = [place_texture(900000 + p) for p in range(n_places)]
    gallery = np.stack([_normalize(render_view(t, rng)) for t in texs])
    queries = np.stack([_normalize(render_view(t, rng)) for t in texs])
    dev = next(net.parameters()).device
    with torch.no_grad():
        g, q = (net(torch.from_numpy(v).to(dev).permute(0, 3, 1, 2)).cpu().numpy()
                for v in (gallery, queries))
    hits = sum(int(np.argmax(g @ q[i]) == i) for i in range(n_places))
    return hits / n_places


DEFAULT_CHECKPOINT = os.path.join(os.path.dirname(__file__), "checkpoints",
                                  "cosplace_tiny.npz")


def save_checkpoint(path: str, state: dict):
    """The JAX package's layout: flat ``params/...`` names and the
    architecture's ``__arch__``, ``__width__`` and ``__out_dim__``."""
    from pyslam_tpu_torch import interop

    flat = interop.cosplace_flat(state)
    flat["__arch__"] = np.asarray(ARCH)
    flat["__width__"] = np.asarray(WIDTH)
    flat["__out_dim__"] = np.asarray(OUT_DIM)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)


def main(out: str | None = None, device: torch.device | str = "cuda"):
    from pyslam_tpu_torch import interop

    net, state = train(device=device)
    r1 = evaluate(net)
    rand_net = interop.seeded_init_(build_net(), 123).to(device)
    r1_rand = evaluate(rand_net)
    print(f"recall@1 trained {r1:.3f} vs random-init {r1_rand:.3f}")
    out = out or DEFAULT_CHECKPOINT
    save_checkpoint(out, state)
    print(f"saved {out}")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    main(out=args.out, device=args.device)
