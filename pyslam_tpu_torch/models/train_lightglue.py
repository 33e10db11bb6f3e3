"""In-framework LightGlue training (port of
``pyslam_tpu/models/train_lightglue.py``).

The reference runs official LightGlue checkpoints downloaded at install
time; with no network, the framework trains its own small LightGlue-class
matcher on synthetic correspondences, as ``train_superpoint.py`` does for
the extractor.

The task makes plain nearest-neighbour matching fail: each pair shares a
small pool of repeated descriptors (repeated texture), so only the
rotary-encoded keypoint geometry (a shared homography) and cross attention
disambiguate.  The loss is the LightGlue paper's (eq. 10): the negative
log-likelihood of the ground-truth assignment under the dual-softmax
scores plus the matchability BCE.  Training clips the gradient's global
norm at 1 and steps Adam on a cosine schedule (``optax.chain(
clip_by_global_norm(1.0), adam(cosine_decay_schedule(lr, steps)))``, as
``ops/adam.py`` reproduces it), under an ambiguity curriculum: the pools
shrink from 64 to ``N_POOL`` over the first 60 % of the steps.

The pair generator is the JAX package's numpy code, copied; the 16 pairs of
a batch go through the net as one ``torch.func.vmap`` (the reference
``vmap``s its loss), with autograd through it.

    python -m pyslam_tpu_torch.models.train_lightglue [--device cpu]

writes ``pyslam_tpu_torch/models/checkpoints/lightglue_tiny.npz`` (the JAX
package's flat names and ``__dim__`` / ``__layers__`` / ``__heads__`` /
``__input_dim__``).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

W, H = 640.0, 480.0
N_KPS = 64          # keypoints per image
N_TRUE = 40         # ground-truth correspondences per pair
N_POOL = 8          # descriptor pool size (repeated-texture ambiguity)
AMBIG_FRAC = 0.5    # fraction of keypoints drawing from the shared pool
DESC_DIM = 256
DIM = 96            # matcher width (tiny)
LAYERS = 4
HEADS = 4


def random_homography(rng: np.random.Generator) -> np.ndarray:
    """Similarity + mild perspective, mapping image coords to image coords."""
    ang = rng.uniform(-0.15, 0.15)
    s = rng.uniform(0.9, 1.15)
    tx, ty = rng.uniform(-60, 60, 2)
    c, si = np.cos(ang), np.sin(ang)
    Hm = np.array(
        [[s * c, -s * si, tx], [s * si, s * c, ty], [0.0, 0.0, 1.0]]
    )
    Hm[2, :2] = rng.uniform(-1e-4, 1e-4, 2)
    return Hm


def warp_points(Hm: np.ndarray, xy: np.ndarray) -> np.ndarray:
    p = np.concatenate([xy, np.ones((len(xy), 1))], 1) @ Hm.T
    return p[:, :2] / np.maximum(np.abs(p[:, 2:3]), 1e-9) * np.sign(p[:, 2:3])


def make_pair(rng: np.random.Generator, n_pool: int = N_POOL):
    """One training pair.

    Returns (desc0, xy0, desc1, xy1, gt) with gt[i] = matching index in
    image 1 for keypoint i of image 0, or -1.  ``n_pool`` controls the
    descriptor ambiguity (smaller = more keypoints share a descriptor =
    harder): the trainer anneals it as a curriculum — the net first learns
    descriptor matching on nearly-unique descriptors, then geometric
    disambiguation as the pools shrink."""
    pool = rng.normal(size=(n_pool, DESC_DIM)).astype(np.float32)
    pool /= np.linalg.norm(pool, axis=1, keepdims=True)

    xy0 = rng.uniform([40, 40], [W - 40, H - 40], (N_KPS, 2)).astype(
        np.float32
    )
    Hm = random_homography(rng)
    xy1 = np.empty_like(xy0)
    gt = np.full(N_KPS, -1, np.int64)

    # a fraction of keypoints draws from the small shared pool (repeated
    # texture: NN matching ambiguous by construction); the rest get unique
    # descriptors.  The matcher must keep the easy half AND use geometry
    # for the ambiguous half — mutual-NN can only do the former.
    ambig = rng.random(N_KPS) < AMBIG_FRAC
    pick = rng.integers(0, n_pool, N_KPS)
    uniq = rng.normal(size=(N_KPS, DESC_DIM)).astype(np.float32)
    uniq /= np.linalg.norm(uniq, axis=1, keepdims=True)
    base0 = np.where(ambig[:, None], pool[pick], uniq)
    d0 = base0 + 0.15 * rng.normal(size=(N_KPS, DESC_DIM))
    d1 = np.empty_like(d0)

    # first N_TRUE keypoints correspond through the homography
    w = warp_points(Hm, xy0[:N_TRUE])
    inb = (
        (w[:, 0] > 8) & (w[:, 0] < W - 8) & (w[:, 1] > 8) & (w[:, 1] < H - 8)
    )
    perm = rng.permutation(N_KPS)
    for i in range(N_TRUE):
        j = perm[i]
        if inb[i]:
            xy1[j] = w[i] + rng.normal(scale=0.5, size=2)
            gt[i] = j
        else:
            xy1[j] = rng.uniform([40, 40], [W - 40, H - 40])
        d1[j] = base0[i] + 0.15 * rng.normal(size=DESC_DIM)
    # unmatched keypoints of image 1: fresh positions, pool descriptors
    for i in range(N_TRUE, N_KPS):
        j = perm[i]
        xy1[j] = rng.uniform([40, 40], [W - 40, H - 40])
        if rng.random() < AMBIG_FRAC:
            d1[j] = pool[rng.integers(0, n_pool)] + 0.15 * rng.normal(
                size=DESC_DIM
            )
        else:
            u = rng.normal(size=DESC_DIM)
            d1[j] = u / np.linalg.norm(u) + 0.15 * rng.normal(size=DESC_DIM)

    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    return (
        d0.astype(np.float32), xy0,
        d1.astype(np.float32), xy1.astype(np.float32), gt,
    )


def make_batch(rng: np.random.Generator, b: int, n_pool: int = N_POOL):
    cols = [make_pair(rng, n_pool) for _ in range(b)]
    return tuple(np.stack([c[k] for c in cols]) for k in range(5))


# --------------------------------------------------------------- training
def build_net():
    from pyslam_tpu_torch.models.lightglue import LightGlueNet

    return LightGlueNet(dim=DIM, layers=LAYERS, heads=HEADS, input_dim=DESC_DIM)


def _normalise(xy: torch.Tensor) -> torch.Tensor:
    c = torch.tensor([W / 2, H / 2], dtype=torch.float32, device=xy.device)
    return (xy - c) / torch.max(c)


def loss_fn(net, params: dict, d0, xy0, d1, xy1, gt):
    """LightGlue loss (paper eq. 10) of one pair: (N_KPS, DESC_DIM)
    descriptors, (N_KPS, 2) pixel coordinates, gt (N_KPS,) int64.
    ``params`` (name -> tensor) replaces the net's own
    (``torch.func.functional_call``)."""
    m = torch.ones((N_KPS,), dtype=torch.bool, device=d0.device)
    scores, _, sig0, sig1 = torch.func.functional_call(
        net, params, (d0, _normalise(xy0), m, d1, _normalise(xy1), m), {"return_aux": True})
    matched = gt >= 0
    gtc = torch.clamp(gt, min=0)
    # NLL of the ground-truth assignment
    picked = torch.gather(scores, 1, gtc[:, None])[:, 0]
    nll = -torch.sum(torch.where(matched, picked, torch.zeros_like(picked))) / torch.clamp(
        matched.sum(), min=1)
    # matchability BCE: matched keypoints (both sides) -> 1, the rest -> 0
    tgt0 = matched.to(torch.float32)
    tgt1 = torch.zeros((N_KPS,), device=d0.device).scatter_reduce(0, gtc, tgt0, "amax")

    def bce(s, t):
        return -torch.mean(t * F.logsigmoid(s) + (1 - t) * F.logsigmoid(-s))

    return nll + 0.5 * (bce(sig0, tgt0) + bce(sig1, tgt1))


def batch_loss(net, params: dict, d0, xy0, d1, xy1, gt):
    """The mean ``loss_fn`` of a (B, ...) batch of pairs, in one vmap."""
    per_pair = torch.func.vmap(lambda *a: loss_fn(net, params, *a))
    return per_pair(d0, xy0, d1, xy1, gt).mean()


def train(steps: int = 6000, batch: int = 16, lr: float = 1e-3, seed: int = 0,
          log_every: int = 100, *, init_params: dict | None = None,
          device: torch.device | str = "cuda", losses: list | None = None):
    """Train the matcher; returns (net on ``device``, its state dict on the
    CPU).  ``init_params``: a port state dict to start from (a fresh init
    draws ``interop.seeded_init_(net, seed)``); ``losses`` gets each step's
    loss as a 0-d device tensor (no synchronisation)."""
    from pyslam_tpu_torch import interop
    from pyslam_tpu_torch.ops import adam

    device = torch.device(device)
    net = build_net()
    if init_params is not None:
        net.load_state_dict(init_params)
    else:
        interop.seeded_init_(net, seed)
    net.to(device)
    rng = np.random.default_rng(seed)
    params = dict(net.named_parameters())
    state = adam.init_state(params)
    for i in range(steps):
        # ambiguity curriculum: nearly-unique descriptors first, then pools
        # shrink to the target N_POOL over the first 60% of training
        frac = min(1.0, i / max(1, int(0.6 * steps)))
        n_pool = int(round(64 + (N_POOL - 64) * frac))
        batch_t = [torch.from_numpy(a).to(device) for a in make_batch(rng, batch, n_pool)]
        loss = adam.minimise_step_(params, batch_loss(net, params, *batch_t), state,
                                   adam.cosine_decay(lr, steps, state.count), max_norm=1.0)
        if losses is not None:
            losses.append(loss)
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i}: loss {float(loss):.4f}", flush=True)
    return net, {k: v.detach().cpu() for k, v in net.state_dict().items()}


def evaluate(net, n_pairs: int = 30, seed: int = 999, threshold: float = 0.1):
    """Held-out precision/recall of mutual-best matches above threshold
    (the pairs through the net in one vmap, on the net's device)."""
    rng = np.random.default_rng(seed)
    pairs = [make_pair(rng) for _ in range(n_pairs)]
    dev = next(net.parameters()).device
    d0, xy0, d1, xy1 = (torch.from_numpy(np.stack([p[k] for p in pairs])).to(dev)
                        for k in range(4))
    m = torch.ones((N_KPS,), dtype=torch.bool, device=dev)
    with torch.no_grad():
        scores = torch.func.vmap(
            lambda a, b, c, d: net(a, _normalise(b), m, c, _normalise(d), m)[0])(d0, xy0, d1, xy1)
    probs = torch.exp(scores).cpu().numpy()
    tp = fp = fn = 0
    for (_, _, _, _, gt), p in zip(pairs, probs):
        best1 = p.argmax(1)
        best0 = p.argmax(0)
        mutual = best0[best1] == np.arange(N_KPS)
        conf = p.max(1)
        pred = np.where(mutual & (conf > threshold), best1, -1)
        for i in range(N_KPS):
            if gt[i] >= 0:
                if pred[i] == gt[i]:
                    tp += 1
                elif pred[i] >= 0:
                    fp += 1
                    fn += 1
                else:
                    fn += 1
            elif pred[i] >= 0:
                fp += 1
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    return precision, recall


def nn_baseline(n_pairs: int = 30, seed: int = 999):
    """Mutual-NN descriptor matching on the same pairs (the ambiguity
    control: pool descriptors make this fail)."""
    rng = np.random.default_rng(seed)
    tp = n_gt = n_pred = 0
    for _ in range(n_pairs):
        d0, xy0, d1, xy1, gt = make_pair(rng)
        sim = d0 @ d1.T
        best1 = sim.argmax(1)
        best0 = sim.argmax(0)
        mutual = best0[best1] == np.arange(N_KPS)
        pred = np.where(mutual, best1, -1)
        n_gt += int((gt >= 0).sum())
        n_pred += int((pred >= 0).sum())
        tp += int(((gt >= 0) & (pred == gt)).sum())
    return tp / max(n_pred, 1), tp / max(n_gt, 1)


DEFAULT_CHECKPOINT = os.path.join(os.path.dirname(__file__), "checkpoints",
                                  "lightglue_tiny.npz")


def save_checkpoint(path: str, state: dict):
    """The JAX package's layout: flat ``params/...`` names and the
    architecture's ``__dim__``, ``__layers__``, ``__heads__`` and
    ``__input_dim__``."""
    from pyslam_tpu_torch import interop

    flat = interop.lightglue_flat(state)
    flat["__dim__"] = np.asarray(DIM)
    flat["__layers__"] = np.asarray(LAYERS)
    flat["__heads__"] = np.asarray(HEADS)
    flat["__input_dim__"] = np.asarray(DESC_DIM)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)


def main(out: str | None = None, device: torch.device | str = "cuda"):
    net, state = train(device=device)
    p, r = evaluate(net)
    bp, br = nn_baseline()
    print(f"trained:     precision {p:.3f} recall {r:.3f}")
    print(f"NN baseline: precision {bp:.3f} recall {br:.3f}")
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
