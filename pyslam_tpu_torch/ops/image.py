"""Image ops: separable Gaussian blur, the image pyramid, Sobel gradients
and bilinear sampling (port of ``pyslam_tpu/ops/image.py:18-92``).

Images are float32 (..., H, W) tensors in [0, 255].

The pyramid reproduces ``jax.image.resize(..., "bilinear")``, which
antialiases when it downsamples: the per-axis weight matrices of
``jax/_src/image/scale.py`` (``compute_weight_mat``: a triangle kernel
widened by 1/scale, columns normalised to sum 1, zero outside the input) are
built once per shape in numpy and applied one axis at a time.  Plain
``F.interpolate`` differs from that resize by up to 138 grey levels at level 7 of a 376x1241 image (0.0084 with
``antialias=True``), enough to move FAST corners.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    """Normalised 1-D Gaussian taps (float32, computed as the reference
    does: float32 offsets, exp rounded correctly to float32, divide by the
    float32 sum; numpy's float32 exp is an ulp off at some taps)."""
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    arg = np.float32(-0.5) * (x / np.float32(sigma)) ** 2
    k = np.exp(arg.astype(np.float64)).astype(np.float32)
    return (k / np.sum(k, dtype=np.float32)).astype(np.float32)


def _blur_axis(img: torch.Tensor, k: list[float], dim: int) -> torch.Tensor:
    """One pass of the separable blur along ``dim`` with edge replication.

    The sum is rounded as the reference's compiled shift-and-add rounds it
    on the CPU: acc = k[1] * x[1] rounded to float32, then acc = fma(k[i],
    x[i], acc) for i = 0, 2, 3, ...  A fused multiply-add is emulated in
    float64: the product of two float32 values is exact there, and the
    float64 add and the cast back to float32 are correctly rounded on both
    devices, so the CPU and the card give the same bits."""
    radius = (len(k) - 1) // 2
    n = img.shape[dim]
    x = torch.cat([img.narrow(dim, 0, 1).expand_as(img.narrow(dim, 0, radius)), img,
                   img.narrow(dim, n - 1, 1).expand_as(img.narrow(dim, 0, radius))],
                  dim).to(torch.float64)
    acc = (x.narrow(dim, 1, n) * k[1]).to(torch.float32)
    for i in [0, *range(2, len(k))]:
        acc = torch.add(acc, x.narrow(dim, i, n), alpha=k[i]).to(torch.float32)
    return acc


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0, radius: int = 3) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W) with edge replication, rows
    then columns, with the reference's taps and rounding (``_blur_axis``)."""
    k = [float(v) for v in gaussian_kernel1d(sigma, radius)]
    return _blur_axis(_blur_axis(img, k, img.dim() - 2), k, img.dim() - 1)


# Output sizes from which XLA's CPU backend keeps a loop over the output
# axis (8-wide vectors; 32 a step in the column-sum fusion) instead of
# unrolling it fully; see ``resize_weights``.
_NORMALISE_LOOP_MIN = 88
_SUM_LOOP_MIN = 352


def _triangle_f32(input_size: int, output_size: int, loop_cols: int):
    """Sample positions (output,) and unnormalised triangle weights
    (input, output) in float32, rounded as XLA's CPU code rounds them.

    Columns ``< loop_cols`` are computed in the vector loop: the sample
    position is one fused multiply-add, and ``1 - |x| * c`` two roundings.
    The other columns are unrolled with constant sample positions (multiply
    and add rounded apart) and ``1 - |x| * c`` is one fused multiply-add.
    A fused multiply-add of float32 values is exact in float64 before its
    one rounding at these magnitudes."""
    f32, f64 = np.float32, np.float64
    inv_scale = 1.0 / (output_size / input_size)     # in Python, as the reference
    inv = f32(inv_scale)
    c = f32(1.0) / f32(max(inv_scale, 1.0))
    o = np.arange(output_size, dtype=f32) + f32(0.5)
    in_loop = np.arange(output_size) < loop_cols
    sample = np.where(in_loop, (o.astype(f64) * f64(inv) - 0.5).astype(f32),
                      o * inv - f32(0.5))
    d = np.abs(sample[None, :] - np.arange(input_size, dtype=f32)[:, None])
    w = np.where(in_loop[None, :], f32(1.0) - d * c,
                 (1.0 - d.astype(f64) * f64(c)).astype(f32))
    return sample, np.maximum(w, f32(0.0))


def _xla_column_sum(w: np.ndarray, window: int = 32) -> np.ndarray:
    """Sum over axis 0 as XLA's CPU backend reduces it: zero-padded evenly
    to whole windows of 32, each window summed in order, repeated until 32
    or fewer partial sums are left, which are summed in order."""
    x = w
    while x.shape[0] > window:
        n = x.shape[0]
        padded = -(-n // window) * window
        lo = (padded - n) // 2
        x = np.pad(x, ((lo, padded - n - lo), (0, 0)))
        x = x.reshape(padded // window, window, x.shape[1])
        acc = np.zeros((x.shape[0], x.shape[2]), np.float32)
        for k in range(window):
            acc = acc + x[:, k]
        x = acc
    acc = np.zeros(x.shape[1], np.float32)
    for k in range(x.shape[0]):
        acc = acc + x[k]
    return acc


@functools.lru_cache(maxsize=64)
def resize_weights(input_size: int, output_size: int) -> np.ndarray:
    """(output_size, input_size) float32 bilinear weights with antialiasing,
    bit for bit as ``jax.image.resize`` builds them in the JAX package's own
    runs (float32, jitted on the CPU).

    ``compute_weight_mat`` takes its type from the Python scalars ``scale``
    and ``translation``: float32 unless x64 is on.  Under ``jit`` XLA turns
    the division by the kernel scale into a multiply by its float32
    reciprocal, and builds the weights twice, once for the column sums and
    once for the normalised result, each fusion with its own rounding
    (``_triangle_f32``): the sum fusion keeps a loop from output size 352
    up, the normalising one from 88 up, and below that each is unrolled.
    Read off XLA's CPU code for x86-64 with fused multiply-add."""
    f32 = np.float32
    n, m = input_size, output_size
    _, w_sum = _triangle_f32(n, m, (m // 32) * 32 if m >= _SUM_LOOP_MIN else 0)
    sample, w = _triangle_f32(n, m, (m // 8) * 8 if m >= _NORMALISE_LOOP_MIN else 0)
    total = _xla_column_sum(w_sum)[None, :]
    weights = np.where(np.abs(total) > f32(1000.0 * float(np.finfo(np.float32).eps)),
                       w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= f32(-0.5)) & (sample <= f32(n - 0.5))
    weights = np.where(inside[None, :], weights, f32(0.0))
    return np.ascontiguousarray(weights.T.astype(f32))


@functools.lru_cache(maxsize=64)
def _resize_taps(input_size: int, output_size: int):
    """The nonzero weights of ``resize_weights`` as (output_size, T) input
    indices and weights, in increasing input index (pad: weight 0)."""
    wm = resize_weights(input_size, output_size)
    nz = [np.nonzero(row)[0] for row in wm]
    t = max(1, max(len(z) for z in nz))
    idx = np.zeros((output_size, t), np.int64)
    wts = np.zeros((output_size, t), np.float32)
    for i, z in enumerate(nz):
        idx[i, :len(z)] = z
        wts[i, :len(z)] = wm[i, z]
    return idx, wts


def depth_panel(depth: int, max_panel: int = 328) -> int:
    """Panel width into which XLA's CPU matrix product (Eigen) cuts a
    contraction of ``depth`` terms: equal panels, rounded up to 8, of at most
    ``max_panel`` terms (``depth`` itself when it fits in one)."""
    n = -(-depth // max_panel)
    return depth if n == 1 else -(-(-(-depth // n)) // 8) * 8


def _resize_axis(img: torch.Tensor, out_size: int, dim: int,
                 panel: int | None = None) -> torch.Tensor:
    """Contract ``dim`` with the resize weights.  Each output is a chain of
    its taps in increasing input order; with ``panel``, a chain per panel of
    the input axis, the panels' sums added in order."""
    idx_np, w_np = _resize_taps(img.shape[dim], out_size)
    idx = torch.from_numpy(idx_np).to(img.device)
    wts = torch.from_numpy(w_np).to(img.device)
    shape = [1] * img.dim()
    shape[dim] = out_size
    # taps past the panel of an output's first tap go to a second chain (the
    # taps of one output span far less than a panel; padded taps weigh 0)
    split = None
    if panel is not None and panel < img.shape[dim]:
        split = (idx // panel) > (idx[:, :1] // panel)
    acc = torch.zeros((), dtype=torch.float32, device=img.device)
    acc_hi = acc
    for t in range(idx.shape[1]):
        # the product of two float32 values is exact in float64; the float64
        # add and the cast back to float32 are each correctly rounded on
        # both devices, so the CPU and the card give the same bits (one
        # rounding at these magnitudes, as a fused multiply-add)
        term = (torch.index_select(img, dim, idx[:, t]).to(torch.float64)
                * wts[:, t].reshape(shape).to(torch.float64))
        if split is None:
            acc = (term + acc).to(torch.float32)
            continue
        hi = split[:, t].reshape(shape)
        new = (term + torch.where(hi, acc_hi, acc)).to(torch.float32)
        acc, acc_hi = torch.where(hi, acc, new), torch.where(hi, new, acc_hi)
    return acc if split is None else acc + acc_hi


def resize_bilinear(img: torch.Tensor, new_hw: tuple[int, int]) -> torch.Tensor:
    """Antialiased bilinear resize of (..., H, W), rows then columns, as
    fused multiply-add chains in a fixed order, so the CPU and the GPU give
    the same pyramid bit for bit.

    The row pass sums as XLA's CPU matrix product does (one chain per depth
    panel, ``depth_panel``), bit for bit.  The column pass is one chain in
    increasing input order: XLA's product there interleaves 2 or 4
    accumulators by a rule that depends on the shape, which the port does
    not follow (within 3.05e-5 grey levels of the reference at every level
    of a 376x1241 frame)."""
    rows = _resize_axis(img, new_hw[0], img.dim() - 2, depth_panel(img.shape[-2]))
    return _resize_axis(rows, new_hw[1], img.dim() - 1)


def level_shape(h: int, w: int, scale: float, lv: int) -> tuple[int, int]:
    s = scale ** lv
    return max(int(round(h / s)), 8), max(int(round(w / s)), 8)


def build_pyramid(img: torch.Tensor, num_levels: int, scale: float) -> list[torch.Tensor]:
    """List of (..., H_l, W_l) images, level l at size round(shape / scale**l)."""
    h, w = img.shape[-2:]
    out = [img]
    for lv in range(1, num_levels):
        out.append(resize_bilinear(img, level_shape(h, w, scale, lv)))
    return out


def sobel_gradients(img: torch.Tensor):
    """(gx, gy) of a (H, W) image: the two 3x3 Sobel correlations with
    replicate padding, written as shifted adds (no cuDNN: exact on
    integer-valued images, the same order on the CPU and the card)."""
    p = torch.nn.functional.pad(img[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    h, w = img.shape

    def at(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    gx = (at(-1, 1) - at(-1, -1)) + 2.0 * (at(0, 1) - at(0, -1)) + (at(1, 1) - at(1, -1))
    gy = (at(1, -1) - at(-1, -1)) + 2.0 * (at(1, 0) - at(-1, 0)) + (at(1, 1) - at(-1, 1))
    return gx, gy


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Values of a (H, W) image at float (..., 2) (x, y) positions, clamped
    to [0, W - 1.001] x [0, H - 1.001], from four flat gathers."""
    h, w = img.shape
    x = torch.clamp(xy[..., 0], 0.0, w - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = x - x0
    fy = y - y0
    flat = img.reshape(-1)
    v00, v01 = flat[y0 * w + x0], flat[y0 * w + x1]
    v10, v11 = flat[y1 * w + x0], flat[y1 * w + x1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy) + v10 * (1 - fx) * fy
            + v11 * fx * fy)


def gray_image(img, device) -> torch.Tensor:
    """A grey (H, W) or colour (H, W, 3) image, numpy or tensor -> (H, W)
    float32 on ``device`` (colour channels averaged)."""
    t = img if isinstance(img, torch.Tensor) else torch.as_tensor(np.asarray(img, np.float32))
    t = t.to(device=device, dtype=torch.float32)
    return t.mean(-1) if t.dim() == 3 else t


_SCAN_BASE = 16   # XLA's reduce-window rewrite: blocks of 16, then the block sums


def cumsum_xla(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sum along ``dim``, rounded as the reference's CPU
    backend rounds ``jnp.cumsum``: XLA rewrites the cumulative reduce-window
    into blocks of 16 (zero-padded at the end), sums each block from its
    start one element at a time, scans the block totals the same way
    (recursively), and adds each block's exclusive prefix to its partial
    sums.  Plain ``torch.cumsum`` associates differently, which matters for
    float32 integral images that pass 2^24."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    b = _SCAN_BASE
    if n <= b:
        out = x.clone()
        for i in range(1, n):
            out[..., i] = out[..., i - 1] + x[..., i]
        return out.movedim(-1, dim)
    nb = -(-n // b)
    xp = torch.nn.functional.pad(x, (0, nb * b - n)).reshape(*x.shape[:-1], nb, b)
    inner = cumsum_xla(xp, -1)
    outer = cumsum_xla(inner[..., -1], -1)
    excl = torch.cat([torch.zeros_like(outer[..., :1]), outer[..., :-1]], -1)
    out = (inner + excl[..., None]).reshape(*x.shape[:-1], nb * b)[..., :n]
    return out.movedim(-1, dim)


def integral_image(img: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H + 1, W + 1) summed-area table with a zero first row and
    column: the reference's ``pad(cumsum(cumsum(img, 0), 1))`` in its
    rounding (``cumsum_xla``)."""
    ii = cumsum_xla(cumsum_xla(img, 0), 1)
    return torch.nn.functional.pad(ii, (1, 0, 1, 0))
