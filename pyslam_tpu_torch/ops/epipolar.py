"""Minimal-sample drawing for batched-hypothesis RANSAC (port of
``_sample_minimal`` of ``pyslam_tpu/ops/epipolar.py:24-50``; the essential
and homography solvers of that module come with the RGBD and mono slice).

A fixed batch of hypotheses is drawn at once: every hypothesis scores each
correspondence with Gumbel noise plus its log-weight, invalid rows get
-inf, and the hypothesis takes its ``sample_size`` best rows (sampling
without replacement within a hypothesis, probability proportional to the
weight).  The draws come from an explicit ``torch.Generator`` on the
tensors' device, so they differ from the reference's threefry keys by
design; the parity tests inject the reference's samples instead.
"""

from __future__ import annotations

import torch


def _sample_minimal(valid: torch.Tensor, num_hyp: int, sample_size: int,
                    weights: torch.Tensor | None = None, *,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """(num_hyp, sample_size) int64 row indices drawn over the valid rows;
    equal scores keep the lower index first (stable sort)."""
    n = valid.shape[0]
    u = torch.rand((num_hyp, n), generator=generator, device=valid.device)
    tiny = torch.finfo(u.dtype).tiny
    g = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    if weights is not None:
        g = g + torch.log(torch.clamp(weights.to(g.dtype), min=1e-20))
    g = torch.where(valid, g, torch.full((), float("-inf"), device=g.device))
    return torch.sort(g, dim=-1, descending=True, stable=True)[1][:, :sample_size]


def generator_sampler(device: torch.device, seed: int):
    """The default minimal-sample source of the RANSAC callers:
    ``_sample_minimal`` on one ``torch.Generator`` seeded ``seed``.  A
    sampler takes (valid, num_hyp, sample_size, weights) and returns
    (num_hyp, sample_size) row indices."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def sample(valid, num_hyp, sample_size, weights=None):
        return _sample_minimal(valid, num_hyp, sample_size, weights, generator=gen)

    return sample
