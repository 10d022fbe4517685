"""MultiBox loss — smooth-L1 localization + hard-negative-mined softmax.

Counterpart of ``analytics_zoo_tpu/models/image/objectdetection/
multibox_loss.py`` (ref Scala ``MultiBoxLoss.scala``), the same
arithmetic in torch: smooth-L1 on the positives, a log-softmax
cross-entropy on every anchor, and hard-negative mining by rank (each
background anchor's rank in a sort of the cross-entropies, descending;
the ``neg_pos_ratio * n_pos`` first are kept), so the loss has the
graph's static shapes and runs on the device inside the train step.

The sort is stable, as ``jnp.argsort`` is: equal cross-entropies are
common (a head at zero gives every anchor ``log(C + 1)``), and an
unstable sort would keep other negatives than JAX's. The rank of each
anchor is the inverse of the sort's permutation, written by a scatter
(JAX takes a second argsort; a permutation has one inverse, so the ranks
are the same).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def mining_ranks(ce: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``[b, A]`` rank of each anchor in the descending stable sort of the
    background anchors' cross-entropies (positives sort last)."""
    neg_ce = torch.where(pos, torch.full_like(ce, float("-inf")), ce)
    order = torch.argsort(-neg_ce, dim=1, stable=True)
    ar = torch.arange(ce.shape[1], device=ce.device).expand_as(order)
    return torch.empty_like(order).scatter_(1, order, ar)


class MultiBoxLoss:
    """``loss(y_true [b,A,5], y_pred [b,A,4+C+1])`` with y_true from
    ``bbox_util.encode_targets`` (label 0 = background); the mean over the
    batch of ``(loc_weight * loc + conf) / max(n_pos, 1)``.

    (ref MultiBoxLoss.scala: locWeight, negPosRatio=3, overlap mining)
    """

    def __init__(self, n_classes: int, neg_pos_ratio: float = 3.0,
                 loc_weight: float = 1.0):
        self.n_classes = int(n_classes)
        self.neg_pos_ratio = float(neg_pos_ratio)
        self.loc_weight = float(loc_weight)

    def __call__(self, y_true: torch.Tensor, y_pred: torch.Tensor):
        # a bf16 head output is scored in fp32; float64 stays float64
        y_pred = y_pred.to(torch.promote_types(y_pred.dtype, torch.float32))
        y_true = y_true.to(y_pred.dtype)
        loc_t = y_true[..., :4]
        labels = y_true[..., 4].long()                    # [b, A]
        loc_p = y_pred[..., :4]
        conf_p = y_pred[..., 4:]                          # [b, A, C+1]

        pos = labels > 0
        posf = pos.to(y_pred.dtype)
        n_pos = posf.sum(1)                               # [b]

        loc_loss = smooth_l1(loc_p - loc_t).sum(-1)       # [b, A]
        loc_loss = (loc_loss * posf).sum(1)               # [b]

        logp = F.log_softmax(conf_p, dim=-1)
        ce = -logp.gather(-1, labels[..., None])[..., 0]  # [b, A]

        with torch.no_grad():
            ranks = mining_ranks(ce, pos)
            k = torch.clamp(self.neg_pos_ratio * n_pos, min=1.0)
            neg = ~pos & (ranks < k[:, None])
        conf_loss = (ce * (pos | neg).to(ce.dtype)).sum(1)

        denom = torch.clamp(n_pos, min=1.0)
        total = (self.loc_weight * loc_loss + conf_loss) / denom
        return total.mean()
