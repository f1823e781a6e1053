"""The training losses: ``evfly_tpu/train/losses.py`` on torch tensors
(reference learner.py:1101-1144).

Per-term weighted MSE with the reference's optional-loss-param behaviours:

* term 0 (velocity), optional_loss_param[0] != 0: elementwise MSE up-weighted
  by optional_loss_param[0] on frames whose ground-truth y or z command is
  nonzero (:1105-1113);
* term 1 (vision), optional_loss_param[1] != 0: elementwise MSE, scaled by
  1 / (gt + 0.1) when the param is < 0 (inverse-depth weighting,
  :1121-1124) and, when it is exactly -2.0, also masked to gt < 0.99
  (:1126-1128);
* otherwise plain MSE.

Each term returns (backprop term, logged value): the logged value is the
unweighted mean, the backprop term the weighted one.  Velocity ground truth
is normalized by the desired velocity (gt / desvel) before it reaches these
functions.  A frame mask makes padded chunk tails contribute nothing, and
means divide by the count of valid elements, so a padded chunk gives the
reference's unpadded ``.mean()``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the valid frames only; mask (N,) broadcasts over x's
    trailing dims."""
    m = mask.reshape((-1,) + (1,) * (x.ndim - 1))
    num = torch.sum(x * m)
    per_frame = 1
    for d in x.shape[1:]:
        per_frame *= d
    den = torch.sum(mask) * per_frame
    return num / torch.clamp_min(den, 1.0)


def velocity_loss(gt_norm: torch.Tensor, pred: torch.Tensor, mask: torch.Tensor,
                  optional_param: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """gt_norm, pred (N, 3); returns (backprop term, logged value)."""
    err = torch.square(gt_norm - pred)
    value = _masked_mean(err, mask)
    if optional_param == 0.0:
        return value, value
    nonzero_yz = (gt_norm[:, 1].abs() > 0.0) | (gt_norm[:, 2].abs() > 0.0)
    scaler = torch.where(nonzero_yz, optional_param, 1.0).to(err.dtype)[:, None]
    return _masked_mean(err * scaler, mask), value


def vision_loss(gt_norm: torch.Tensor, pred: torch.Tensor, mask: torch.Tensor,
                optional_param: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """gt_norm, pred (N, 1, H, W); returns (backprop term, logged value)."""
    err = torch.square(gt_norm - pred)
    value = _masked_mean(err, mask)
    if optional_param == 0.0:
        return value, value
    scaled = err
    if optional_param < 0:
        scaled = scaled * (1.0 / (gt_norm + 0.1))
    if optional_param == -2.0:
        scaled = scaled * (gt_norm < 0.99).to(scaled.dtype)
    return _masked_mean(scaled, mask), value


def combined_loss(
    gt_norms: Sequence[torch.Tensor],
    preds: Sequence[torch.Tensor],
    mask: torch.Tensor,
    loss_weights: Optional[Sequence[float]],
    optional_loss_param: Optional[Sequence[float]],
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Weighted sum of the loss terms -> (batch loss, [logged values])."""
    weights = [1.0] * len(gt_norms) if loss_weights is None else list(loss_weights)
    olp = list(optional_loss_param) if optional_loss_param is not None else [0.0, 0.0]
    while len(olp) < len(gt_norms):
        olp.append(0.0)

    total = 0.0
    values = []
    for i, (gt, pred) in enumerate(zip(gt_norms, preds)):
        if i == 0:
            term, value = velocity_loss(gt, pred, mask, olp[0])
        elif i == 1:
            term, value = vision_loss(gt, pred, mask, olp[1])
        else:
            value = _masked_mean(torch.square(gt - pred), mask)
            term = value
        total = total + weights[i] * term
        values.append(value)
    return total, values
