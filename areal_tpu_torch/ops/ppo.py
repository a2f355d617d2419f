"""PPO math over packed sequences (counterpart of ``areal_tpu/ops/ppo.py``).

Every array lives on one padded packed token axis ``[T]`` with
``segment_ids`` (0 = pad); the GAE bootstrap is an explicit per-token
``next_values`` array. Loss math runs in float32. The reference solves the
GAE recurrence with an associative scan; here it is a plain reverse loop on
the host (a few thousand tokens per batch, off the device's hot path).
"""

from typing import Dict, Optional, Tuple

import torch

# --------------------------------------------------------------------------- #
# KL controllers (host-side Python state)
# --------------------------------------------------------------------------- #


class FixedKLController:
    def __init__(self, kl_coef: float):
        self.value = kl_coef

    def update(self, current: float, n_steps: int):
        pass


class AdaptiveKLController:
    """Adaptive KL controller (arXiv:1909.08593)."""

    def __init__(self, init_kl_coef: float, target: float, horizon: float):
        self.value = init_kl_coef
        self.target = target
        self.horizon = horizon

    def update(self, current: float, n_steps: int):
        proportional_error = min(max(current / self.target - 1, -0.2), 0.2)
        self.value *= 1 + proportional_error * n_steps / self.horizon


# --------------------------------------------------------------------------- #
# Losses
# --------------------------------------------------------------------------- #


def actor_loss_fn(
    logprobs: torch.Tensor,
    old_logprobs: torch.Tensor,
    advantages: torch.Tensor,
    eps_clip: float,
    loss_mask: torch.Tensor,
    c_clip: Optional[float] = None,
    proximal_logprobs: Optional[torch.Tensor] = None,
    behav_imp_weight_cap: Optional[float] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decoupled-PPO actor loss. ``proximal_logprobs`` activates the
    decoupled objective: the clip ratio is taken w.r.t. the proximal
    (recomputed) policy while the behavioural policy contributes an
    importance weight ``exp(proximal - behav)``, optionally capped.
    ``c_clip`` activates dual clipping (arXiv:1912.09729)."""
    logprobs = logprobs.float()
    old_logprobs = old_logprobs.float()
    advantages = advantages.float()
    loss_mask = loss_mask.bool()
    denorm_logprobs = (
        proximal_logprobs.float() if proximal_logprobs is not None
        else old_logprobs
    )
    n_valid = loss_mask.sum().clamp_min(1)

    ratio = torch.where(loss_mask, torch.exp(logprobs - denorm_logprobs), 0.0)
    clipped_ratio = ratio.clamp(1.0 - eps_clip, 1.0 + eps_clip)
    pg_loss1 = -advantages * ratio
    pg_loss2 = -advantages * clipped_ratio
    clip_mask = (pg_loss1 < pg_loss2).detach()
    pg_loss = torch.maximum(pg_loss1, pg_loss2)
    if c_clip is not None:
        if not c_clip > 1.0:
            raise ValueError(f"c_clip must exceed 1, got {c_clip}")
        pg_loss3 = torch.sign(advantages) * c_clip * advantages
        dual_clip_mask = (pg_loss3 < pg_loss).detach()
        pg_loss = torch.minimum(pg_loss, pg_loss3)
    else:
        dual_clip_mask = torch.zeros_like(clip_mask)

    stat: Dict[str, torch.Tensor] = {}
    if proximal_logprobs is not None:
        behav_kl = proximal_logprobs.float() - old_logprobs
        behav_imp_weight = torch.exp(behav_kl)
        if behav_imp_weight_cap is not None:
            behav_mask = (behav_imp_weight <= behav_imp_weight_cap) & loss_mask
        else:
            behav_mask = loss_mask
        behav_kl = torch.where(behav_mask, behav_kl, 0.0)
        behav_imp_weight = torch.where(behav_mask, behav_imp_weight, 0.0)
        pg_loss = pg_loss * behav_imp_weight.detach()
        stat.update(
            behave_imp_weight=behav_imp_weight,
            behave_approx_kl=behav_kl,
            behave_mask=behav_mask,
        )

    loss = torch.where(loss_mask, pg_loss, 0.0).sum() / n_valid
    stat.update(
        loss=pg_loss.detach(),
        importance_weight=ratio.detach(),
        approx_kl=(logprobs - denorm_logprobs).detach(),
        clip_mask=clip_mask & loss_mask,
        dual_clip_mask=dual_clip_mask & loss_mask,
    )
    return loss, stat


def _huber(x, y, delta: float = 10.0):
    diff = (x - y).abs()
    return torch.where(diff < delta, 0.5 * diff**2, delta * (diff - 0.5 * delta))


def _mse(x, y):
    return 0.5 * (x - y) ** 2


def critic_loss_fn(
    value: torch.Tensor,
    old_value: torch.Tensor,
    target_value: torch.Tensor,
    value_eps_clip: float,
    loss_mask: torch.Tensor,
    loss_fn_type: str = "mse",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped value loss."""
    value = value.float()
    old_value = old_value.float()
    target_value = target_value.float()
    loss_mask = loss_mask.bool()
    loss_fn = {"huber": _huber, "mse": _mse}[loss_fn_type]

    loss_original = loss_fn(value, target_value)
    value_clipped = old_value + (value - old_value).clamp(
        -value_eps_clip, value_eps_clip
    )
    loss_clipped = loss_fn(value_clipped, target_value)
    value_loss = torch.maximum(loss_original, loss_clipped)
    clip_mask = (loss_clipped > loss_original).detach() & loss_mask
    n_valid = loss_mask.sum().clamp_min(1)
    loss = torch.where(loss_mask, value_loss, 0.0).sum() / n_valid
    return loss, {"clip_mask": clip_mask, "loss": value_loss.detach()}


# --------------------------------------------------------------------------- #
# Rewards & GAE on the packed segment layout
# --------------------------------------------------------------------------- #


def _shift_left(x: torch.Tensor) -> torch.Tensor:
    """``x[t + 1]`` along the last axis, 0 past the end."""
    return torch.cat([x[..., 1:], torch.zeros_like(x[..., :1])], dim=-1)


def is_segment_end(segment_ids: torch.Tensor) -> torch.Tensor:
    """True at the last token of each segment along the last axis (padding
    rows are False)."""
    return (segment_ids > 0) & (_shift_left(segment_ids) != segment_ids)


def get_packed_rewards(
    kl_ctl: float,
    clip_reward_value: float,
    log_probs: torch.Tensor,       # [T] behaviour logprobs at action tokens
    ref_log_probs: torch.Tensor,   # [T]
    reward_score: torch.Tensor,    # [T] per token; read at segment ends
    segment_ids: torch.Tensor,     # [T]
    seq_no_eos_mask: torch.Tensor, # [T] broadcast per token (True = truncated)
    mask_no_eos_with_zero: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """KL penalty everywhere plus the (clipped) task reward on the final
    token of each sequence."""
    mask = segment_ids > 0
    kl_rewards = torch.where(mask, -kl_ctl * (log_probs - ref_log_probs), 0.0)
    score = reward_score.clamp(-clip_reward_value, clip_reward_value)
    at_end = is_segment_end(segment_ids)
    if mask_no_eos_with_zero:
        score = torch.where(seq_no_eos_mask.bool(), 0.0, score)
    tot_rewards = kl_rewards + torch.where(at_end, score, 0.0)
    return kl_rewards, tot_rewards


def segment_next_values(
    values: torch.Tensor, segment_ids: torch.Tensor, bootstrap: torch.Tensor
) -> torch.Tensor:
    """next_values[t] = values[t+1] within a segment; at the segment's last
    token, ``bootstrap[t]``."""
    return torch.where(is_segment_end(segment_ids), bootstrap,
                       _shift_left(values))


def segment_gae(
    rewards: torch.Tensor,      # [T] fp32
    values: torch.Tensor,       # [T] fp32
    next_values: torch.Tensor,  # [T] fp32 (see segment_next_values)
    segment_ids: torch.Tensor,  # [T]
    gamma: float,
    lam: float,
    mask: Optional[torch.Tensor] = None,     # valid action positions
    not_end: Optional[torch.Tensor] = None,  # t+1 continues the trajectory
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE over every segment at once: advantages and returns, zero outside
    ``mask``. By default a trajectory is a whole segment; PPO passes an
    action ``mask`` and a matching ``not_end`` so trajectories span only
    the action positions. ``A_t = delta_t + c_t * A_{t+1}`` with
    ``c_t = gamma * lam`` where t+1 continues, solved by a reverse loop on
    the host in float64 and returned as float32 on the inputs' device."""
    if mask is None:
        mask = segment_ids > 0
    maskf = mask.float()
    values = values.float()
    delta = (rewards.float() * maskf + gamma * next_values.float() - values) * maskf
    if not_end is None:
        not_end = ~is_segment_end(segment_ids)
    c = gamma * lam * not_end.float() * maskf
    d_host = delta.double().cpu().tolist()
    c_host = c.double().cpu().tolist()
    adv = [0.0] * len(d_host)
    carry = 0.0
    for t in range(len(d_host) - 1, -1, -1):
        carry = d_host[t] + c_host[t] * carry
        adv[t] = carry
    advantages = torch.tensor(adv, dtype=torch.float32,
                              device=values.device) * maskf
    returns = (advantages + values) * maskf
    return advantages, returns


# --------------------------------------------------------------------------- #
# Packed logprob / normalization helpers
# --------------------------------------------------------------------------- #


def gather_logprobs(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Log p(labels[t] | logits[t]) for each packed position, fp32. [T]"""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return logp.gather(-1, labels.long()[:, None])[:, 0]


def gather_packed_shifted_log_probs(
    logits: torch.Tensor, input_ids: torch.Tensor, segment_ids: torch.Tensor
) -> torch.Tensor:
    """Logprob of the *next* token at each position (zero where the next
    token leaves the segment); the output stays ``[T]``."""
    lp = gather_logprobs(logits, _shift_left(input_ids))
    has_next = (segment_ids > 0) & ~is_segment_end(segment_ids)
    return torch.where(has_next, lp, 0.0)


def entropy_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """Per-position categorical entropy, fp32. [T]"""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(logp.exp() * logp).sum(-1)


def masked_normalization(
    x: torch.Tensor,
    mask: torch.Tensor,
    eps: float = 1e-5,
    unbiased: bool = False,
) -> torch.Tensor:
    """Normalize to zero mean / unit std over masked entries (fp32)."""
    x = x.float()
    mask = mask.float()
    n = mask.sum().clamp_min(1.0)
    mean = (x * mask).sum() / n
    var = ((x - mean).square() * mask).sum() / (
        n - (1.0 if unbiased else 0.0)
    ).clamp_min(1.0)
    return torch.where(mask > 0, (x - mean) / torch.sqrt(var + eps), x)


def group_normalization(
    x: torch.Tensor,
    mask: torch.Tensor,
    group_ids: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
    std_norm: bool = True,
) -> torch.Tensor:
    """GRPO-style per-group advantage normalization: subtract the group mean
    (and optionally divide by the group std) where groups share a prompt."""
    x = x.float()
    m = mask.float()
    gid = group_ids.long()

    def segment_sum(vals):
        return torch.zeros(num_groups, dtype=torch.float32,
                           device=x.device).index_add_(0, gid, vals)

    gcnt = segment_sum(m).clamp_min(1.0)
    out = x - (segment_sum(x * m) / gcnt)[gid]
    if std_norm:
        gvar = segment_sum(out.square() * m)
        out = out / torch.sqrt(gvar / gcnt + eps)[gid]
    return torch.where(m > 0, out, x)
