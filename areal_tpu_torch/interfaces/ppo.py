"""PPO actor & critic interfaces, decoupled async PPO (counterpart of
``areal_tpu/interfaces/ppo.py``).

The train step mirrors the reference: reward shaping with a KL penalty ->
GAE -> (group-)advantage normalization over the *whole* batch -> a
minibatch loop with one optimizer step each, using the decoupled /
dual-clip actor loss. Every per-token quantity is token-aligned on the
packed axis (the logprob at position t is log p(token t+1 | <= t)), so the
action mask is "has a next token AND the next token is generated".

This slice runs one process: where the reference all-reduces over hosts
(the minibatch count, the KL-controller statistics), the port takes the
local value.
"""

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model import ModelInterface, PPOHyperparameters
from areal_tpu_torch.interfaces.sft import label_is_prompt
from areal_tpu_torch.ops import ppo as ppo_ops
from areal_tpu_torch.train import batching
from areal_tpu_torch.train import engine as engine_mod
from areal_tpu_torch.train.engine import vmapped_forward, vmapped_next_token_logprobs


def _action_mask(arrays) -> torch.Tensor:
    """[rows, T] bool: positions whose *label* (next token) is a generated
    token of the same segment."""
    seg = arrays["segment_ids"]
    has_next = (seg > 0) & ~ppo_ops.is_segment_end(seg)
    return has_next & ~label_is_prompt(arrays)


def logprob_output_fn(params, cfg, arrays):
    """Token-aligned logprobs of the next token — the "inference" call that
    recomputes proximal logprobs. Honors ``cfg.loss_chunk_size``."""
    return vmapped_next_token_logprobs(params, cfg, arrays)


def value_output_fn(params, cfg, arrays):
    """Per-token critic values [rows, T] (zero on padding)."""
    values = vmapped_forward(params, cfg, arrays)[..., 0]
    return torch.where(arrays["segment_ids"] > 0, values, 0.0)


def _kl_controller(hp: PPOHyperparameters):
    if hp.use_adaptive_kl:
        return ppo_ops.AdaptiveKLController(
            hp.kl_ctl, hp.adaptive_kl_target, hp.adaptive_kl_horizon
        )
    return ppo_ops.FixedKLController(hp.kl_ctl)


def _shift_left(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[1:], torch.zeros_like(x[:1])])


@dataclasses.dataclass
class PPOActorInterface(ModelInterface):
    hp: PPOHyperparameters = dataclasses.field(default_factory=PPOHyperparameters)
    hf_family: Optional[str] = None

    def __post_init__(self):
        self.kl_ctl = _kl_controller(self.hp)
        self._last_ref_kl = 0.0
        self._actor_loss_fn = self._build_actor_loss()

    def _build_actor_loss(self):
        hp = self.hp

        def actor_loss(params, cfg, arrays):
            mask = _action_mask(arrays)
            new_lp, aux = vmapped_next_token_logprobs(params, cfg, arrays,
                                                      with_aux=True)
            old_lp = arrays["packed_logprobs"].float()
            prox = arrays.get("prox_logp")
            if hp.use_decoupled_loss and prox is not None:
                prox = prox.float()
            elif hp.recompute_logprob and prox is not None:
                # sync PPO with recomputed logprobs: use them as "old"
                old_lp, prox = prox.float(), None
            else:
                prox = None
            loss, stat = ppo_ops.actor_loss_fn(
                new_lp.reshape(-1),
                old_lp.reshape(-1),
                arrays["advantages"].float().reshape(-1),
                hp.eps_clip,
                mask.reshape(-1),
                c_clip=hp.c_clip,
                proximal_logprobs=None if prox is None else prox.reshape(-1),
                behav_imp_weight_cap=hp.behav_imp_weight_cap,
            )
            n = mask.sum().clamp_min(1)
            return loss + aux, {
                "actor_loss": loss.detach(),
                "importance_weight": stat["importance_weight"].sum() / n,
                "actor_clip_ratio": stat["clip_mask"].sum() / n,
                "approx_kl": (stat["approx_kl"] * mask.reshape(-1)).abs().sum() / n,
            }

        return actor_loss

    # proximal logprob recompute -------------------------------------- #

    def inference(
        self, engine, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        outs = engine.forward(sample, mb_spec, logprob_output_fn)
        main = sample.main_key()
        return SequenceSample(
            keys={"prox_logp"},
            ids=list(sample.ids),
            seqlens={"prox_logp": [list(l) for l in sample.seqlens[main]]},
            data={"prox_logp": np.concatenate(
                [o.astype(np.float32) for o in outs])},
        )

    # advantages over the full batch ---------------------------------- #

    def _prepare(self, sample: SequenceSample) -> SequenceSample:
        """Advantages / returns on the whole batch (flat packed layout, on
        the host), attached as new keys."""
        hp = self.hp
        pb = batching.pack_sequences(sample, n_rows=1, pad_multiple=128)
        a = {k: torch.from_numpy(v[0]) for k, v in pb.arrays.items()}
        seg = a["segment_ids"]
        mask = _action_mask({k: v[None] for k, v in a.items()})[0]

        behav_lp = a["packed_logprobs"].float()
        ref_lp = a.get("packed_ref_logprobs")
        if ref_lp is None:
            ref_lp = behav_lp  # zero KL penalty
        values = a.get("values")
        if values is None or hp.disable_value:
            values = torch.zeros_like(behav_lp)
        values = values.float() * mask

        reward_score = (a["rewards"].float() * hp.reward_output_scaling
                        + hp.reward_output_bias)
        no_eos = a.get("seq_no_eos_mask")
        no_eos = (torch.zeros_like(reward_score, dtype=torch.bool)
                  if no_eos is None else no_eos.bool())

        # KL-penalized dense rewards + task reward at the *last action* token
        ref_kl = behav_lp - ref_lp.float()
        ref_kl_mean = torch.where(mask, ref_kl, 0.0).sum() / mask.sum().clamp_min(1)
        kl_rw = torch.where(mask, -self.kl_ctl.value * ref_kl, 0.0)
        nxt_mask = _shift_left(mask)
        last_action = mask & ~nxt_mask
        score = reward_score.clamp(-hp.max_reward_clip, hp.max_reward_clip)
        if hp.mask_no_eos_with_zero:
            score = torch.where(no_eos, 0.0, score)
        rewards = kl_rw + torch.where(last_action, score, 0.0)

        # next values: values[t+1] within the action span; at the last
        # action, bootstrap with the next token's value iff truncated
        shifted_v = _shift_left(values)
        raw_v = a.get("values")
        if raw_v is not None and not hp.disable_value:
            shifted_raw = _shift_left(raw_v.float())
        else:
            shifted_raw = torch.zeros_like(values)
        next_values = torch.where(
            nxt_mask, shifted_v, torch.where(no_eos, shifted_raw, 0.0)
        )

        adv, ret = ppo_ops.segment_gae(
            rewards, values, next_values, seg, hp.discount, hp.gae_lambda,
            mask=mask, not_end=nxt_mask,
        )
        if hp.group_adv_norm:
            adv = ppo_ops.group_normalization(
                adv, mask, a["item_ids"], num_groups=sample.bs
            )
        elif hp.adv_norm:
            adv = ppo_ops.masked_normalization(adv, mask)

        self._last_ref_kl = float(ref_kl_mean)
        main = sample.main_key()
        seqlens, data = {}, {}
        for key, arr in (("advantages", adv), ("returns", ret),
                         ("kl_rewards", kl_rw)):
            seqlens[key] = [list(l) for l in sample.seqlens[main]]
            per_seq = pb.unpack(arr.numpy()[None])
            data[key] = np.concatenate(per_seq).astype(np.float32)
        sample.update_(SequenceSample(keys=set(seqlens), ids=list(sample.ids),
                                      seqlens=seqlens, data=data))
        return sample

    # train step -------------------------------------------------------- #

    def train_step(
        self, engine, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict[str, float]:
        hp = self.hp
        sample = self._prepare(sample)
        mbs = sample.split(max(min(hp.ppo_n_minibatches, sample.bs), 1))
        all_stats = [
            engine.train_batch(mb, mb_spec, self._actor_loss_fn,
                               fetch_stats=False)
            for mb in mbs
        ]
        engine.version += 1
        out = engine_mod.mean_stats_dicts(all_stats)
        # adaptive KL tracks policy-vs-reference divergence (the signed
        # masked mean over action tokens), not the PPO update KL
        self.kl_ctl.update(self._last_ref_kl, sample.bs)
        out["kl_ctl"] = self.kl_ctl.value
        out["ref_kl"] = self._last_ref_kl
        out["n_seqs"] = sample.bs
        return engine_mod.fetch_stats_dict(out)


@dataclasses.dataclass
class PPOCriticInterface(ModelInterface):
    hp: PPOHyperparameters = dataclasses.field(default_factory=PPOHyperparameters)
    hf_family: Optional[str] = None
    # share the ACTOR's controller: with adaptive KL the critic's value
    # targets must be shaped with the same coefficient as the advantages
    kl_ctl: Optional[object] = None

    def __post_init__(self):
        if self.kl_ctl is None:
            self.kl_ctl = _kl_controller(self.hp)
        # the helper only runs _prepare (reward shaping + GAE) with the
        # shared coefficient; the actor owns the controller's updates
        self._actor_helper = PPOActorInterface(hp=self.hp)
        self._actor_helper.kl_ctl = self.kl_ctl
        hp = self.hp

        def critic_loss(params, cfg, arrays):
            mask = _action_mask(arrays)
            values, aux = vmapped_forward(params, cfg, arrays, with_aux=True)
            new_values = torch.where(arrays["segment_ids"] > 0,
                                     values[..., 0], 0.0)
            loss, stat = ppo_ops.critic_loss_fn(
                new_values.reshape(-1),
                arrays["values"].float().reshape(-1),
                arrays["returns"].float().reshape(-1),
                hp.value_eps_clip,
                mask.reshape(-1),
            )
            n = mask.sum().clamp_min(1)
            return loss + aux, {
                "critic_loss": loss.detach(),
                "value_clip_ratio": stat["clip_mask"].sum() / n,
            }

        self._critic_loss_fn = critic_loss

    def inference(
        self, engine, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> SequenceSample:
        outs = engine.forward(sample, mb_spec, value_output_fn)
        main = sample.main_key()
        return SequenceSample(
            keys={"values"},
            ids=list(sample.ids),
            seqlens={"values": [list(l) for l in sample.seqlens[main]]},
            data={"values": np.concatenate(
                [o.astype(np.float32) for o in outs])},
        )

    def train_step(
        self, engine, sample: SequenceSample, mb_spec: MicroBatchSpec
    ) -> Dict[str, float]:
        hp = self.hp
        sample = self._actor_helper._prepare(sample)
        mbs = sample.split(max(min(hp.ppo_n_minibatches, sample.bs), 1))
        all_stats = [
            engine.train_batch(mb, mb_spec, self._critic_loss_fn,
                               fetch_stats=False)
            for mb in mbs
        ]
        engine.version += 1
        return engine_mod.fetch_stats_dict(engine_mod.mean_stats_dicts(all_stats))
