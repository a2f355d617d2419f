"""Algorithm recipes as dataflow graphs (a copy of
``areal_tpu/experiments/graphs.py``): the PPO variants (critic on/off,
reference model on/off, EMA reference) differ only in which MFC nodes
exist and which hooks hang off them, never in trainer code.
"""

from typing import Dict, List, Optional, Sequence, Tuple

from areal_tpu_torch.api.data import MicroBatchSpec
from areal_tpu_torch.api.dfg import (DataFlowGraph, MFCDef, ParamReallocHook,
                                     build_graph)
from areal_tpu_torch.api.model import (ModelInterface, PPOHyperparameters,
                                       make_interface)

# Keys the rollout stream always provides.
ROLLOUT_BATCH_KEYS = (
    "packed_input_ids",
    "prompt_mask",
    "packed_logprobs",
    "rewards",
    "seq_no_eos_mask",
)


def build_ppo_graph(
    hp: PPOHyperparameters,
    use_ref: bool,
    use_critic: bool,
    ema_ref_eta: Optional[float] = None,
    mb_spec: Optional[MicroBatchSpec] = None,
    hf_family: Optional[str] = None,
    batch_keys: Sequence[str] = ROLLOUT_BATCH_KEYS,
    ref_logprobs_in_batch: bool = False,
    use_reward_model: bool = False,
) -> Tuple[DataFlowGraph, Dict[str, ModelInterface]]:
    """The async / sync PPO training graph.

    Nodes (conditional on config):
      ref_inf     frozen reference logprobs         (use_ref, kl_ctl != 0)
      critic_inf  value estimates                   (use_critic)
      actor_inf   proximal logprob recompute        (decoupled loss)
      actor_train PPO policy update [+ EMA-ref hook when ema_ref_eta]
      critic_train value update

    Returns the validated graph plus the shared interface instances (one
    actor interface drives ref_inf / actor_inf / actor_train so the KL
    controller state is singular; the critic interface shares it).

    ``ref_logprobs_in_batch``: the data source itself ships
    ``packed_ref_logprobs``; without a ref model the actor loss falls back
    to zero KL penalty. ``use_reward_model`` (a trained RM's ``reward_inf``
    node) raises ``NotImplementedError``: ``interfaces/reward.py`` is
    ported, its node in this graph is not wired yet.
    """
    if use_reward_model:
        raise NotImplementedError(
            "the reward-model graph node (reward_inf) is not ported yet "
            "(ROADMAP.md)")
    mb_spec = mb_spec or MicroBatchSpec()
    actor_if = make_interface("ppo_actor", hp=hp, hf_family=hf_family)
    interfaces: Dict[str, ModelInterface] = {}
    mfcs: List[MFCDef] = []
    batch_keys = tuple(batch_keys)
    # ref_inf only feeds the KL penalty: with kl_ctl == 0 it is skipped
    # (the "ref" engine may still exist for ParamReallocHooks)
    use_ref_inf = use_ref and hp.kl_ctl != 0
    if ref_logprobs_in_batch and not use_ref_inf:
        batch_keys += ("packed_ref_logprobs",)

    have_ref_lp = use_ref_inf or "packed_ref_logprobs" in batch_keys
    ref_lp_key = ("packed_ref_logprobs",) if have_ref_lp else ()

    if use_ref_inf:
        mfcs.append(
            MFCDef(
                name="ref_inf",
                model_name="ref",
                interface_type="inference",
                input_keys=("packed_input_ids",),
                output_keys=("packed_ref_logprobs",),
                output_key_remap={"prox_logp": "packed_ref_logprobs"},
                mb_spec=mb_spec,
            )
        )
        interfaces["ref_inf"] = actor_if

    if use_critic:
        mfcs.append(
            MFCDef(
                name="critic_inf",
                model_name="critic",
                interface_type="inference",
                input_keys=("packed_input_ids",),
                output_keys=("values",),
                mb_spec=mb_spec,
            )
        )

    use_prox = hp.use_decoupled_loss or hp.recompute_logprob
    if use_prox:
        mfcs.append(
            MFCDef(
                name="actor_inf",
                model_name="actor",
                interface_type="inference",
                input_keys=("packed_input_ids",),
                output_keys=("prox_logp",),
                mb_spec=mb_spec,
            )
        )
        interfaces["actor_inf"] = actor_if

    train_inputs = (
        "packed_input_ids", "prompt_mask", "packed_logprobs", "rewards",
        "seq_no_eos_mask",
    ) + ref_lp_key
    actor_train = MFCDef(
        name="actor_train",
        model_name="actor",
        interface_type="train_step",
        input_keys=train_inputs
        + (("prox_logp",) if use_prox else ())
        + (("values",) if use_critic else ()),
        mb_spec=mb_spec,
    )
    if ema_ref_eta is not None:
        if not use_ref:
            raise ValueError("EMA reference requires a ref model")
        # ref <- eta * actor + (1 - eta) * ref after every policy update
        actor_train.post_hooks.append(
            ParamReallocHook(source="actor", target="ref", eta=ema_ref_eta)
        )
    mfcs.append(actor_train)
    interfaces["actor_train"] = actor_if

    if use_critic:
        critic_if = make_interface("ppo_critic", hp=hp, kl_ctl=actor_if.kl_ctl)
        interfaces["critic_inf"] = critic_if
        interfaces["critic_train"] = critic_if
        mfcs.append(
            MFCDef(
                name="critic_train",
                model_name="critic",
                interface_type="train_step",
                input_keys=train_inputs + ("values",),
                mb_spec=mb_spec,
            )
        )

    return build_graph(mfcs, batch_keys=batch_keys), interfaces
