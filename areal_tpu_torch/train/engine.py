"""The train / inference engine on one device (counterpart of
``areal_tpu/train/engine.py``).

``TrainEngine`` owns f32 master params and an AdamW optimizer for one
model; interfaces hand it pure loss / output functions
``(params, cfg, arrays) -> (loss, stats)`` / ``-> [rows, T]``. A sample is
split into token-budgeted micro-batches and packed into ``[rows, T]``
buffers (one row on one device); an optimizer step accumulates the
micro-batches' weighted gradients, applies optax's clip-by-global-norm and
AdamW (``torch.optim.AdamW``, which matches optax ``adamw`` algebraically),
and keeps params AND optimizer state untouched when the loss or gradient
norm is not finite, as the reference's on-device guard does.

What the reference gets from jit, donation and a mesh, the port gets from
eager PyTorch on one device: no step cache, in-place optimizer updates
(where JAX donates buffers), and one host sync per optimizer step (the
finite-ness check decides whether ``step()`` runs). ``load_hf`` /
``save_hf`` read and write HF checkpoints (the export is committed through
a staging directory and a manifest: the weight-sync leg to the generation
server). ``save_checkpoint`` / ``load_checkpoint`` write and restore the
whole training state (params, AdamW moments and counts, the step
counters, the version) through the same commit protocol, so training
resumes exactly. Multi-device training is a later slice.
"""

import dataclasses
import json
import math
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.base import recover, safetensors_io
from areal_tpu_torch.base.device import resolve_device, torch_dtype
from areal_tpu_torch.models import hf as hf_conv
from areal_tpu_torch.models import transformer as tfm
from areal_tpu_torch.models.config import ModelConfig
from areal_tpu_torch.ops import ppo as ppo_ops
from areal_tpu_torch.parallel.mesh import ParallelConfig
from areal_tpu_torch.train import batching

Arrays = Dict[str, torch.Tensor]
LossFn = Callable[[Any, ModelConfig, Arrays], Tuple[torch.Tensor, Dict]]
OutputFn = Callable[[Any, ModelConfig, Arrays], torch.Tensor]


def fetch_stats_dict(stats: Dict[str, Any]) -> Dict[str, float]:
    """Every scalar stat as a Python float, device scalars pulled in ONE
    transfer."""
    keys = [k for k, v in stats.items() if isinstance(v, torch.Tensor)]
    out = {k: v for k, v in stats.items() if k not in keys}
    if keys:
        vals = torch.stack([stats[k].detach().float().reshape(()) for k in keys])
        out.update(zip(keys, vals.cpu().tolist()))
    return {k: float(v) if np.ndim(v) == 0 else v for k, v in out.items()}


def mean_stats_dicts(all_stats: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Mean per key over a list of stats dicts, without a device pull:
    device scalars are averaged on the device, host scalars by numpy."""
    if len(all_stats) == 1:
        return dict(all_stats[0])
    out: Dict[str, Any] = {}
    for k in all_stats[0]:
        vs = [s[k] for s in all_stats]
        if any(isinstance(v, torch.Tensor) for v in vs):
            dev = next(v.device for v in vs if isinstance(v, torch.Tensor))
            out[k] = torch.stack([
                torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(())
                for v in vs
            ]).mean()
        else:
            out[k] = float(np.mean(vs))
    return out


@dataclasses.dataclass
class OptimizerConfig:
    """≈ the reference's ``OptimizerConfig``."""

    type: str = "adam"
    lr: float = 2e-5
    weight_decay: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-5
    gradient_clipping: float = 1.0
    lr_scheduler_type: str = "constant"   # constant | linear | cosine
    warmup_steps_proportion: float = 0.001
    min_lr_ratio: float = 0.0


def vmapped_forward(params, cfg: ModelConfig, arrays: Arrays,
                    with_head: bool = True) -> torch.Tensor:
    """Model forward over ``[rows, T]`` packed buffers ->
    ``[rows, T, vocab|1]`` (or ``[rows, T, E]`` hidden states). Rows are
    independent packed sequences, run one after another."""
    ids, seg, pos = (arrays["input_ids"], arrays["segment_ids"],
                     arrays["positions"])
    return torch.stack([
        tfm.forward_packed(params, cfg, ids[r], seg[r], pos[r],
                           with_head=with_head)
        for r in range(ids.shape[0])
    ])


def vmapped_next_token_logprobs(params, cfg: ModelConfig,
                                arrays: Arrays) -> torch.Tensor:
    """Token-aligned next-token logprobs ``[rows, T]`` — the shared
    primitive of the SFT loss, the PPO logprob recompute and the PPO actor
    loss. Honors ``cfg.loss_chunk_size`` (the ``[T, vocab]`` logits never
    materialize)."""
    ids, seg = arrays["input_ids"], arrays["segment_ids"]
    if cfg.loss_chunk_size:
        hidden = vmapped_forward(params, cfg, arrays, with_head=False)
        rows = [
            tfm.chunked_next_token_logprobs(
                params, cfg, hidden[r], ids[r], seg[r],
                chunk=cfg.loss_chunk_size,
            )
            for r in range(ids.shape[0])
        ]
    else:
        logits = vmapped_forward(params, cfg, arrays)
        rows = [
            ppo_ops.gather_packed_shifted_log_probs(logits[r], ids[r], seg[r])
            for r in range(ids.shape[0])
        ]
    return torch.stack(rows)


def decay_mask(params) -> Any:
    """Which leaves AdamW decays, as the reference's ``x.ndim >= 2`` sees
    its STACKED layout: every per-layer leaf carries the ``[L, ...]`` axis
    there, so all of them (norm gains and biases included) decay; of the
    top-level leaves only the 2-D ones do (``final_ln`` does not)."""
    return {
        k: (tfm.tree_map(lambda t: True, v) if k == "layers"
            else tfm.tree_map(lambda t: t.dim() >= 2, v))
        for k, v in params.items()
    }


def _leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tfm.tree_map(out.append, tree)
    return out


# recover-checkpoint files: params and each AdamW moment in a file of its
# own (a restore reads one file into host memory at a time), the per-param
# AdamW step counts in a small one
_CKPT_FILES = {"params": "params.safetensors",
               "exp_avg": "exp_avg.safetensors",
               "exp_avg_sq": "exp_avg_sq.safetensors",
               "step": "adam_step.safetensors"}


class TrainEngine:
    """Owns the f32 master params (+ optimizer state) of one model on one
    device."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        parallel: ParallelConfig = ParallelConfig(),
        optimizer: Optional[OptimizerConfig] = None,
        param_dtype: str = "float32",
        device=None,
    ):
        if parallel.world_size != 1:
            raise NotImplementedError(
                f"the port trains on one device; got {parallel}"
            )
        self.cfg = model_cfg
        self.parallel = parallel
        self.device = resolve_device(device)
        self.param_dtype = torch_dtype(param_dtype)
        self.optimizer_cfg = optimizer
        self.params = None
        self.optimizer: Optional[torch.optim.AdamW] = None
        self._lr_host: Optional[Callable[[int], float]] = None
        self.hf_family: Optional[str] = None   # set by load_hf
        self._step = 0          # optimizer steps taken (guarded ones too)
        self._n_updates = 0     # updates applied (the schedule's count)
        self.version = 0

    @property
    def n_rows(self) -> int:
        return 1

    # ------------------------------------------------------------------ #
    # Initialization
    # ------------------------------------------------------------------ #

    def _own(self, params):
        self.params = tfm.tree_map(lambda t: t.requires_grad_(True), params)
        return self

    def init_random(self, seed: int = 0):
        return self._own(tfm.init_params(self.cfg, seed=seed,
                                         device=self.device,
                                         dtype=self.param_dtype))

    def load_params(self, host_params):
        """Params from a numpy tree in the JAX package's layout."""
        return self._own(tfm.params_from_numpy(host_params, device=self.device,
                                               dtype=self.param_dtype))

    def load_hf(self, path: str, init_critic_head: bool = False):
        """Load a HF checkpoint. With ``init_critic_head``, a CausalLM's
        [E, V] lm head is dropped and a random [E, 1] value head inserted
        HOST-side (seed 0, as the reference draws it). A checkpoint that
        already carries a TRAINED value head (critic/RM exports:
        ``score.weight`` + ``is_critic``) keeps it: re-randomizing would
        silently score rollouts with noise."""
        _, host_params = hf_conv.load_hf_checkpoint(path)
        with open(os.path.join(path, "config.json")) as f:
            model_type = json.load(f)["model_type"]
        self.hf_family = hf_conv.family_for_model_type(model_type).name
        if init_critic_head:
            head = host_params.get("head", {}).get("weight")
            if head is not None and head.shape == (self.cfg.hidden_dim, 1):
                pass  # trained critic/RM checkpoint: keep its head
            else:
                host_params.pop("head", None)
                rng = np.random.default_rng(0)
                host_params["head"] = {
                    "weight": (
                        rng.standard_normal((self.cfg.hidden_dim, 1)) * 0.02
                    ).astype(np.float32)
                }
        return self.load_params(host_params)

    def save_hf(self, path: str, family: str, async_write: bool = False,
                post_write=None):
        """HF checkpoint export. The params are copied to the host before
        this returns (the next train step updates them in place); the file
        write is pure host IO. ``async_write=True`` returns a daemon
        ``threading.Thread`` doing the write + ``post_write()`` in the
        background: the weight-publish fast path. A failure inside the
        thread is stored on ``thread._areal_exc``; the joiner must check
        and re-raise so a full disk does not silently freeze the fleet's
        weight version.

        The export is COMMITTED: safetensors land in a staging dir that is
        atomically renamed over ``path`` with a manifest, so a generation
        server (or a restarted trainer re-announcing the version) can never
        observe a half-written snapshot."""
        host_params = tfm.params_to_numpy(self.params)
        abs_path = os.path.abspath(path)
        step, version = self._step, self.version

        def _write():
            staging = recover.prepare_staging(abs_path, "hf")
            hf_conv.save_hf_checkpoint(host_params, self.cfg, family, staging)
            recover.commit_checkpoint(staging, abs_path, {
                "step": step, "version": version, "format": "hf",
            })
            if post_write is not None:
                post_write()

        if async_write:
            def _guarded():
                try:
                    _write()
                except BaseException as e:  # noqa: BLE001 - surfaced by the joiner
                    t._areal_exc = e

            t = threading.Thread(
                target=_guarded, name=f"save_hf:{path}", daemon=True
            )
            t._areal_exc = None
            t.start()
            return t
        _write()
        return None

    # ------------------------------------------------------------------ #
    # Recover checkpoints (params + optimizer state, committed)
    # ------------------------------------------------------------------ #

    def _named_params(self) -> List[Tuple[str, torch.Tensor]]:
        return list(recover.tree_leaves_with_path(self.params))

    def _opt_state_tree(self, meta: bool = False) -> Dict[str, Dict[str, Any]]:
        """The AdamW state as a tree keyed like the params: ``exp_avg`` and
        ``exp_avg_sq`` of each param's shape and dtype, its ``step`` a 0-d
        f32 count. A param the optimizer has not stepped yet reads as zeros
        (on the host), which is what AdamW starts it from. ``meta`` gives
        shapes and dtypes only (for checksums), allocating nothing."""
        tree: Dict[str, Dict[str, Any]] = {"exp_avg": {}, "exp_avg_sq": {},
                                           "step": {}}
        for name, p in self._named_params():
            st = {} if meta else self.optimizer.state.get(p, {})
            for k in ("exp_avg", "exp_avg_sq"):
                tree[k][name] = st[k] if k in st else torch.zeros(
                    p.shape, dtype=p.dtype, device="meta" if meta else "cpu")
            step = st.get("step")
            tree["step"][name] = (
                torch.zeros((), dtype=torch.float32,
                            device="meta" if meta else "cpu")
                if step is None else torch.as_tensor(step, dtype=torch.float32))
        return tree

    def _ckpt_trees(self, with_optim: bool, meta: bool = False
                    ) -> Dict[str, Any]:
        trees = {"params": dict(self._named_params())}
        if with_optim and self.optimizer is not None:
            trees["opt_state"] = self._opt_state_tree(meta)
        return trees

    def save_checkpoint(self, path: str, with_optim: bool = True):
        """Atomic committed save of the whole training state: tensors are
        written into a staging dir, then a ``COMMIT.json`` manifest (step,
        update count, version, per-tree structural checksums) is fsynced
        and the staging dir renamed over ``path``. A crash at any instant
        leaves the previous committed checkpoint restorable. Tensors are
        copied to the host one at a time as they are written."""
        path = os.path.abspath(path)
        staging = recover.prepare_staging(path, f"s{self._step}")
        os.makedirs(staging)
        trees = self._ckpt_trees(with_optim)
        safetensors_io.save_file(trees["params"],
                                 os.path.join(staging, _CKPT_FILES["params"]))
        for k, tree in trees.get("opt_state", {}).items():
            safetensors_io.save_file(tree,
                                     os.path.join(staging, _CKPT_FILES[k]))
        recover.commit_checkpoint(staging, path, {
            "step": self._step,
            "n_updates": self._n_updates,
            "version": self.version,
            "format": "torch-train",
            "with_optim": "opt_state" in trees,
            "checksums": {k: recover.tree_checksum(v)
                          for k, v in trees.items()},
        })

    def validate_checkpoint(self, path: str, with_optim: bool = True) -> dict:
        """Validate WITHOUT restoring: resolve the newest committed dir at
        ``path`` (promoting a committed-but-unswapped staging sibling) and
        check the manifest's structural checksums against this engine's
        state trees. Returns the manifest. Raises ``FileNotFoundError``
        (nothing committed) or ``ValueError`` (incompatible or corrupt)."""
        path = os.path.abspath(path)
        recover.resolve_committed(path)
        manifest = recover.read_manifest(path)
        if manifest is None:
            raise FileNotFoundError(
                f"no committed checkpoint at {path} (missing or crashed "
                "before its COMMIT manifest landed)"
            )
        saved_sums = manifest.get("checksums", {})
        for k, tree in self._ckpt_trees(with_optim, meta=True).items():
            want = saved_sums.get(k)
            if want is not None and want != recover.tree_checksum(tree):
                raise ValueError(
                    f"checkpoint {path} is incompatible with this engine: "
                    f"state-tree checksum mismatch on {k!r} (model/optimizer "
                    "config drift or a corrupt save)"
                )
        return manifest

    def load_checkpoint(self, path: str, with_optim: bool = True):
        """Restore from the newest COMMITTED checkpoint at ``path``, after
        :meth:`validate_checkpoint`. Values are copied into the engine's
        own tensors, so the optimizer keeps addressing them; a step after
        the load equals the step the saved run would have taken."""
        path = os.path.abspath(path)
        manifest = self.validate_checkpoint(path, with_optim)
        named = self._named_params()
        with torch.no_grad():
            saved = safetensors_io.load_file(
                os.path.join(path, _CKPT_FILES["params"]))
            for name, p in named:
                p.copy_(saved.pop(name))
            del saved
            if with_optim and self.optimizer is not None and manifest.get(
                    "with_optim"):
                steps = safetensors_io.load_file(
                    os.path.join(path, _CKPT_FILES["step"]))
                for name, p in named:
                    st = self.optimizer.state[p]
                    if "step" in st and isinstance(st["step"], torch.Tensor):
                        st["step"].copy_(steps[name])
                    else:
                        st["step"] = steps[name].clone()
                for k in ("exp_avg", "exp_avg_sq"):
                    saved = safetensors_io.load_file(
                        os.path.join(path, _CKPT_FILES[k]))
                    for name, p in named:
                        st = self.optimizer.state[p]
                        if k in st:
                            st[k].copy_(saved.pop(name))
                        else:
                            st[k] = saved.pop(name).to(
                                device=p.device, dtype=p.dtype).clone()
                    del saved
        self._step = int(manifest["step"])
        self._n_updates = int(manifest.get("n_updates", manifest["step"]))
        self.version = int(manifest["version"])
        return self

    # ------------------------------------------------------------------ #
    # Optimizer
    # ------------------------------------------------------------------ #

    def setup_optimizer(self, total_train_steps: int):
        """AdamW with the reference's schedule (linear warmup from 0 over
        ``max(1, proportion * total)`` steps, then constant / linear /
        cosine), clip-by-global-norm and the decay mask of
        :func:`decay_mask`."""
        if self.optimizer_cfg is None:
            raise ValueError("setup_optimizer needs an OptimizerConfig")
        oc = self.optimizer_cfg
        warmup = max(1, int(oc.warmup_steps_proportion * total_train_steps))
        end = oc.lr * oc.min_lr_ratio

        def lr_host(step: int) -> float:
            if step < warmup:
                return oc.lr * step / warmup
            if oc.lr_scheduler_type == "cosine":
                total = max(total_train_steps, warmup + 1)
                frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
                return end + 0.5 * (oc.lr - end) * (1 + math.cos(math.pi * frac))
            if oc.lr_scheduler_type == "linear":
                total = max(total_train_steps - warmup, 1)
                frac = min((step - warmup) / total, 1.0)
                return oc.lr + (end - oc.lr) * frac
            return oc.lr

        self._lr_host = lr_host
        decay = _leaves(decay_mask(self.params))
        leaves = _leaves(self.params)
        groups = [
            {"params": [p for p, d in zip(leaves, decay) if d],
             "weight_decay": oc.weight_decay},
            {"params": [p for p, d in zip(leaves, decay) if not d],
             "weight_decay": 0.0},
        ]
        self.optimizer = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=0.0,
            betas=(oc.beta1, oc.beta2), eps=oc.eps,
        )
        return self

    # ------------------------------------------------------------------ #
    # Batches
    # ------------------------------------------------------------------ #

    def _make_micro_batches(
        self,
        sample: SequenceSample,
        mb_spec: MicroBatchSpec,
        capacity=None,
        weight_fn=None,
    ):
        """Split + pack the sample into micro-batches. Returns ``(mbs,
        packed, weights)``; weights (one per packed mb) are None without
        ``weight_fn``."""
        bound = self.cfg.attn_max_seqlen
        if bound is not None:
            longest = max(
                (l for lens in sample.seqlens.values() for ln in lens for l in ln),
                default=0,
            )
            if longest > bound:
                raise ValueError(
                    f"batch contains a {longest}-token sequence but "
                    f"attn_max_seqlen={bound}: the flash kernels would "
                    "silently truncate its attention span. Raise the bound or "
                    "drop over-long sequences at intake."
                )
        mbs = batching.split_into_micro_batches(
            sample, mb_spec.n_mbs, mb_spec.max_tokens_per_mb, self.n_rows
        )
        cap = capacity or mb_spec.max_tokens_per_mb
        packed = [batching.pack_sequences(mb, self.n_rows, capacity=cap)
                  for mb in mbs]
        if cap is None:
            # one capacity for every micro-batch, as the reference agrees on
            cap = max((pb.capacity for pb in packed), default=0)
            packed = [
                pb if pb.capacity == cap
                else batching.pack_sequences(mb, self.n_rows, capacity=cap)
                for mb, pb in zip(mbs, packed)
            ]
        weights = None
        if weight_fn is not None:
            weights = np.asarray([float(weight_fn(pb)) for pb in packed],
                                 np.float64)
        return mbs, packed, weights

    def _put_batch(self, pb: batching.PackedBatch) -> Arrays:
        arrays = {k: torch.from_numpy(v).to(self.device)
                  for k, v in pb.arrays.items()}
        arrays["input_ids"] = arrays["input_ids"].long()
        return arrays

    # ------------------------------------------------------------------ #
    # train / eval / forward
    # ------------------------------------------------------------------ #

    def train_batch(
        self,
        sample: SequenceSample,
        mb_spec: MicroBatchSpec,
        loss_fn: LossFn,
        loss_weight_fn: Callable[[batching.PackedBatch], float] = None,
        fetch_stats: bool = True,
    ) -> Dict[str, Any]:
        """One optimizer step over the sample. Micro-batch gradients are
        weighted by ``loss_weight_fn`` (default: action-token count)
        normalized to sum 1 — a global token-mean loss. A micro-batch of
        weight 0 contributes nothing (its loss, possibly a 0/0 nan, is
        selected out, never multiplied). A non-finite loss or gradient norm
        skips the update: params, Adam moments and step counts stay as
        they were (``guard/step_ok`` 0)."""
        if self.optimizer is None:
            raise RuntimeError("call setup_optimizer() first")
        _, packed, weights = self._make_micro_batches(
            sample, mb_spec,
            weight_fn=loss_weight_fn or batching.count_action_tokens,
        )
        weights = np.asarray(weights, np.float32)
        weights = weights / (weights.sum() or 1.0)
        self.optimizer.zero_grad(set_to_none=True)
        losses: List[torch.Tensor] = []
        stats: Dict[str, torch.Tensor] = {}
        for pb, w in zip(packed, weights):
            if w <= 0:
                continue
            loss, st = loss_fn(self.params, self.cfg, self._put_batch(pb))
            (loss * float(w)).backward()
            losses.append(loss.detach().float() * float(w))
            for k, v in st.items():
                if torch.as_tensor(v).dim() == 0:
                    v = torch.as_tensor(v, dtype=torch.float32,
                                        device=self.device).detach() * float(w)
                    stats[k] = stats[k] + v if k in stats else v
        params = _leaves(self.params)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        # optax global_norm: sqrt of the sum of squares over every leaf
        gnorm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
        )
        loss = (torch.stack(losses).sum() if losses
                else torch.zeros((), device=self.device))
        ok = bool(torch.isfinite(gnorm) & torch.isfinite(loss))
        if ok:
            clip = self.optimizer_cfg.gradient_clipping
            if gnorm > clip:
                # optax clip_by_global_norm: g / norm * max, only when over
                for g in grads:
                    g.div_(gnorm).mul_(clip)
            for p, g in zip(params, grads):
                p.grad = g
            lr = self._lr_host(self._n_updates)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.step()
            self._n_updates += 1
        self.optimizer.zero_grad(set_to_none=True)
        out: Dict[str, Any] = {
            "loss": loss, "grad_norm": gnorm,
            "guard/step_ok": float(ok), **stats,
            "lr": self._lr_host(self._step), "n_mbs": len(packed),
        }
        self._step += 1
        return fetch_stats_dict(out) if fetch_stats else out

    def eval_batch(
        self, sample: SequenceSample, mb_spec: MicroBatchSpec, loss_fn: LossFn
    ) -> Dict[str, float]:
        _, packed, weights = self._make_micro_batches(
            sample, mb_spec,
            weight_fn=lambda pb: (pb.arrays["segment_ids"] > 0).sum(),
        )
        with torch.no_grad():
            losses = torch.stack([
                loss_fn(self.params, self.cfg, self._put_batch(pb))[0].float()
                for pb in packed
            ])
        losses = losses.cpu().double().numpy()
        # all-padding mbs can yield nan means; their weight is 0
        tot = float(np.sum(np.where(weights > 0, losses * weights, 0.0)))
        return {"loss": tot / max(weights.sum(), 1)}

    def forward(
        self, sample: SequenceSample, mb_spec: MicroBatchSpec,
        output_fn: OutputFn,
    ) -> List[np.ndarray]:
        """Token-aligned inference (logprob recompute, critic values, ...)
        without autograd. Returns one array per sequence, in the sample's
        original (item, seq) order."""
        mbs, packed, _ = self._make_micro_batches(sample, mb_spec)
        by_key: Dict[Any, np.ndarray] = {}
        with torch.no_grad():
            for mb, pb in zip(mbs, packed):
                out = output_fn(self.params, self.cfg, self._put_batch(pb))
                out = out.float().cpu().numpy()
                for p, arr in zip(pb.placements, pb.unpack(out)):
                    by_key[(mb.ids[p.item_idx], p.seq_idx)] = arr
        main = sample.main_key()
        return [by_key[(item_id, j)]
                for i, item_id in enumerate(sample.ids)
                for j in range(len(sample.seqlens[main][i]))]
