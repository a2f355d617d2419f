"""Level-ordered executor for declared MFC graphs (the counterpart of
``areal_tpu/system/function_executor.py``). Every model is an
in-process engine on one device, so an MFC is a direct call and a data
"transfer" is key selection on the host batch; level order is kept, and
calls of one level run one after another (they share the card).

``ParamReallocHook`` becomes an in-place ``dst <- (1 - eta) * dst + eta *
src`` over the two engines' param trees, computed in f32 and cast to the
target's dtype (the EMA-reference recipe).
"""

import logging
from typing import Dict, Optional

import torch

from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.dfg import DataFlowGraph, MFCDef, ParamReallocHook
from areal_tpu_torch.api.model import ModelInterface, make_interface
from areal_tpu_torch.base import flops as flops_mod
from areal_tpu_torch.base import tracing
from areal_tpu_torch.models import transformer as tfm

logger = logging.getLogger("areal_tpu_torch.function_executor")


def _param_realloc(dst_params, src_params, eta: float):
    """dst = eta * src + (1 - eta) * dst, leaf by leaf, in place."""
    with torch.no_grad():
        tfm.tree_map(
            lambda d, s: d.copy_(
                ((1.0 - eta) * d.float() + eta * s.float()).to(d.dtype)),
            dst_params, src_params,
        )
    return dst_params


class FunctionExecutor:
    """Runs one batch through a :class:`DataFlowGraph`.

    :param engines: model name -> TrainEngine (as ``MFCDef.model_name``
        references it).
    :param interfaces: MFC name -> interface instance. MFCs absent from
        the mapping are built from their ``interface_impl`` /
        ``interface_kwargs``; passing instances lets recipes share state
        across MFCs (one KL controller between actor and critic).
    """

    def __init__(
        self,
        graph: DataFlowGraph,
        engines: Dict[str, object],
        interfaces: Optional[Dict[str, ModelInterface]] = None,
        default_mb_spec: Optional[MicroBatchSpec] = None,
    ):
        self.graph = graph
        self.engines = engines
        self.default_mb_spec = default_mb_spec or MicroBatchSpec()
        self.interfaces: Dict[str, ModelInterface] = dict(interfaces or {})
        for mfc in graph.mfcs:
            if mfc.model_name not in engines:
                raise ValueError(
                    f"MFC {mfc.name!r} wants engine {mfc.model_name!r}; "
                    f"have {sorted(engines)}"
                )
            if mfc.name not in self.interfaces:
                if not mfc.interface_impl:
                    raise ValueError(
                        f"MFC {mfc.name!r}: no interface instance passed and "
                        "no interface_impl to build one from"
                    )
                self.interfaces[mfc.name] = make_interface(
                    mfc.interface_impl, **mfc.interface_kwargs
                )

    def _apply_hook(self, hook, mfc: MFCDef):
        if isinstance(hook, ParamReallocHook):
            src = self.engines[hook.source]
            dst = self.engines[hook.target]
            _param_realloc(dst.params, src.params, hook.eta)
        else:
            raise ValueError(f"MFC {mfc.name!r}: unknown hook {hook!r}")

    def run(self, sample: SequenceSample) -> Dict[str, float]:
        """Execute every MFC in level order against ``sample`` (updated in
        place with the produced keys). Returns the merged train stats plus
        the step's analytic FLOP total (``flops``)."""
        stats: Dict[str, float] = {}
        main = sample.main_key()
        seqlens = [int(n) for inner in sample.seqlens[main] for n in inner]
        n_tokens = sum(seqlens)
        total_flops = 0.0
        for level in self.graph.levels:
            for mfc in level:
                engine = self.engines[mfc.model_name]
                iface = self.interfaces[mfc.name]
                mb_spec = mfc.mb_spec or self.default_mb_spec
                for h in mfc.pre_hooks:
                    self._apply_hook(h, mfc)
                sub = sample.select(mfc.input_keys) if mfc.input_keys else sample
                if mfc.interface_type == "train_step":
                    # a named region of the MFC in a profiler trace
                    with tracing.annotate(f"mfc:{mfc.name}"):
                        out = iface.train_step(engine, sub, mb_spec)
                    stats.update(out)
                    total_flops += flops_mod.train_flops(
                        engine.cfg, n_tokens, seqlens
                    )
                else:  # inference | generate
                    fn = getattr(iface, mfc.interface_type)
                    with tracing.annotate(f"mfc:{mfc.name}"):
                        out = fn(engine, sub, mb_spec)
                    if out is not None:
                        out.remap_keys_(mfc.output_key_remap)
                        missing = set(mfc.output_keys) - set(out.keys)
                        if missing:
                            raise ValueError(
                                f"MFC {mfc.name!r} declared outputs {missing} "
                                f"it did not produce (got {sorted(out.keys)})"
                            )
                        sample.update_(out.select(mfc.output_keys)
                                       if mfc.output_keys else out)
                    total_flops += flops_mod.forward_flops(
                        engine.cfg, n_tokens, seqlens
                    )
                for h in mfc.post_hooks:
                    self._apply_hook(h, mfc)
        stats["flops"] = total_flops
        return stats
