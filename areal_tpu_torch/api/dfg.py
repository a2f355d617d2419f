"""The dataflow-graph layer: algorithms as declared graphs of model
function calls (a copy of ``areal_tpu/api/dfg.py``).

An algorithm is a set of *model function calls* (MFCs): named (model,
interface-method) pairs with declared input and output data keys. The
execution order comes from the key dependencies, never from trainer code,
so critic on/off, an EMA reference or RM scoring are graph edits. Every
model is an in-process engine, so a call is a function call and a data
"transfer" is key selection on the host batch. ``ParamReallocHook``
moves weights between two models around a call.
"""

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

from areal_tpu_torch.api.data import MicroBatchSpec


@dataclasses.dataclass(frozen=True)
class ParamReallocHook:
    """``target = eta * source + (1 - eta) * target`` around an MFC. With
    ``eta=1`` a copy; with ``eta<1`` the EMA-reference-model recipe."""

    source: str
    target: str
    eta: float = 1.0


RPCHook = Union[ParamReallocHook]


@dataclasses.dataclass
class MFCDef:
    """One model function call node.

    :param name: unique node id.
    :param model_name: which engine runs this call ("actor", "critic",
        "ref", ...).
    :param interface_type: "inference" | "train_step" | "generate".
    :param interface_impl: registry name for ``make_interface``, resolved
        by the executor.
    :param input_keys: batch keys this call consumes (dependency edges).
    :param output_keys: batch keys this call produces, after the remap.
    :param output_key_remap: interface-native key -> graph key.
    """

    name: str
    model_name: str
    interface_type: str
    interface_impl: str = ""
    interface_kwargs: dict = dataclasses.field(default_factory=dict)
    input_keys: Tuple[str, ...] = ()
    output_keys: Tuple[str, ...] = ()
    output_key_remap: Dict[str, str] = dataclasses.field(default_factory=dict)
    mb_spec: Optional[MicroBatchSpec] = None
    pre_hooks: List[RPCHook] = dataclasses.field(default_factory=list)
    post_hooks: List[RPCHook] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.interface_type not in ("inference", "train_step", "generate"):
            raise ValueError(
                f"{self.name}: bad interface_type {self.interface_type!r}")


@dataclasses.dataclass
class DataFlowGraph:
    """Validated graph: MFCs in level order (each level's inputs are fully
    produced by earlier levels or the source batch)."""

    mfcs: List[MFCDef]
    levels: List[List[MFCDef]]
    producers: Dict[str, str]          # data key -> producing MFC name

    @property
    def names(self) -> List[str]:
        return [m.name for m in self.mfcs]


def build_graph(
    mfcs: Sequence[MFCDef], batch_keys: Sequence[str] = ()
) -> DataFlowGraph:
    """Resolve edges from input / output keys and level-order the MFCs.
    ``batch_keys``: keys the source batch provides. Raises on duplicate
    names, duplicate producers, unsatisfiable inputs and cycles, at build
    time rather than mid-training."""
    names = [m.name for m in mfcs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate MFC names: {names}")
    producers: Dict[str, str] = {}
    for m in mfcs:
        for k in m.output_keys:
            if k in producers:
                raise ValueError(
                    f"key {k!r} produced by both {producers[k]!r} and {m.name!r}"
                )
            producers[k] = m.name
    base: Set[str] = set(batch_keys)
    for m in mfcs:
        for k in m.input_keys:
            if k not in base and k not in producers:
                raise ValueError(
                    f"MFC {m.name!r} needs key {k!r}: not in the source batch "
                    f"({sorted(base)}) and produced by no MFC"
                )

    # Kahn levels over name dependencies
    deps: Dict[str, Set[str]] = {
        m.name: {
            producers[k]
            for k in m.input_keys
            if k in producers and producers[k] != m.name
        }
        for m in mfcs
    }
    by_name = {m.name: m for m in mfcs}
    done: Set[str] = set()
    levels: List[List[MFCDef]] = []
    remaining = set(names)
    while remaining:
        ready = sorted(n for n in remaining if deps[n] <= done)
        if not ready:
            raise ValueError(f"dependency cycle among MFCs: {sorted(remaining)}")
        levels.append([by_name[n] for n in ready])
        done |= set(ready)
        remaining -= set(ready)
    return DataFlowGraph(mfcs=list(mfcs), levels=levels, producers=producers)
