"""Whole-batch generation on the trainer's own params for sync PPO
(counterpart of ``areal_tpu/train/generation.py``).

The weights that this step updates produce its rollouts, with no weight
publish in between: prefill, then a fixed ``max_new - 1`` decode steps
over a dense KV cache (``models/transformer.py::KVCache``), sampling each
step on the device (``gen/sampling.py``), and ONE fetch of the outputs at
the end. No step looks at the host, so no step waits for it.

Programs: the reference jits one program per key ``(B, Sp, S, max_new,
n_stop)`` and allocates its cache per call. The port keeps the state of
the current key only: the cast weights' buffers are shared, and the key
owns its cache, row state and outputs until a call with another key
drops them (so memory is the largest key's, as the reference's is). On
the card one decode step plus the sampler (``_step``) is captured as a
``torch.cuda.CUDAGraph`` at the key's first use, right after that use's
first decode step ran eagerly on the capture stream (its warm-up, which
loads cuBLAS's handle and workspace there), and every later step of every
call with that key replays it; the graph registers the generator, so a
replay draws from the generator's state of the moment. A key that comes
back after another is built and captured anew. On the CPU the same body
runs eagerly. ``stats`` counts decode steps, captures and replays, so
that ``graph_replays + graph_captures == decode_steps`` on the card.

Each ``generate`` call casts the engine's f32 masters into static
``cfg.dtype`` buffers once (the reference casts inside every layer of
every step) and seeds the generator with its ``seed``. Prefill runs
eagerly: on the card its attention is the flash kernel, one launch per
layer.
"""

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from areal_tpu_torch.api.model import GenerationHyperparameters
from areal_tpu_torch.base.device import torch_dtype
from areal_tpu_torch.gen.engine import _Clock, capture_graph
from areal_tpu_torch.gen.sampling import SamplingParams, sample_tokens
from areal_tpu_torch.models import transformer as tfm
from areal_tpu_torch.ops import moe as moe_ops


def _next_pow2(n: int, lo: int = 64) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


def pad_batch(expanded: Sequence[Sequence[int]], n_rows: int):
    """One call's rows as the reference lays them out: the row count padded
    to a multiple of ``n_rows``, prompts right-padded to ``Sp =
    _next_pow2(longest, lo=64)``, a padding row prefilling one dummy token
    with ``active0`` false. Returns ``(input_ids [B, Sp] i64, plens [B]
    i32, active0 [B] bool)`` as numpy arrays."""
    B = -(-len(expanded) // n_rows) * n_rows
    Sp = _next_pow2(max(len(p) for p in expanded))
    input_ids = np.zeros((B, Sp), np.int64)
    plens = np.ones((B,), np.int32)
    active0 = np.zeros((B,), bool)
    for i, p in enumerate(expanded):
        input_ids[i, : len(p)] = p
        plens[i] = len(p)
        active0[i] = True
    return input_ids, plens, active0


@dataclasses.dataclass
class SyncGenOutput:
    """One sequence: prompt + generation, token-aligned logprobs."""

    tokens: np.ndarray        # [plen + n_gen] int64
    gen_logprobs: np.ndarray  # [n_gen] f32 (logprob of each generated token)
    no_eos: bool              # truncated (hit max_new_tokens / capacity)


@dataclasses.dataclass
class _KeyState:
    """The buffers one key's program reads and writes, owned while the
    key is current."""

    key: Tuple[int, int, int, int, int]
    cache: tfm.KVCache
    input_ids: torch.Tensor   # [B, Sp] i64
    plens: torch.Tensor       # [B] i32
    active0: torch.Tensor     # [B] bool
    sp: SamplingParams        # [B] each
    min_gen: torch.Tensor     # [] i32
    stop_ids: torch.Tensor    # [n_stop] i64
    last: torch.Tensor        # [B] i64
    active: torch.Tensor      # [B] bool
    stopped: torch.Tensor     # [B] bool
    n_gen: torch.Tensor       # [B] i32
    out_t: torch.Tensor       # [B, max_new] i64
    out_lp: torch.Tensor      # [B, max_new] f32
    graph: Optional["torch.cuda.CUDAGraph"] = None


class SyncGenerator:
    """Whole-batch generation on a TrainEngine's params and device."""

    def __init__(self, engine):
        moe_ops.check_graphable(engine.cfg, "SyncGenerator")
        self.engine = engine
        self.device = engine.device
        self._state: Optional[_KeyState] = None   # the current key's
        self._n_built = 0
        self._params = None        # the cast weights' static buffers
        self._gen = torch.Generator(device=self.device)
        self._clock = _Clock(self.device)
        self._capture_stream = None
        self.stats = {
            "decode_steps": 0,       # every decode step run, warm-ups included
            "graph_captures": 0,     # one per key built, after its eager
                                     # first step
            "graph_replays": 0,
            "graph_capture_s": 0.0,  # host wall time of warm-ups + captures
            "graph_pool_bytes": 0,   # memory the captures reserved
        }
        # the last call's device time (CUDA events on the card, the host
        # clock on the CPU): prefill with the first sample, then decode
        self.last_call: Dict[str, float] = {}

    def n_compiles(self) -> int:
        """Programs built so far, one per ``(B, Sp, S, max_new, n_stop)``
        (a CUDA graph each on the card) and one more each time a dropped
        key comes back."""
        return self._n_built

    # ------------------------------------------------------------------ #

    def _cast_params(self):
        """The engine's params in ``cfg.dtype``, copied into this
        generator's static buffers (allocated at the first call)."""
        src = self.engine.params
        if self._params is None:
            dt = torch_dtype(self.engine.cfg.dtype)
            self._params = tfm.tree_map(
                lambda t: torch.empty(t.shape, dtype=dt, device=self.device),
                src)
        with torch.no_grad():
            tfm.tree_map(lambda dst, s: dst.copy_(s), self._params, src)
        return self._params

    def _key_state(self, key) -> _KeyState:
        """The state of ``key``: the current one, or a new one built after
        the previous key's cache, rows and graph were released."""
        st = self._state
        if st is not None and st.key == key:
            return st
        self._state = st = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        B, Sp, S, max_new, n_stop = key
        dev = self.device

        def zeros(*shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self._state = st = _KeyState(
            key=key,
            cache=tfm.KVCache.empty(self.engine.cfg, B, S, device=dev),
            input_ids=zeros(B, Sp, dtype=torch.int64),
            plens=zeros(B, dtype=torch.int32),
            active0=zeros(B, dtype=torch.bool),
            sp=SamplingParams.filled(B, device=dev),
            min_gen=zeros(dtype=torch.int32),
            stop_ids=zeros(n_stop, dtype=torch.int64),
            last=zeros(B, dtype=torch.int64),
            active=zeros(B, dtype=torch.bool),
            stopped=zeros(B, dtype=torch.bool),
            n_gen=zeros(B, dtype=torch.int32),
            out_t=zeros(B, max_new, dtype=torch.int64),
            out_lp=zeros(B, max_new, dtype=torch.float32),
        )
        self._n_built += 1
        return st

    def _sample_and_record(self, st: _KeyState, logits: torch.Tensor):
        """Sample one token per row and record it where the row is active;
        stop rows on a stop id (past ``min_gen``), at ``max_new`` or at the
        cache's capacity. Inactive rows keep their last token. In place."""
        B, max_new = st.out_t.shape
        S = st.cache.k.shape[2]
        tok, lp = sample_tokens(self._gen, logits, st.sp)
        act = st.active
        tok = torch.where(act, tok, st.last)
        rows = torch.arange(B, device=tok.device)
        idx = st.n_gen.clamp(0, max_new - 1).long()
        st.out_t[rows, idx] = torch.where(act, tok, st.out_t[rows, idx])
        st.out_lp[rows, idx] = torch.where(act, lp, st.out_lp[rows, idx])
        n_gen = st.n_gen + act.to(torch.int32)
        hit_stop = act & (tok[:, None] == st.stop_ids[None, :]).any(1) & (
            n_gen >= st.min_gen)
        st.stopped.logical_or_(hit_stop)
        st.active.copy_(act & ~hit_stop & (n_gen < max_new)
                        & (st.cache.lens < S))
        st.n_gen.copy_(n_gen)
        st.last.copy_(tok)

    def _step(self, st: _KeyState):
        """One decode step and its sample over ``st``, in place: the body
        of the key's CUDA graph."""
        logits, cache = tfm.decode_step(self._params, self.engine.cfg,
                                        st.cache, st.last, active=st.active)
        st.cache.lens.copy_(cache.lens)
        self._sample_and_record(st, logits)

    def _capture(self, st: _KeyState):
        """The key's first decode step, eagerly on the capture stream, then
        ``_step`` captured as a CUDA graph (the capture runs nothing) in a
        pool of its own, released with the key."""
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        step = functools.partial(self._step, st)
        st.graph, pool_bytes, seconds = capture_graph(
            step, step, stream=self._capture_stream, generator=self._gen)
        self.stats["graph_pool_bytes"] += pool_bytes
        self.stats["graph_captures"] += 1
        self.stats["graph_capture_s"] += seconds

    def _decode(self, st: _KeyState):
        if self.device.type != "cuda":
            self._step(st)
        elif st.graph is None:
            self._capture(st)
        else:
            st.graph.replay()
            self.stats["graph_replays"] += 1
        self.stats["decode_steps"] += 1

    # ------------------------------------------------------------------ #

    def generate(  # arealint: hot (sync-PPO whole-batch generation)
        self,
        prompts: Sequence[Sequence[int]],
        ghp: GenerationHyperparameters,
        seed: int = 0,
    ) -> List[List[SyncGenOutput]]:
        """Generate ``ghp.n`` samples per prompt. Returns one group (list of
        :class:`SyncGenOutput`) per input prompt, in order."""
        eng = self.engine
        n_prompts = len(prompts)
        expanded: List[Sequence[int]] = [p for p in prompts for _ in range(ghp.n)]
        input_ids, plens, active0 = pad_batch(expanded, eng.n_rows)
        B, Sp = input_ids.shape
        max_new = ghp.max_new_tokens
        S = -(-(Sp + max_new) // 128) * 128
        stop = list(ghp.stop_token_ids) or [-1]
        st = self._key_state((B, Sp, S, max_new, len(stop)))
        params = self._cast_params()
        st.input_ids.copy_(torch.from_numpy(input_ids))
        st.plens.copy_(torch.from_numpy(plens))
        st.active0.copy_(torch.from_numpy(active0))
        st.sp.temperature.fill_(0.0 if ghp.greedy else ghp.temperature)
        st.sp.top_p.fill_(ghp.top_p)
        st.sp.top_k.fill_(min(ghp.top_k, 1 << 30))
        st.min_gen.fill_(ghp.min_new_tokens)
        st.stop_ids.copy_(torch.tensor(stop, dtype=torch.int64))
        self._gen.manual_seed(seed)
        with torch.no_grad():
            t0 = self._clock.mark()
            st.cache.k.zero_()
            st.cache.v.zero_()
            logits, cache = tfm.prefill(params, eng.cfg, st.cache,
                                        st.input_ids, st.plens)
            st.cache.lens.copy_(cache.lens)
            for t in (st.last, st.stopped, st.n_gen, st.out_t, st.out_lp):
                t.zero_()
            st.active.copy_(st.active0)
            self._sample_and_record(st, logits)
            t1 = self._clock.mark()
            for _ in range(max_new - 1):
                self._decode(st)
            t2 = self._clock.mark()
            # the single whole-batch fetch after the decode loop: sync
            # generation's one designed sync point
            out_t, out_lp, n_gen, stopped = (
                t.to("cpu", non_blocking=True)
                for t in (st.out_t, st.out_lp, st.n_gen, st.stopped))
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        self.last_call = {"prefill_s": self._clock.seconds(t0, t1),
                          "decode_s": self._clock.seconds(t1, t2)}
        out_t, out_lp, n_gen = out_t.numpy(), out_lp.numpy(), n_gen.numpy()
        truncated = ~stopped.numpy()    # never hit EOS => truncated
        groups: List[List[SyncGenOutput]] = []
        for i in range(n_prompts):
            group = []
            for j in range(ghp.n):
                k = i * ghp.n + j
                g = int(n_gen[k])
                group.append(
                    SyncGenOutput(
                        tokens=np.concatenate(
                            [np.asarray(expanded[k], np.int64), out_t[k, :g]]
                        ),
                        gen_logprobs=out_lp[k, :g].astype(np.float32),
                        no_eos=bool(truncated[k]),
                    )
                )
            groups.append(group)
        return groups
