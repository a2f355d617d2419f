"""Slot-based continuous-batching generation engine over a paged KV pool
(counterpart of ``areal_tpu/gen/engine.py``).

- KV memory is a POOL of fixed-size pages (``models/transformer.
  PagedKVCache`` + ``gen/pages.py``); each slot holds a page table, and
  prompts share pages for their longest common page-aligned prefix (radix
  tree; one prefill serves a whole GRPO group; ``enable_prefix_cache``).
  The pool can store int8 (``kv_dtype`` / ``cfg.kv_dtype`` /
  ``AREAL_KV_DTYPE``).
- Admission = CHUNKED PREFILL: prompts stream through ``[n_rows,
  admit_chunk]`` extend programs in admit-row buckets (``admit_buckets``,
  ``admit_chunk_tokens``), in two waves (cold prompts first, then prefix
  borrowers, whose shared pages the first wave wrote); then the admitted
  slots' decode state is written by commit programs, one per admit-row
  bucket.
- Decode: a chunk of N steps; stop-token detection and per-slot caps run
  on the device, so the host syncs once per chunk. Each step's attention
  is the paged decode kernel on a GPU.
- Speculative decoding (``spec_decode`` / ``AREAL_SPEC_DECODE``, togglable
  between chunks through ``spec``): each step of a spec chunk drafts K
  tokens per slot (the n-gram self-drafter over ``ctx_tokens``, or a
  small draft model with its own paged pool, ``gen/drafter.py``), scores
  the K+1 positions in one verify pass and accepts a prefix by rejection
  sampling, so a slot advances 1..K+1 tokens a step, exactly
  distribution-preserving. Both chunk kinds keep ``ctx_tokens``,
  ``fallback_token`` and the draft pool current, so spec and vanilla
  chunks interleave freely on one state.
- Programs (the counterparts of the reference's jitted programs): one
  extend program per ``(n_rows, width, skip_pool)`` key, one commit
  program per admit-row bucket, one decode chunk per ``(n_steps, width,
  warp_bucket, fused, with_topk)`` key and one spec chunk per ``(n_steps,
  width, warp_bucket, spec_k, fused)`` key (``_jit_extend``,
  ``_jit_commit``, ``_jit_chunk``, ``_jit_spec``). On a GPU each key's
  body is captured once as a ``torch.cuda.CUDAGraph`` and every later use
  replays it; on the CPU the same body runs eagerly. Either way a program reads and
  writes only static buffers: the pool and the decode state are updated
  in place; a wave's tokens, table rows and positions, a commit's slot
  rows and a chunk's page table and warp rows are copied from pinned
  host staging into fixed device buffers before each run (``_stage``);
  the harvest flags land in a fixed ``[4, B]`` buffer whose copy to the
  host is enqueued right behind the chunk (``_dispatch``) and waited for
  later (``_resolve``).
- Pipelining (``pipeline_chunks`` / ``AREAL_DECODE_PIPELINE``): harvest
  each chunk one step late, after the next one is dispatched, so the
  host's harvest overlaps the device's decode (``_step_pipelined``).
- Interruption: the host stops issuing chunks and harvests partial
  outputs; clients re-submit with the accumulated tokens. A harvested
  slot's full pages (prompt and output) stay in the prefix cache, so
  such a resubmission (or the next chunk of a chunked rollout) borrows
  them instead of prefilling them again (the reference caches prompt
  pages only).
- Weight update: the new weights are copied into the engine's tensors
  between chunks (captured programs keep reading the same addresses); the
  prefix cache is invalidated (KV from old weights must not seed new
  generations).

- Sampling: the plain epilogue materializes ``[B, V]`` logits and samples
  over them (``gen/sampling.py``); with ``fused_sample`` (argument, or
  ``AREAL_FUSED_SAMPLE``) the decode step hands over final-norm hidden
  states and ``ops/fused_sample.py`` streams the head (the fused-sample
  kernel on a GPU). Top-p slots and top-k slots past the online buffer
  keep the sorted sampler over their own logits rows only.

Left out of this port so far (off by default in the reference): the
tensor-parallel mesh.

Thread-safety: ``submit`` arrives on the server's handler threads while
``step`` runs on the server's engine thread. ``_lock`` guards device
state, slots and pool; ``_pending_lock`` guards only the intake queue.
"""

import dataclasses
import functools
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from areal_tpu_torch.base import constants, tracing
from areal_tpu_torch.base import metrics as metrics_mod
from areal_tpu_torch.base.device import resolve_device, torch_dtype
from areal_tpu_torch.gen.drafter import (
    Drafter,
    NGramDrafter,
    TransformerDrafter,
)
from areal_tpu_torch.gen.pages import OutOfPagesError, PagePool, PrefixRegistry
from areal_tpu_torch.gen.sampling import (
    SamplingParams,
    sample_tokens,
    spec_rejection_sample,
)
from areal_tpu_torch.models import transformer as tfm
from areal_tpu_torch.models.config import ModelConfig
from areal_tpu_torch.ops import fused_sample as fused_ops
from areal_tpu_torch.ops import moe as moe_ops
from areal_tpu_torch.ops.cuda import fused_sample as cuda_fused
from areal_tpu_torch.ops.cuda import paged_attention as cuda_paged

logger = logging.getLogger("areal_tpu_torch.gen.engine")

# the kernel wrappers a decode chunk launches through: a captured chunk
# credits each one the launches its capture recorded, on every replay
_KERNEL_MODULES = (cuda_paged, cuda_fused)


@dataclasses.dataclass
class GenState:
    cache: tfm.PagedKVCache
    lens: torch.Tensor          # [B] i32 resident tokens per slot
    last_tokens: torch.Tensor   # [B] i64 token to feed next decode
    active: torch.Tensor        # [B] bool
    n_gen: torch.Tensor         # [B] i32
    min_gen: torch.Tensor       # [B] i32 suppress stop below this count
    max_gen: torch.Tensor       # [B] i32
    stop_ids: torch.Tensor      # [B, K] i64 per-slot stop tokens (-1 = unused)
    out_tokens: torch.Tensor    # [B, G] i64
    out_logprobs: torch.Tensor  # [B, G] f32
    # token-id mirror of the resident context for the self-drafter:
    # ctx_tokens[b, i] is the token whose KV sits at pool position i, and
    # ctx_tokens[b, lens[b]] = last_tokens[b] (pending, KV not written);
    # kept by both decode paths, so spec and vanilla chunks interleave
    ctx_tokens: torch.Tensor    # [B, S] i64
    # the drafter's fallback when the n-gram lookup misses: the target's
    # argmax at the previous spec step's emission boundary
    fallback_token: torch.Tensor  # [B] i64
    sp: SamplingParams
    # every per-slot tensor above is the first B rows of one of these,
    # which have a trash row B past the slots: the commit programs write
    # through them, their padding rows to row B, and so do the chunks'
    # scatters their dropped writes (the counterpart of the reference's
    # out-of-range ``mode="drop"`` index)
    padded: Dict[str, torch.Tensor]
    # the draft MODEL's own paged pool (None without a TransformerDrafter):
    # addressed by the target's page tables and lens, so draft pages
    # allocate and free in lockstep; both decode paths keep it current
    draft_cache: Optional[tfm.PagedKVCache] = None


@dataclasses.dataclass
class GenRequest:
    rid: str
    input_ids: List[int]
    max_new_tokens: int = 256
    min_new_tokens: int = 0
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 1 << 30
    greedy: bool = False
    stop_token_ids: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class GenOutput:
    rid: str
    output_ids: List[int]
    output_logprobs: List[float]
    finish_reason: str            # "stop" | "length" | "interrupted"
    version: int = 0


# The commit programs' operand row: slot, last token, resident length,
# temperature and top-p (their float32 bits), top-k, min and max new
# tokens, then the stop ids, then the prompt's ids (S columns, zero-padded)
_COMMIT_COLS = 8
# pinned staging buffers per engine: a buffer is rewritten only after the
# copy out of it, enqueued that many stagings earlier, has run
_STAGING_RING = 8
# Vocab block of the streamed top-k epilogue (plain PyTorch on the engine's
# device): every block costs a few dozen small launches, so blocks are wide;
# the block's f32 copy of the head ([E, block]) bounds the width.
FUSED_TOPK_BLOCK = 16384


def _finish_reason(n_gen, max_gen) -> str:
    return "length" if n_gen >= max_gen else "stop"


def _resolve_kv_dtype(kv_dtype: Optional[str], serving_dtype: str) -> str:
    """None/"bf16"/"bfloat16"/the serving dtype -> the serving dtype (raw
    pages); "int8" -> quantized pool; anything else raises."""
    if kv_dtype is None:
        return serving_dtype
    v = kv_dtype.strip().lower()
    if v == "int8":
        return "int8"
    if v in ("bf16", "bfloat16", serving_dtype):
        return serving_dtype
    raise ValueError(
        f"unsupported kv_dtype {kv_dtype!r}: expected 'int8', 'bf16', or "
        f"the serving dtype ({serving_dtype!r})"
    )


@dataclasses.dataclass
class _SlotInfo:
    rid: str
    pages: List[int]          # owned pages (refcount held by this slot)
    borrowed: List[int]       # shared prefix pages (one ref held)
    n_updates: int            # weight updates before its admission


class _Clock:
    """Marks on the device timeline (CUDA events) or the host clock (CPU);
    read only after a sync, so timing adds none."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def seconds(self, a, b) -> float:
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a


def capture_graph(body: Callable[[], None], warm_up: Callable[[], None], *,
                  stream: "torch.cuda.Stream", pool=None,
                  generator: Optional[torch.Generator] = None):
    """``(graph, pool bytes, seconds)``: ``warm_up()`` once, eagerly, on
    ``stream`` (it loads cuBLAS's handle and workspace for this thread and
    stream and the kernels' libraries and modules), then ``body`` captured
    as a CUDA graph on ``stream`` into ``pool``. ``generator``, where
    given, is registered, so that each replay draws from its state of the
    moment and advances it. Pool bytes are what the capture reserved;
    seconds the host wall time of warm-up and capture. A capture that
    fails raises."""
    dev = stream.device
    t0 = time.perf_counter()
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        warm_up()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    # thread_local: the server's handler threads may allocate (a weight
    # load) while the engine thread captures
    with torch.cuda.graph(graph, pool=pool, stream=stream,
                          capture_error_mode="thread_local"):
        body()
    return (graph, torch.cuda.memory_reserved(dev) - reserved,
            time.perf_counter() - t0)


@dataclasses.dataclass
class _Program:
    """One key's program (an extend, a commit or a decode chunk): ``run``
    replays its CUDA graph (or runs the eager body on the CPU);
    ``launches`` holds the kernel launches one run makes, per wrapper
    module, as its capture recorded them."""

    run: Callable[[], None]
    graph: Optional["torch.cuda.CUDAGraph"] = None
    launches: Dict[object, int] = dataclasses.field(default_factory=dict)
    # a spec chunk's static [3, n_steps, B] f32 output: drafted and
    # accepted counts and the mean accept probability per (step, slot)
    aux: Optional[torch.Tensor] = None


@dataclasses.dataclass
class _ChunkIO:
    """Host side of one chunk in flight: the staging copies of its page
    table and warp rows, the buffer its harvest flags are copied into, and
    the event that marks that copy done (pinned memory and an event on a
    GPU; plain tensors and no event on the CPU, where copies are
    synchronous). A chunk holds its ``_ChunkIO`` until it is resolved; at
    most one chunk is in flight past the one being dispatched, so two
    alternate."""

    table: torch.Tensor          # [B, M] i32
    warp: torch.Tensor           # [B] i64
    flags: torch.Tensor          # [4, B] i32: active, n_gen, max_gen, lens
    done: Optional["torch.cuda.Event"] = None
    aux: Optional[torch.Tensor] = None   # a spec chunk's aux, on the host


@dataclasses.dataclass
class _Staging:
    """A pinned host buffer that admission operands pass through on their
    way to a static device buffer, and the event that marks the copy out
    of it done (plain memory and no event on the CPU, where copies are
    synchronous)."""

    buf: torch.Tensor            # [n] i64
    done: Optional["torch.cuda.Event"] = None


@dataclasses.dataclass
class _InFlight:
    """A dispatched chunk: its host buffers, its device-time marks, the
    admission's spans of marks before it (empty if it admitted nothing;
    first captures fall between spans) and the (slot, epoch) pairs it
    decoded."""

    io: _ChunkIO
    decode: tuple
    prefill: List[tuple]
    running: Tuple[Tuple[int, int], ...]
    spec: bool = False      # a spec chunk (its aux rides in io.aux)
    advance: int = 0        # tokens the chunk can advance a slot


class GenerationEngine:
    # Adaptive spec-K (AREAL_SPEC_K_ADAPT): retune after WINDOW accept-length
    # observations; step K up when the windowed mean accept length clears
    # UP * K, down when it falls under DOWN * K (the gap is the hysteresis
    # band that keeps K from oscillating at a boundary).
    SPEC_K_ADAPT_WINDOW = 128
    SPEC_K_ADAPT_UP = 0.75
    SPEC_K_ADAPT_DOWN = 0.25

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        max_slots: int = 8,
        max_seqlen: int = 2048,
        max_new_tokens_cap: int = 1024,
        stop_token_ids: Sequence[int] = (),
        seed: int = 0,
        page_size: int = 128,
        n_pages: Optional[int] = None,
        kv_dtype: Optional[str] = None,
        fused_sample: Optional[bool] = None,
        pipeline_chunks: Optional[bool] = None,
        admit_buckets: Sequence[int] = (1, 2, 4, 8),
        enable_prefix_cache: bool = True,
        admit_chunk_tokens: Optional[int] = None,
        spec_decode: Optional[bool] = None,
        spec_k: Optional[int] = None,
        drafter: Optional[Drafter] = None,
        spec_k_adapt: Optional[bool] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self._init_drafter(cfg, spec_decode, drafter)
        # every program (extend, commit, decode and spec chunks) is a CUDA
        # graph on the card and the same body on the CPU
        moe_ops.check_graphable(cfg, "GenerationEngine")
        if self.draft_cfg is not None:
            moe_ops.check_graphable(self.draft_cfg, "GenerationEngine's "
                                    "draft model")
        # fused sampling epilogue: explicit argument > AREAL_FUSED_SAMPLE
        self.fused = (
            fused_sample
            if fused_sample is not None
            else constants.fused_sample_enabled()
        )
        # chunk pipelining: explicit argument > AREAL_DECODE_PIPELINE
        self.pipeline = (
            pipeline_chunks
            if pipeline_chunks is not None
            else constants.decode_pipeline_enabled()
        )
        # explicit argument > cfg.kv_dtype > AREAL_KV_DTYPE > serving dtype
        kd = kv_dtype if kv_dtype is not None else (
            cfg.kv_dtype if cfg.kv_dtype is not None else constants.kv_dtype()
        )
        self.kv_dtype = _resolve_kv_dtype(kd, cfg.dtype)
        self.kv_quantized = self.kv_dtype == "int8"
        # the engine's own tensors: update_params copies into them, so
        # none may alias the caller's
        self.params = self._own(self.prepare_params(params), params)
        self.draft_params = (
            self._own(self.prepare_draft_params(self._draft.params),
                      self._draft.params)
            if self._draft is not None else None
        )
        self.B = max_slots
        self.page = page_size
        self.M = -(-max_seqlen // page_size)      # table width (pages/slot)
        self.S = self.M * page_size
        self.G = max_new_tokens_cap         # output buffer width per slot
        self.version = 0
        # prefill streams through [n_rows, admit_chunk] extend programs;
        # bigger chunks amortize the attention over resident KV at the
        # cost of padding short prompts up to one chunk. Default: one page
        if admit_chunk_tokens is None:
            self.admit_chunk = page_size
        else:
            self.admit_chunk = max(
                page_size, -(-admit_chunk_tokens // page_size) * page_size
            )
        self.admit_buckets = sorted(admit_buckets)
        self.enable_prefix_cache = enable_prefix_cache
        # engine-wide stop ids, merged ahead of each request's own
        self.global_stop_ids = list(stop_token_ids)
        self.max_stop_ids = 8
        # dense-equivalent pool sized at the SERVING-dtype byte budget by
        # default: an int8 pool buys itemsize-ratio x the pages for the same
        # bytes. Pass n_pages to cap bytes.
        itemsize = torch_dtype(cfg.dtype).itemsize
        bytes_ratio = itemsize if self.kv_quantized else 1
        self.n_pages = (
            n_pages if n_pages is not None else self.B * self.M * bytes_ratio
        )
        self.pool = PagePool(self.n_pages, page_size)
        self.prefix = PrefixRegistry(self.pool)
        self._n_updates = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.state = self._make_state(
            tfm.PagedKVCache.empty(
                self.cfg, self.n_pages, self.page,
                kv_dtype="int8" if self.kv_quantized else None,
                device=self.device,
            ),
            self.G,
            # the draft pool mirrors the target pool's page count, so one
            # page index addresses both (lockstep alloc and free)
            draft_cache=(
                tfm.PagedKVCache.empty(
                    self.draft_cfg, self.n_pages, self.page,
                    kv_dtype="int8" if self.draft_kv_quantized else None,
                    device=self.device,
                ) if self._draft is not None else None
            ),
        )
        # speculative decoding: draft-and-verify chunks, togglable between
        # chunks (``spec`` is read once per step under the engine lock)
        self.spec = self._spec_on
        self.spec_k = max(
            1, spec_k if spec_k is not None else constants.spec_k()
        )
        # adaptive spec-K: K moves within a small fixed choice set, so the
        # spec programs stay bounded (one per chunk key and K)
        self.spec_k_adapt = (
            spec_k_adapt
            if spec_k_adapt is not None
            else constants.spec_k_adapt_enabled()
        )
        self._spec_k_choices = sorted({1, 2, 4, 8} | {self.spec_k})
        self._accept_window: List[float] = []
        if self.spec:
            metrics_mod.counters.gauge(metrics_mod.GEN_SPEC_K_CURRENT,
                                       float(self.spec_k))
        # accept length -> (step, slot) count over every spec chunk
        self.spec_accept_hist: Dict[int, int] = {}
        self.accepting = True  # False = decode only, no new admissions
        self.paused = False
        self._slots: List[Optional[_SlotInfo]] = [None] * self.B
        self._table_host = np.zeros((self.B, self.M), np.int32)
        # host mirror of per-slot resident lengths: admission knows them,
        # each chunk's sync refreshes them (width-limits decode tables)
        self._lens_host = np.zeros((self.B,), np.int64)
        # host mirror of "does this slot warp" (top-p/top-k): when no
        # resident slot warps, the chunk skips the [B, V] sort
        self._warp_host = np.zeros((self.B,), bool)
        # fused-epilogue routing mirrors: under the fused sampler a slot
        # needs the sorted fallback only when the online pass cannot serve
        # it (_fused_warp_host: top-p, or top-k past the buffer); plain
        # top-k slots up to TOPK_MAX stay fused through the online top-k
        # buffer (_fused_topk_host)
        self._fused_warp_host = np.zeros((self.B,), bool)
        self._fused_topk_host = np.zeros((self.B,), bool)
        self._pending: List[GenRequest] = []
        self._req_meta: Dict[str, GenRequest] = {}
        self._lock = threading.RLock()
        self._pending_lock = threading.Lock()
        self._clock = _Clock(self.device)
        # the chunk programs' static operands: every run reads the table
        # and the warp rows from these buffers (refilled before it) and
        # writes its harvest flags into _flags_dev
        B, M, dev = self.B, self.M, self.device
        self._table_dev = torch.zeros((B, M), dtype=torch.int32, device=dev)
        self._warp_dev = torch.full((B,), B, dtype=torch.int64, device=dev)
        self._flags_dev = torch.zeros((4, B), dtype=torch.int32, device=dev)
        self._rows = torch.arange(B, device=dev)
        pin = dev.type == "cuda"
        self._io = [
            _ChunkIO(
                table=torch.zeros((B, M), dtype=torch.int32, pin_memory=pin),
                warp=torch.zeros((B,), dtype=torch.int64, pin_memory=pin),
                flags=torch.zeros((4, B), dtype=torch.int32, pin_memory=pin),
            )
            for _ in range(2)
        ]
        self._n_dispatched = 0
        # admission's static operands: a wave's tokens, table rows, starts
        # and counts (_extend_operands) and a commit's rows (_commit_body)
        # are staged into these before each run
        n_max, C = self.admit_buckets[-1], self.admit_chunk
        K = self.max_stop_ids
        self._extend_ops = torch.zeros((n_max * (C + M + 2),),
                                       dtype=torch.int64, device=dev)
        self._commit_ops = torch.zeros(
            (n_max * (_COMMIT_COLS + K + self.S),), dtype=torch.int64,
            device=dev)
        n_stage = max(self._extend_ops.numel(), self._commit_ops.numel())
        self._staging = [
            _Staging(buf=torch.zeros((n_stage,), dtype=torch.int64,
                                     pin_memory=pin))
            for _ in range(_STAGING_RING)
        ]
        self._n_staged = 0
        self._jit_extend: Dict[tuple, _Program] = {}
        self._jit_commit: Dict[int, _Program] = {}
        self._jit_chunk: Dict[tuple, _Program] = {}
        self._jit_spec: Dict[tuple, _Program] = {}
        # device-time spans of the admission under way (_span_open)
        self._spans: List[tuple] = []
        self._span_start = None
        if dev.type == "cuda":
            # every captured program allocates from one pool and captures
            # (and warms up) on one side stream; replays run one at a time
            # on the caller's stream
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(dev)
        self._inflight: Optional[_InFlight] = None   # pipelined: unharvested
        self._steps_ahead = 0   # tokens the in-flight chunk advances a slot
        # admission generation per slot: stale flags from a chunk dispatched
        # before the slot turned over must never harvest its NEW occupant
        self._slot_epoch = np.zeros((B,), np.int64)
        self.stats = {
            "prefill_tokens": 0,        # prompt tokens actually computed
            "prefix_hit_tokens": 0,     # prompt tokens served from shared pages
            "prefix_hits": 0,
            "admitted": 0,
            # decode steps run (one kernel per layer each), warm-ups included
            "decode_steps": 0,
            # device time of admission (prefill and commit), first
            # captures excluded
            "prefill_s": 0.0,
            "decode_s": 0.0,            # device time of decode chunks
            "fused_sample_steps": 0,    # decode steps sampled by the fused epilogue
            "fused_topk_steps": 0,      # ... of which carried the online top-k buffer
            "sampler_fallback_rows": 0,  # slot-steps on the sorted fallback
            # CUDA graphs: one capture per chunk key, each after one eager
            # warm-up step over no active slot (counted in decode_steps)
            "graph_captures": 0,
            "graph_replays": 0,
            "graph_capture_s": 0.0,     # host wall time of warm-ups + captures
            # memory every capture reserved (decode chunks and admission)
            "graph_pool_bytes": 0,
            # admission programs, alike: CUDA graphs captured (each after
            # one eager warm-up run that writes only trash rows) and
            # replayed, and the runs, warm-ups included: extend waves
            # (prefill_waves) and commit buckets (commit_waves)
            "extend_captures": 0,
            "extend_replays": 0,
            "commit_captures": 0,
            "commit_replays": 0,
            "prefill_waves": 0,
            "commit_waves": 0,
            "admit_capture_s": 0.0,     # host wall time of their captures
            "chunk_flag_fetches": 0,    # chunks resolved
            "chunk_flag_blocked": 0,    # ... whose flag copy was not done yet
            # speculative decoding: draft tokens proposed and accepted;
            # spec steps run (warm-ups included, as decode_steps counts
            # vanilla ones), their device time, their CUDA graphs
            # captured and replayed, the steps sampled by the fused
            # epilogue, and (general-q drafters) the sum and count of
            # per-(step, slot) mean accept probabilities
            "spec_draft_tokens": 0,
            "spec_accepted_tokens": 0,
            "spec_steps": 0,
            "spec_s": 0.0,
            "spec_captures": 0,
            "spec_replays": 0,
            "spec_fused_steps": 0,
            "spec_q_accept_prob_sum": 0.0,
            "spec_q_accept_prob_n": 0,
        }

    def _init_drafter(self, cfg: ModelConfig, spec_decode: Optional[bool],
                      drafter: Optional[Drafter]):
        """Resolve the drafter before any state exists (a draft model adds
        its params and a pool). Explicit argument > ``AREAL_SPEC_DRAFT_
        MODEL`` checkpoint > the n-gram self-drafter. The env checkpoint
        is loaded only when spec decode is on: a draft model costs pool
        memory and a sweep per vanilla step, which an engine that never
        speculates must not pay. An explicit drafter is kept regardless
        (its caller may turn spec on later)."""
        self._spec_on = (
            spec_decode
            if spec_decode is not None
            else constants.spec_decode_enabled()
        )
        if drafter is None:
            draft_path = constants.spec_draft_model()
            if draft_path and self._spec_on:
                drafter = TransformerDrafter.from_hf(
                    draft_path, kv_dtype=constants.spec_draft_kv_dtype()
                )
            elif draft_path:
                logger.warning(
                    "%s is set but spec decode is disabled on this engine; "
                    "not loading the draft model (enable %s or pass "
                    "spec_decode=True to serve it)",
                    constants.SPEC_DRAFT_MODEL_ENV, constants.SPEC_DECODE_ENV,
                )
        self.drafter: Drafter = (
            drafter if drafter is not None else NGramDrafter()
        )
        sampled = not getattr(self.drafter, "deterministic", True)
        if sampled and not getattr(self.drafter, "provides_q_logprobs",
                                   False):
            # accepting sampled proposals without their distribution would
            # bias generation toward the drafter
            raise NotImplementedError(
                "non-deterministic drafters need their proposal logprobs "
                "threaded into spec_rejection_sample (q_logprobs): set "
                "provides_q_logprobs = True and return them, or use a "
                "deterministic (one-hot) drafter"
            )
        self._draft: Optional[TransformerDrafter] = (
            self.drafter if isinstance(self.drafter, TransformerDrafter)
            else None
        )
        if sampled and self._draft is None:
            # q reaches the rejection sampler through propose_model only
            raise NotImplementedError(
                "sampled drafters are wired through the TransformerDrafter "
                "propose_model interface (draft params and paged KV inside "
                "the spec chunk); subclass TransformerDrafter to customize "
                "proposals"
            )
        self.draft_cfg: Optional[ModelConfig] = None
        self.draft_kv_dtype: Optional[str] = None
        self.draft_kv_quantized = False
        self.draft_version = 0
        if self._draft is None:
            return
        dcfg = self._draft.cfg
        if dcfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft model vocab ({dcfg.vocab_size}) must match the "
                f"serving model's ({cfg.vocab_size}): proposed tokens are "
                "scored by the target verbatim"
            )
        if dcfg.dtype != cfg.dtype:
            # serve the draft in the target's activation dtype, and write
            # it back: propose_model runs under the drafter's cfg
            dcfg = dataclasses.replace(dcfg, dtype=cfg.dtype)
        self.draft_cfg = self._draft.cfg = dcfg
        dkd = (
            self._draft.kv_dtype
            if self._draft.kv_dtype is not None
            else constants.spec_draft_kv_dtype()
        )
        self.draft_kv_dtype = _resolve_kv_dtype(dkd, dcfg.dtype)
        self.draft_kv_quantized = self.draft_kv_dtype == "int8"

    @staticmethod
    def _own(prepared, src):
        """``prepared`` with every leaf that still aliases ``src`` cloned:
        weight updates copy into the engine's tensors, so none may alias
        the caller's."""
        return tfm.tree_map(
            lambda t, s: t.clone() if t.data_ptr() == s.data_ptr() else t,
            prepared, src,
        )

    def _make_state(self, cache: tfm.PagedKVCache, width: int,
                    draft_cache: Optional[tfm.PagedKVCache] = None
                    ) -> GenState:
        """Slot state over ``cache`` (and ``draft_cache``) with ``width``
        output columns a slot, every slot inactive; each per-slot tensor is
        a view of the first B rows of one with a trash row
        (``GenState.padded``)."""
        B, dev = self.B, self.device
        padded = {}

        def full(name, cols, value, dtype):
            padded[name] = torch.full((B + 1,) + cols, value, dtype=dtype,
                                      device=dev)
            return padded[name][:B]

        K = self.max_stop_ids
        return GenState(
            cache=cache,
            lens=full("lens", (), 0, torch.int32),
            last_tokens=full("last_tokens", (), 0, torch.int64),
            active=full("active", (), False, torch.bool),
            n_gen=full("n_gen", (), 0, torch.int32),
            min_gen=full("min_gen", (), 0, torch.int32),
            max_gen=full("max_gen", (), 0, torch.int32),
            stop_ids=full("stop_ids", (K,), -1, torch.int64),
            out_tokens=full("out_tokens", (width,), 0, torch.int64),
            out_logprobs=full("out_logprobs", (width,), 0.0, torch.float32),
            ctx_tokens=full("ctx_tokens", (self.S,), 0, torch.int64),
            fallback_token=full("fallback_token", (), 0, torch.int64),
            sp=SamplingParams(
                temperature=full("temperature", (), 1.0, torch.float32),
                top_p=full("top_p", (), 1.0, torch.float32),
                top_k=full("top_k", (), 1 << 30, torch.int64),
            ),
            padded=padded,
            draft_cache=draft_cache,
        )

    # ------------------------------------------------------------------ #
    # Client API
    # ------------------------------------------------------------------ #

    def submit(self, req: GenRequest):
        # runs on the server's handler thread, so the span inherits the
        # request's activated trace context: the engine-layer hop of the
        # distributed trace (chunk spans are batch-level and root their own)
        with tracing.span("gen_engine/submit", rid=req.rid,
                          prompt_len=len(req.input_ids)):
            need = len(req.input_ids) - 1 + min(req.max_new_tokens, self.G)
            if need > self.S:
                raise ValueError(
                    f"prompt {len(req.input_ids)} + max_new "
                    f"{req.max_new_tokens} exceeds per-slot capacity {self.S}"
                )
            with self._pending_lock:
                self._pending.append(req)
                self._req_meta[req.rid] = req

    def free_slots(self) -> int:
        return sum(s is None for s in self._slots)

    def n_running(self) -> int:
        return sum(s is not None for s in self._slots)

    def n_pending(self) -> int:
        with self._pending_lock:
            return len(self._pending)

    def n_compiles(self) -> int:
        """Programs built so far, as the reference counts its jitted ones:
        extend programs per ``(n_rows, width, skip_pool)``, commit programs
        per admit-row bucket, decode chunks per ``(n_steps, width,
        warp_bucket, fused, with_topk)`` and spec chunks per ``(n_steps,
        width, warp_bucket, spec_k, fused)`` (a CUDA graph each on a GPU).
        Bounded by the buckets and chunk sizes, never by prompt lengths."""
        return (len(self._jit_extend) + len(self._jit_commit)
                + len(self._jit_chunk) + len(self._jit_spec))

    @property
    def has_inflight(self) -> bool:
        """Pipelined mode: a dispatched chunk whose finishes have not been
        harvested yet (the run and serve loops must keep stepping)."""
        return self._inflight is not None

    def kv_pool_bytes(self) -> int:
        """Configured KV-pool footprint (pages + quant scales), from shapes."""
        return self._pool_bytes_for(self.cfg, self.kv_quantized)

    def _pool_bytes_for(self, cfg: ModelConfig, quantized: bool) -> int:
        elems = cfg.n_layers * self.n_pages * 2 * cfg.n_kv_heads * self.page
        item = 1 if quantized else torch_dtype(cfg.dtype).itemsize
        total = elems * cfg.head_dim * item
        if quantized:
            total += elems * 4  # one f32 scale per (token slot, head, K|V)
        return total

    def draft_kv_pool_bytes(self) -> int:
        """Configured footprint of the draft model's KV pool (0 without a
        draft model): the target pool's page count at the draft's layer
        and head shape and its own storage dtype."""
        if self._draft is None:
            return 0
        return self._pool_bytes_for(self.draft_cfg, self.draft_kv_quantized)

    def kv_pool_occupancy(self) -> float:
        """Fraction of pool pages currently held (slots + prefix cache)."""
        return 1.0 - self.pool.n_free / max(self.n_pages, 1)

    def _observe_occupancy(self):
        """Fold the pool occupancy into the telemetry histogram: host
        arithmetic on the page counts, at a chunk dispatch."""
        occ = self.kv_pool_occupancy()
        metrics_mod.counters.observe(metrics_mod.GEN_KV_POOL_OCCUPANCY, occ)
        if self._draft is not None:
            # lockstep pools: the draft pool's occupancy is the target's,
            # under its own name
            metrics_mod.counters.observe(
                metrics_mod.GEN_DRAFT_KV_POOL_OCCUPANCY, occ)

    def kv_pool_demand_occupancy(self) -> float:
        """Occupancy excluding prefix-cache-only pages (instantly
        evictable under pressure): the admission signal."""
        free_eq = self.pool.n_free + self.prefix.n_reclaimable()
        return 1.0 - free_eq / max(self.n_pages, 1)

    def prepare_params(self, params):
        """The port's param dict in the serving dtype on the engine's
        device, cut loose from autograd (a trainer may hand over its own
        leaves)."""
        return tfm.tree_map(lambda t: t.detach(),
                            tfm.cast_params(self.cfg, params, self.device))

    def prepare_draft_params(self, params):
        """:meth:`prepare_params` for the DRAFT model's params (the draft's
        serving dtype, the engine's device)."""
        if self._draft is None:
            raise ValueError("engine has no draft model configured")
        return tfm.tree_map(
            lambda t: t.detach(),
            tfm.cast_params(self.draft_cfg, params, self.device))

    @staticmethod
    def _check_shapes(dst_tree, src_tree):
        def check(dst, src):
            if dst.shape != src.shape:
                raise ValueError(f"weight update: shape {tuple(src.shape)} "
                                 f"!= the engine's {tuple(dst.shape)}")

        tfm.tree_map(check, dst_tree, src_tree)

    def update_params(self, params, version: Optional[int] = None,
                      draft_params=None):
        """Hot weight swap between decode chunks. The new weights are
        COPIED into the engine's own tensors under the lock (their shapes
        and dtypes are fixed by ``cfg``), so every captured chunk program
        reads them on its next replay and none is recaptured; a chunk
        already in flight finishes on the old weights first (the copy
        follows it on the stream). Raises ``ValueError``, changing
        nothing, if a shape differs. Invalidates the prefix cache: prompt
        KV computed under old weights must not seed new generations.

        ``draft_params`` optionally rides along (the draft keeps tracking
        the policy during RL): both swaps land under one lock and one
        prefix invalidation, and ``draft_version`` moves too."""
        params = self.prepare_params(params)
        self._check_shapes(self.params, params)
        if draft_params is not None:
            draft_params = self.prepare_draft_params(draft_params)
            self._check_shapes(self.draft_params, draft_params)
        with self._lock:
            tfm.tree_map(lambda dst, src: dst.copy_(src), self.params, params)
            if draft_params is not None:
                tfm.tree_map(lambda dst, src: dst.copy_(src),
                             self.draft_params, draft_params)
                self.draft_version += 1
            self.version = version if version is not None else self.version + 1
            self._n_updates += 1
            self.prefix.clear()

    def update_draft_params(self, draft_params):
        """Swap ONLY the draft model's weights between chunks, copied into
        the engine's draft tensors (graphs keep reading them, none is
        recaptured). The policy ``version`` stays (spec decode is
        distribution-preserving, so outputs are unaffected); ``draft_
        version`` moves and the prefix cache is cleared: cached pages hold
        draft KV of the old draft weights, which a fresh draft should not
        propose from."""
        draft_params = self.prepare_draft_params(draft_params)
        self._check_shapes(self.draft_params, draft_params)
        with self._lock:
            tfm.tree_map(lambda dst, src: dst.copy_(src), self.draft_params,
                         draft_params)
            self.draft_version += 1
            self._n_updates += 1
            self.prefix.clear()

    def partial_outputs(
        self, rids: Optional[Sequence[str]] = None
    ) -> Dict[str, Tuple[List[int], List[float]]]:
        """Accumulated (tokens, logprobs) so far for running slots; one
        device pull serves every requested slot."""
        with self._lock:
            wanted = None if rids is None else set(rids)
            sel = [
                (b, s.rid)
                for b, s in enumerate(self._slots)
                if s is not None and (wanted is None or s.rid in wanted)
            ]
            if not sel:
                return {}
            host = self._pull_outputs()
            out: Dict[str, Tuple[List[int], List[float]]] = {}
            for b, rid in sel:
                n = int(host["n_gen"][b])
                out[rid] = (
                    host["out_tokens"][b, :n].tolist(),
                    host["out_logprobs"][b, :n].tolist(),
                )
            return out

    def cancel(self, rid: str) -> bool:
        """Abort a request: drop it from the pending queue, or release its
        slot + pages mid-generation. Safe against a pipelined chunk in
        flight: the released slot is ``None`` (or, once re-admitted, of a
        newer epoch), so that chunk's flags skip it, and its writes to the
        released pages come before any new occupant's prefill on the
        stream. False when the rid is unknown."""
        with self._pending_lock:
            for i, r in enumerate(self._pending):
                if r.rid == rid:
                    del self._pending[i]
                    self._req_meta.pop(rid, None)
                    return True
        with self._lock:
            for b, s in enumerate(self._slots):
                if s is not None and s.rid == rid:
                    self._release_slot(b)
                    self.state.active[b] = False
                    self.state.lens[b] = 0
                    return True
        return False

    def pause(self) -> List[GenOutput]:
        """Stop generating and harvest all running slots as interrupted."""
        with self._lock:
            self.paused = True
            inflight, self._inflight = self._inflight, None
            self._steps_ahead = 0
            if inflight is not None:
                # its flags are dropped (the pull below reads the state the
                # chunk left); resolving keeps its device time in decode_s
                self._resolve(inflight)
            if not any(s is not None for s in self._slots):
                return []
            host_state = self._pull_outputs()
            outs = []
            for b, s in enumerate(self._slots):
                if s is not None:
                    # pipelined mode can hold finished-but-unharvested
                    # slots: they report stop / length, never interrupted
                    # (the client would resubmit a complete sample)
                    reason = (
                        "interrupted" if host_state["active"][b]
                        else _finish_reason(
                            host_state["n_gen"][b], host_state["max_gen"][b]
                        )
                    )
                    outs.append(
                        self._harvest(b, reason, host_state=host_state)
                    )
            self.state.active.zero_()
            self.state.lens.zero_()
            return outs

    def resume(self):
        with self._lock:
            self.paused = False

    # ------------------------------------------------------------------ #
    # Admission: chunked prefill through the page pool
    # ------------------------------------------------------------------ #

    def _table_width(self, max_pos: int) -> int:
        """Page-table width for work that touches positions up to
        ``max_pos``: enough pages, rounded up to a power of two, floored at
        32 and capped at the full table. The plain-PyTorch gather behind
        prefill then reads O(resident) pages, and the decode kernel gets
        the narrowed table with its row stride."""
        need = -(-max_pos // self.page)
        w = 32
        while w < need:
            w *= 2
        return min(w, self.M)

    def _row_bucket(self, n: int) -> int:
        return next(
            b for b in self.admit_buckets
            if b >= min(n, self.admit_buckets[-1])
        )

    def _stage(self, host: np.ndarray, dst: torch.Tensor):
        """Copy the i64 operands ``host`` into the head of the static
        device buffer ``dst`` through the next pinned staging buffer of the
        ring, enqueued on the engine's stream (behind whatever program ran
        before it, ahead of the one that reads it). The staging buffer is
        rewritten only once the copy out of it, ``_STAGING_RING`` stagings
        ago, has run."""
        st = self._staging[self._n_staged % len(self._staging)]
        self._n_staged += 1
        if st.done is not None:
            st.done.synchronize()
        n = host.size
        st.buf[:n].numpy()[:] = host.reshape(-1)
        dst[:n].copy_(st.buf[:n], non_blocking=True)
        if self.device.type == "cuda":
            st.done = torch.cuda.Event()
            st.done.record()

    # device time of admission: spans of clock marks, closed around each
    # first capture (its host time is not admission's device time)

    def _span_open(self):
        self._span_start = self._clock.mark()

    def _span_close(self):
        self._spans.append((self._span_start, self._clock.mark()))

    def _admission_program(self, programs: dict, key, build) -> _Program:
        """``programs[key]``, built by ``build(key)`` at its first use
        outside the admission's device-time spans."""
        prog = programs.get(key)
        if prog is None:
            self._span_close()
            prog = programs[key] = build(key)
            self._span_open()
        return prog

    def _extend_operands(self, key: tuple):
        """The static operand views of an extend key ``(n_rows, width,
        skip_pool)``: tokens ``[n, admit_chunk]``, table ``[n, width]``,
        start ``[n]`` and n_new ``[n]``, packed in this order at the head
        of ``_extend_ops``."""
        n, W, _ = key
        C = self.admit_chunk
        ops = self._extend_ops
        ends = np.cumsum([0, n * C, n * W, n, n]).tolist()
        tokens, table, start, n_new = (
            ops[lo:hi] for lo, hi in zip(ends[:-1], ends[1:])
        )
        return tokens.view(n, C), table.view(n, W), start, n_new

    def _extend_body(self, key: tuple, n_new: Optional[torch.Tensor] = None):
        """One wave of chunked prefill over the static operands of ``key``
        (``n_new`` in place of the staged counts: the warm-up's zeros). It
        writes the KV pool in place and nothing else; with a draft model,
        the draft pool too (same tokens, tables and waves, which keeps the
        pools in lockstep through prefix sharing)."""
        tokens, table, start, staged = self._extend_operands(key)
        n_new = staged if n_new is None else n_new
        tfm.extend_paged(
            self.params, self.cfg, self.state.cache, tokens, table, start,
            n_new, skip_pool=key[2],
        )
        if self._draft is not None:
            tfm.extend_paged(
                self.draft_params, self.draft_cfg, self.state.draft_cache,
                tokens, table, start, n_new, skip_pool=key[2],
            )

    def _build_extend(self, key: tuple) -> _Program:
        """The extend program of ``key``; on a GPU captured after one eager
        warm-up over the staged tokens, table and starts with every count
        at zero: every write then goes to the pool's trash row."""
        n = key[0]
        prog, seconds = self._capture(
            functools.partial(self._extend_body, key),
            lambda: self._extend_body(
                key, torch.zeros((n,), dtype=torch.int64,
                                 device=self.device)),
        )
        if prog.graph is not None:
            self.stats["extend_captures"] += 1
            self.stats["prefill_waves"] += 1
            self.stats["admit_capture_s"] += seconds
        return prog

    def _run_extends(self, rows: List[dict]):
        """Stream each row's tokens through fixed ``[n_rows, admit_chunk]``
        extend programs (rows padded to an admit bucket with ``n_new =
        0``); each wave sees only the table prefix its positions can
        touch."""
        if not rows:
            return
        C = self.admit_chunk
        i = 0
        while i < len(rows):
            n = self._row_bucket(len(rows) - i)
            chunk_rows = rows[i : i + n]
            i += len(chunk_rows)
            max_t = max(len(r["tokens"]) for r in chunk_rows)
            n_chunks = max(1, -(-max_t // C))
            tables = np.zeros((n, self.M), np.int64)
            starts0 = np.zeros((n,), np.int64)
            all_tokens = np.zeros((n, n_chunks * C), np.int64)
            counts = np.zeros((n,), np.int64)
            for j, r in enumerate(chunk_rows):
                tables[j] = r["table_row"]
                starts0[j] = r["start"]
                all_tokens[j, : len(r["tokens"])] = r["tokens"]
                counts[j] = len(r["tokens"])
            for c in range(n_chunks):
                n_new = np.clip(counts - c * C, 0, C)
                if not n_new.any():
                    break
                max_pos = int(np.max(starts0 + np.minimum(counts, (c + 1) * C)))
                W = self._table_width(max_pos)
                # cold-prompt first waves start every row at position 0:
                # nothing in the pool is visible, skip its gather + scan
                key = (n, W, c == 0 and not starts0.any())
                # staged before a first use: the warm-up reads these
                self._stage(np.concatenate([
                    all_tokens[:, c * C : (c + 1) * C].reshape(-1),
                    tables[:, :W].reshape(-1), starts0 + c * C, n_new,
                ]), self._extend_ops)
                prog = self._admission_program(self._jit_extend, key,
                                               self._build_extend)
                prog.run()
                self.stats["prefill_waves"] += 1
                if prog.graph is not None:
                    self.stats["extend_replays"] += 1

    def _admit_pending(self) -> bool:
        """Admit what fits; returns whether anything was admitted."""
        if not self.accepting:
            return False
        free = [b for b, s in enumerate(self._slots) if s is None]
        if not free:
            return False
        admitted: List[Tuple[GenRequest, int]] = []
        misses: List[dict] = []
        hits: List[dict] = []
        deferred_inserts: List[Tuple[List[int], List[int]]] = []
        still_pending: List[GenRequest] = []
        with self._pending_lock:
            take = self._pending[: len(free) + 8]  # small lookahead
            del self._pending[: len(take)]
        while take and free:
            r = take.pop(0)
            ids = list(r.input_ids)
            plen_eff = len(ids) - 1               # prefilled positions
            max_gen = min(r.max_new_tokens, self.G)
            n_total = -(-(plen_eff + max_gen) // self.page)
            n_shared_full = plen_eff // self.page
            shared: List[int] = []
            if self.enable_prefix_cache and n_shared_full > 0:
                shared = self.prefix.lookup(ids, n_shared_full) or []
            n_owned = n_total - len(shared)
            if self.pool.n_free < n_owned:
                self.prefix.evict_lru(n_owned)
            try:
                owned = self.pool.alloc(n_owned)
            except OutOfPagesError:
                # pool pressure: retry on a later step
                if shared:
                    self.pool.release(shared)
                still_pending.append(r)
                break
            slot = free.pop(0)
            self._slot_epoch[slot] += 1
            table_row = np.zeros((self.M,), np.int32)
            table_row[: len(shared) + len(owned)] = shared + owned
            self._table_host[slot] = table_row
            self._slots[slot] = _SlotInfo(rid=r.rid, pages=owned,
                                          borrowed=shared,
                                          n_updates=self._n_updates)
            covered = len(shared) * self.page
            row = {"tokens": ids[covered:plen_eff], "start": covered,
                   "table_row": table_row}
            if shared:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_hit_tokens"] += covered
                hits.append(row)
                if n_shared_full > len(shared):
                    # partial hit: register the divergent tail only AFTER
                    # the extend waves ran (a same-cycle borrower in wave 2
                    # must not read pages before they are written)
                    n_new = n_shared_full - len(shared)
                    deferred_inserts.append((ids, shared + owned[:n_new]))
            else:
                misses.append(row)
                if self.enable_prefix_cache and n_shared_full > 0:
                    # cold prompt: its pages are written in wave 1, so
                    # same-cycle group members can borrow them in wave 2
                    self.prefix.insert(ids, list(owned[:n_shared_full]))
            self.stats["prefill_tokens"] += len(row["tokens"])
            self.stats["admitted"] += 1
            admitted.append((r, slot))
        still_pending.extend(take)  # slots/pool ran out: back in line
        if still_pending:
            with self._pending_lock:
                self._pending[:0] = still_pending
        if not admitted:
            return False
        # wave 1: unique prompts compute their KV; wave 2: prefix borrowers
        # extend only their tails (replays on one stream keep this order)
        self._run_extends(misses)
        self._run_extends(hits)
        for ins_ids, ins_pages in deferred_inserts:
            self.prefix.insert(ins_ids, ins_pages)
        self._commit(admitted)
        return True

    def _commit_body(self, ops: torch.Tensor):
        """Write the decode state of the slots in ``ops`` ``[n, 8 + K +
        S]`` (rows as ``_COMMIT_COLS`` says) through ``GenState.padded``: a
        padding row names slot B, the trash row. Everything happens in
        place on the device. ``ctx_tokens`` gets the full prompt (borrowed
        prefix pages included: the prefix cache shares KV, not ids) and
        ``fallback_token`` the last prompt token."""
        st = self.state.padded
        slots = ops[:, 0]
        K = self.max_stop_ids

        def f32(col):   # a float32 column, staged as its bits
            return ops[:, col].to(torch.int32).view(torch.float32)

        for name, val in (
            ("last_tokens", ops[:, 1]),
            ("lens", ops[:, 2].to(torch.int32)),
            ("temperature", f32(3)),
            ("top_p", f32(4)),
            ("top_k", ops[:, 5]),
            ("min_gen", ops[:, 6].to(torch.int32)),
            ("max_gen", ops[:, 7].to(torch.int32)),
            ("stop_ids", ops[:, _COMMIT_COLS:_COMMIT_COLS + K]),
            ("ctx_tokens", ops[:, _COMMIT_COLS + K:]),
            ("fallback_token", ops[:, 1]),
        ):
            st[name].index_copy_(0, slots, val)
        st["active"].index_fill_(0, slots, True)
        for name in ("n_gen", "out_tokens", "out_logprobs"):
            st[name].index_fill_(0, slots, 0)

    def _build_commit(self, n: int) -> _Program:
        """The commit program of an ``n``-row bucket; on a GPU captured
        after one eager warm-up whose every row is a padding row."""
        ops = self._commit_ops[
            : n * (_COMMIT_COLS + self.max_stop_ids + self.S)]
        ops = ops.view(n, -1)

        def warm_up():
            pad = ops.clone()
            pad[:, 0] = self.B
            self._commit_body(pad)

        prog, seconds = self._capture(
            functools.partial(self._commit_body, ops), warm_up)
        if prog.graph is not None:
            self.stats["commit_captures"] += 1
            self.stats["commit_waves"] += 1
            self.stats["admit_capture_s"] += seconds
        return prog

    def _commit(self, admitted: List[Tuple[GenRequest, int]]):
        """Write the admitted slots' decode state in admit-row buckets, one
        commit program per bucket size; each bucket's operands go to the
        device in one staged copy."""
        K = self.max_stop_ids
        i = 0
        while i < len(admitted):
            n = self._row_bucket(len(admitted) - i)
            group = admitted[i : i + n]
            i += len(group)
            ops = np.zeros((n, _COMMIT_COLS + K + self.S), np.int64)
            ops[:, 0] = self.B               # padding rows: the trash row
            ops[:, 3] = np.float32(1.0).view(np.int32)
            ops[:, 4] = np.float32(1.0).view(np.int32)
            ops[:, 5] = 1 << 30
            ops[:, _COMMIT_COLS:_COMMIT_COLS + K] = -1
            for j, (r, slot) in enumerate(group):
                ids = r.input_ids
                self._lens_host[slot] = len(ids) - 1
                self._warp_host[slot] = (
                    r.top_p < 1.0 or r.top_k < self.cfg.vocab_size
                ) and not r.greedy and r.temperature > 0.0
                sampled = not r.greedy and r.temperature > 0.0
                topk_on = r.top_k < self.cfg.vocab_size
                self._fused_warp_host[slot] = sampled and (
                    r.top_p < 1.0
                    or (topk_on and r.top_k > fused_ops.TOPK_MAX)
                )
                self._fused_topk_host[slot] = (
                    sampled and r.top_p >= 1.0
                    and topk_on and r.top_k <= fused_ops.TOPK_MAX
                )
                temp = 0.0 if r.greedy else r.temperature
                merged = list(dict.fromkeys(
                    self.global_stop_ids + list(r.stop_token_ids)))[:K]
                ops[j, :_COMMIT_COLS] = (
                    slot, ids[-1], len(ids) - 1,
                    np.float32(temp).view(np.int32),
                    np.float32(r.top_p).view(np.int32),
                    min(r.top_k, 1 << 30), r.min_new_tokens,
                    min(r.max_new_tokens, self.G),
                )
                ops[j, _COMMIT_COLS : _COMMIT_COLS + len(merged)] = merged
                ctx = ids[: self.S]
                ops[j, _COMMIT_COLS + K : _COMMIT_COLS + K + len(ctx)] = ctx
            self._stage(ops, self._commit_ops)
            prog = self._admission_program(self._jit_commit, n,
                                           self._build_commit)
            prog.run()
            self.stats["commit_waves"] += 1
            if prog.graph is not None:
                self.stats["commit_replays"] += 1

    # ------------------------------------------------------------------ #
    # Decode
    # ------------------------------------------------------------------ #

    def _warp_bucket(self, n: int) -> int:
        """Power-of-two capacity for the warping-slot index operand (0 =
        nothing warps), as in the reference's jit keys."""
        if n <= 0:
            return 0
        w = 1
        while w < n:
            w *= 2
        return min(w, self.B)

    def _sample_fused(self, sp: SamplingParams, gen: torch.Generator,
                      hidden: torch.Tensor,
                      warp_rows: Optional[torch.Tensor], with_topk: bool):
        """One step's tokens and logprobs from final-norm hidden states
        ``[B, E]`` through the fused epilogue. ``with_topk`` carries the
        online top-k buffer for resident plain-top-k slots. The slots named
        by ``warp_rows`` (padded with the out-of-range index B) materialize
        only their own logits rows through the head, take the sorted
        sampler and overwrite; padding rows land in a spare row past the
        batch, which is dropped."""
        cfg, B = self.cfg, self.B
        # the step's seed stays on the device: no host sync
        seed = torch.randint(
            -(1 << 31), (1 << 31) - 1, (1,), generator=gen,
            device=self.device, dtype=torch.int32,
        )
        greedy_rows = sp.temperature <= 0.0
        topk_arg = None
        if with_topk:
            # inactive rows (and rows past the buffer) carry a sentinel
            # > TOPK_MAX so fused_sample ignores them
            topk_arg = torch.where(
                (sp.top_k <= fused_ops.TOPK_MAX) & ~greedy_rows,
                sp.top_k, 1 << 30,
            )
        out = fused_ops.fused_sample(
            seed, hidden, tfm.head_weight(cfg, self.params),
            sp.temperature, greedy_rows,
            soft_cap=cfg.final_logits_soft_cap, topk=topk_arg,
            block_size=FUSED_TOPK_BLOCK,
        )
        tokens, lp = out["tokens"].long(), out["logprobs"]
        if warp_rows is not None:
            safe = warp_rows.clamp(0, B - 1)
            row_logits = tfm.apply_head(cfg, self.params, hidden[safe])
            w_tok, w_lp = sample_tokens(
                gen, row_logits, sp.rows(safe), warp=True
            )
            tokens = torch.cat([tokens, tokens[:1]])
            lp = torch.cat([lp, lp[:1]])
            tokens[warp_rows] = w_tok
            lp[warp_rows] = w_lp
            tokens, lp = tokens[:B], lp[:B]
        return tokens, lp

    def _chunk_body(self, st: GenState, gen: torch.Generator, n_steps: int,
                    table: torch.Tensor, warp_rows: Optional[torch.Tensor],
                    with_topk: bool, flags: torch.Tensor):
        """``n_steps`` decode steps for every slot of ``st``, then the
        harvest flags (active, n_gen, max_gen, lens) into ``flags``
        ``[4, B]``. Every result is written IN PLACE into ``st`` and
        ``flags``, and every operand is read where it lies: captured once,
        the body's graph then reads and writes the engine's own tensors
        on each replay. No host sync, no host-to-device copy.

        Each step also appends the sampled token to ``ctx_tokens`` and, on
        a draft engine, runs one headless draft decode step that writes
        the draft model's KV of the token the target just consumed, so a
        spec chunk can take over mid-stream."""
        cfg = self.cfg
        rows = self._rows
        last_col = st.out_tokens.shape[1] - 1
        for _ in range(n_steps):
            head_out, _, new_lens = tfm.decode_step_paged(
                self.params, cfg, st.cache, st.last_tokens, table,
                st.lens, st.active, return_hidden=self.fused,
            )
            if self._draft is not None:
                tfm.decode_step_paged(
                    self.draft_params, self.draft_cfg, st.draft_cache,
                    st.last_tokens, table, st.lens, st.active,
                    with_head=False,
                )
            if self.fused:
                tokens, lp = self._sample_fused(st.sp, gen, head_out,
                                                warp_rows, with_topk)
            else:
                tokens, lp = sample_tokens(
                    gen, head_out, st.sp, warp=warp_rows is not None,
                    warp_rows=warp_rows,
                )
            tokens = torch.where(st.active, tokens, st.last_tokens)
            idx = st.n_gen.clamp(0, last_col).long()
            st.out_tokens[rows, idx] = torch.where(
                st.active, tokens, st.out_tokens[rows, idx]
            )
            st.out_logprobs[rows, idx] = torch.where(
                st.active, lp, st.out_logprobs[rows, idx]
            )
            n_gen = st.n_gen + st.active.int()
            hit_stop = (tokens[:, None] == st.stop_ids).any(1) & (
                n_gen >= st.min_gen
            )
            active = st.active & ~hit_stop & (n_gen < st.max_gen)
            # the drafter's token mirror: ctx[new_lens] = the sampled token
            self._drop_put(st, "ctx_tokens", st.active, new_lens, tokens)
            st.active.copy_(active)
            st.n_gen.copy_(n_gen)
            st.lens.copy_(new_lens)
            st.last_tokens.copy_(tokens)
        self._write_flags(st, flags)

    @staticmethod
    def _write_flags(st: GenState, flags: torch.Tensor):
        for i, f in enumerate((st.active, st.n_gen, st.max_gen, st.lens)):
            flags[i].copy_(f)

    def _drop_put(self, st: GenState, name: str, keep: torch.Tensor,
                  cols: torch.Tensor, vals: torch.Tensor):
        """``st.<name>[b, cols[b, ...]] = vals[b, ...]`` where ``keep`` and
        the column is in range; every other write lands in the trash row
        (the reference's ``mode="drop"``). ``keep``/``cols``/``vals`` are
        ``[B]`` or ``[B, C]``."""
        buf = st.padded[name]
        width = buf.shape[1]
        rows = self._rows if keep.dim() == 1 else self._rows[:, None]
        keep = keep & (cols < width)
        buf[torch.where(keep, rows, self.B),
            cols.clamp(0, width - 1).long()] = vals

    def _spec_step(self, st: GenState, gen: torch.Generator, K: int,
                   table: torch.Tensor, warp_rows: Optional[torch.Tensor],
                   fused: bool, aux: torch.Tensor):
        """One speculative step for every slot of ``st``, in place: propose
        K tokens (the n-gram lookup or the draft model), verify the K+1
        positions in one pass, accept a prefix by rejection sampling, and
        emit 1..K+1 tokens per slot, truncated at the first stop token
        (held back by ``min_new_tokens``) and at ``max_gen``. ``aux`` ``[3,
        B]`` gets the drafted and accepted counts and, for a general-q
        drafter, the mean accept probability."""
        cfg, B, dev = self.cfg, self.B, self.device
        C = K + 1
        pos_i = torch.arange(C, device=dev)[None, :]
        active = st.active
        n_new = torch.where(active, C, 0).to(torch.int32)
        # KV residency bound, acceptance-agnostic: position i's KV can be
        # read only if emission n_gen+i stays below the cap, and a write
        # past it could run off the slot's pages
        write_mask = active[:, None] & (
            st.n_gen[:, None] + pos_i < st.max_gen[:, None])
        q_logprobs = None
        if self._draft is not None:
            draft, q_logprobs = self._draft.propose_model(
                self.draft_params, st.draft_cache, st.last_tokens, table,
                st.lens, write_mask, st.sp, gen, K,
            )
        else:
            draft = self.drafter.propose(st.ctx_tokens, st.lens,
                                         st.fallback_token, K)
        draft = draft.long()
        chunk_toks = torch.cat([st.last_tokens[:, None], draft], dim=1)
        verify_out, _ = tfm.verify_step_paged(
            self.params, cfg, st.cache, chunk_toks, table, st.lens, n_new,
            write_mask, return_hidden=fused,
        )
        q_acc = None
        if fused:
            # one-hot drafter (the routing guarantees it): acceptance from
            # the streamed head, the [B, C, V] logits never materialize
            a, cand, cand_lp, barg = fused_ops.fused_spec_rejection(
                gen, verify_out, tfm.head_weight(cfg, self.params), draft,
                st.sp, soft_cap=cfg.final_logits_soft_cap,
                block_size=FUSED_TOPK_BLOCK,
            )
            if warp_rows is not None:
                # warping slots keep the sorted rejection sampler over their
                # own [W, C, V] logits rows; padding rows land in a spare
                # row past the batch, which is dropped
                safe = warp_rows.clamp(0, B - 1)
                row_logits = tfm.apply_head(cfg, self.params,
                                            verify_out[safe])
                sub = spec_rejection_sample(gen, row_logits, draft[safe],
                                            st.sp.rows(safe), warp=True)
                merged = []
                for full, part in zip((a, cand, cand_lp, barg), sub):
                    full = torch.cat([full, full[:1]])
                    full[warp_rows] = part
                    merged.append(full[:B])
                a, cand, cand_lp, barg = merged
        else:
            has_q = q_logprobs is not None
            rej = spec_rejection_sample(
                gen, verify_out, draft, st.sp, warp=warp_rows is not None,
                warp_rows=warp_rows, q_logprobs=q_logprobs,
                return_accept_prob=has_q,
            )
            a, cand, cand_lp, barg = rej[:4]
            if has_q:
                q_acc = rej[4].mean(dim=1)
        # masked variable-length advance: accepted drafts + one residual,
        # capped at the remaining budget, truncated at the first stop
        # token (stop included, as in vanilla decode)
        e0 = torch.minimum(a + 1, (st.max_gen - st.n_gen).long())
        emit_no = st.n_gen[:, None] + pos_i + 1
        is_stop = (cand[:, :, None] == st.stop_ids[:, None, :]).any(dim=2) & (
            emit_no >= st.min_gen[:, None])
        stop_hit = is_stop & (pos_i < e0[:, None])
        any_stop = stop_hit.any(dim=1)
        first_stop = torch.where(stop_hit, pos_i, C).amin(dim=1)
        e = torch.where(any_stop, first_stop + 1, e0)
        e = torch.where(active, e, 0)                      # emitted count
        emitted = pos_i < e[:, None]
        self._drop_put(st, "out_tokens", emitted,
                       st.n_gen[:, None] + pos_i, cand)
        self._drop_put(st, "out_logprobs", emitted,
                       st.n_gen[:, None] + pos_i, cand_lp)
        # t0's KV and the accepted drafts' became resident; rejected
        # drafts' writes sit beyond the new lens, masked until overwritten
        self._drop_put(st, "ctx_tokens", emitted,
                       st.lens[:, None] + 1 + pos_i, cand)
        n_gen = st.n_gen + e
        last = torch.where(
            e > 0, cand[self._rows, (e - 1).clamp(min=0)], st.last_tokens)
        new_active = active & ~any_stop & (n_gen < st.max_gen)
        aux[0].copy_(torch.where(active, K, 0))
        aux[1].copy_(torch.minimum(a, e))
        aux[2].copy_(torch.where(active, q_acc, 0.0) if q_acc is not None
                     else torch.zeros_like(aux[2]))
        st.fallback_token.copy_(torch.where(active, barg, st.fallback_token))
        st.lens.copy_(st.lens + e)
        st.n_gen.copy_(n_gen)
        st.last_tokens.copy_(last)
        st.active.copy_(new_active)

    def _spec_chunk_body(self, st: GenState, gen: torch.Generator,
                         n_steps: int, K: int, table: torch.Tensor,
                         warp_rows: Optional[torch.Tensor], fused: bool,
                         flags: torch.Tensor, aux: torch.Tensor):
        """``n_steps`` spec steps (``_spec_step``), then the harvest flags
        into ``flags`` and each step's counts into ``aux`` ``[3, n_steps,
        B]``. In place, like ``_chunk_body``: a GPU captures it once per
        spec key and replays it."""
        for i in range(n_steps):
            self._spec_step(st, gen, K, table, warp_rows, fused, aux[:, i])
        self._write_flags(st, flags)

    def _program(self, spec: bool, key: tuple) -> _Program:
        """The program of ``key``, built at its first use: a spec chunk's
        (``(n_steps, width, warp_bucket, spec_k, fused)``, ``_jit_spec``)
        or a decode chunk's (``(n_steps, width, warp_bucket, fused,
        with_topk)``, ``_jit_chunk``)."""
        programs = self._jit_spec if spec else self._jit_chunk
        prog = programs.get(key)
        if prog is None:
            build = self._build_spec if spec else self._build_program
            prog = programs[key] = build(key)
        return prog

    def _capture(self, body: Callable[[], None], warm_up: Callable[[], None],
                 generator: Optional[torch.Generator] = None):
        """``(program, seconds)`` for ``body``. On the CPU: the eager body
        over the static buffers. On a GPU: ``capture_graph`` on the
        engine's capture stream into its one graph pool; the warm-up also
        grows the paged-decode arrival counters and must write nothing but
        trash rows. The body's results must land in the engine's own
        tensors: every graph shares the pool, so nothing a replay allocates
        outlives it. A program on a GPU never runs eagerly."""
        if self.device.type != "cuda":
            return _Program(run=body), 0.0
        # the warm-up runs eagerly, so it adds nothing to ``captured``
        captured = {m: m.captured for m in _KERNEL_MODULES}
        graph, pool_bytes, seconds = capture_graph(
            body, warm_up, stream=self._capture_stream, pool=self._graph_pool,
            generator=generator)
        launches = {m: m.captured - captured[m] for m in _KERNEL_MODULES}
        self.stats["graph_pool_bytes"] += pool_bytes
        prog = _Program(run=graph.replay, graph=graph, launches=launches)
        return prog, seconds

    def _build_program(self, key: tuple) -> _Program:
        """The chunk program of ``key`` (``_capture``). Its warm-up is one
        decode step over a scratch state whose every slot is inactive: the
        live slots, their outputs and the engine's generator are untouched,
        and the pools get writes only at their trash rows. The warm-up is a
        decode step like any other to the counts (``decode_steps``, the
        fused-sampler steps, kernel launches): one for each of
        ``graph_captures``."""
        n_steps, W, wb, _, with_topk = key
        table = self._table_dev[:, :W]
        warp_rows = self._warp_dev[:wb] if wb else None

        def warm_up():
            self._chunk_body(self._scratch_state(), self._scratch_gen(), 1,
                             table, warp_rows, with_topk,
                             torch.empty_like(self._flags_dev))
            self._count_steps(1, with_topk, 0)

        prog, seconds = self._capture(
            functools.partial(
                self._chunk_body, self.state, self._gen, n_steps, table,
                warp_rows, with_topk, self._flags_dev,
            ),
            warm_up, generator=self._gen,
        )
        if prog.graph is not None:
            self.stats["graph_captures"] += 1
            self.stats["graph_capture_s"] += seconds
        return prog

    def _build_spec(self, key: tuple) -> _Program:
        """The spec chunk program of ``key``, as :meth:`_build_program`
        builds a decode chunk's: one eager warm-up spec step over a scratch
        state with no active slot (a spec step like any other to the
        counts: ``spec_steps``, kernel launches), then the capture. Its
        per-step counts land in the program's static ``aux``."""
        n_steps, W, wb, K, fused = key
        table = self._table_dev[:, :W]
        warp_rows = self._warp_dev[:wb] if wb else None
        aux = torch.zeros((3, n_steps, self.B), dtype=torch.float32,
                          device=self.device)

        def warm_up():
            self._spec_chunk_body(
                self._scratch_state(), self._scratch_gen(), 1, K, table,
                warp_rows, fused, torch.empty_like(self._flags_dev),
                torch.empty_like(aux[:, :1]))
            self._count_spec_steps(1, fused, 0)

        prog, seconds = self._capture(
            functools.partial(
                self._spec_chunk_body, self.state, self._gen, n_steps, K,
                table, warp_rows, fused, self._flags_dev, aux,
            ),
            warm_up, generator=self._gen,
        )
        prog.aux = aux
        if prog.graph is not None:
            self.stats["spec_captures"] += 1
            self.stats["graph_capture_s"] += seconds
        return prog

    def _scratch_state(self) -> GenState:
        """A warm-up's state: every slot inactive, over the engine's pools
        (it writes only their trash rows)."""
        return self._make_state(self.state.cache, 1, self.state.draft_cache)

    def _scratch_gen(self) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        return gen

    def _count_steps(self, n_steps: int, with_topk: bool, n_fallback: int):
        self.stats["decode_steps"] += n_steps
        if self.fused:
            self.stats["fused_sample_steps"] += n_steps
            self.stats["fused_topk_steps"] += n_steps * with_topk
            self.stats["sampler_fallback_rows"] += n_fallback * n_steps
            metrics_mod.counters.add(metrics_mod.GEN_FUSED_SAMPLE_STEPS,
                                     n_steps)
            if n_fallback:
                metrics_mod.counters.add(
                    metrics_mod.GEN_SAMPLER_FALLBACK_ROWS,
                    n_fallback * n_steps)

    def _count_spec_steps(self, n_steps: int, fused: bool, n_fallback: int):
        self.stats["spec_steps"] += n_steps
        if fused:
            self.stats["spec_fused_steps"] += n_steps
            self.stats["sampler_fallback_rows"] += n_fallback * n_steps
            if n_fallback:
                metrics_mod.counters.add(
                    metrics_mod.GEN_SAMPLER_FALLBACK_ROWS,
                    n_fallback * n_steps)

    def _chunk_key(self, decode_steps: int, running: List[int]):
        """``(spec, key, warp_slots, tok_bound)`` for the resident slots:
        whether the chunk is a spec chunk (``self.spec``, read once here
        under the engine lock), its program key, the slots whose sampling
        takes the sorted (warp-row) path, and the most tokens the chunk can
        advance a slot (``decode_steps * (K+1)`` for a spec chunk). Under
        the fused sampler a vanilla chunk narrows the warp bucket to the
        slots the online pass cannot serve (plain top-k slots ride the
        online buffer); the fused spec acceptance has no top-k buffer, so
        it keeps the full bucket, and a draft-model (general-q) engine
        verifies through the materialized path. The table width covers the
        tokens of this chunk and, pipelined, of the one still in flight
        (``_lens_host`` is a chunk stale then)."""
        spec = self.spec
        if spec or not self.fused:
            mirror = self._warp_host
        else:
            mirror = self._fused_warp_host
        warp_slots = [b for b in running if mirror[b]]
        tok_bound = decode_steps * ((self.spec_k + 1) if spec else 1)
        W = self._table_width(
            int(self._lens_host[running].max()) + self._steps_ahead
            + tok_bound
        )
        wb = self._warp_bucket(len(warp_slots))
        if spec:
            key = (decode_steps, W, wb, self.spec_k,
                   self.fused and self._draft is None)
        else:
            with_topk = self.fused and any(
                self._fused_topk_host[b] for b in running
            )
            key = (decode_steps, W, wb, self.fused, bool(with_topk))
        return spec, key, warp_slots, tok_bound

    def _dispatch(self, spec: bool, key: tuple, warp_slots: List[int],
                  running: List[int], prefill: List[tuple],
                  tok_bound: int) -> _InFlight:
        """Run one chunk (spec or vanilla) and START its harvest-flag copy
        to the host in the same breath, right behind it on the stream (the
        next run overwrites the static flags), with a spec chunk's aux.
        The table and warp rows go to their static device buffers through
        this chunk's host staging buffers, which the chunk that used them
        two dispatches ago has released."""
        prog = self._program(spec, key)   # a first use captures, timed apart
        io = self._io[self._n_dispatched % 2]
        self._n_dispatched += 1
        if io.done is not None:
            io.done.synchronize()
        io.table.copy_(torch.from_numpy(self._table_host))
        io.warp.fill_(self.B)
        if warp_slots:
            io.warp[: len(warp_slots)] = torch.tensor(warp_slots)
        self._table_dev.copy_(io.table, non_blocking=True)
        self._warp_dev.copy_(io.warp, non_blocking=True)
        t_start = self._clock.mark()
        prog.run()
        t_end = self._clock.mark()
        io.flags.copy_(self._flags_dev, non_blocking=True)
        if prog.aux is not None:
            if io.aux is None or io.aux.shape != prog.aux.shape:
                io.aux = torch.empty(prog.aux.shape, dtype=torch.float32,
                                     pin_memory=self.device.type == "cuda")
            io.aux.copy_(prog.aux, non_blocking=True)
        if prog.graph is not None:
            io.done = torch.cuda.Event()
            io.done.record()
            self.stats["spec_replays" if spec else "graph_replays"] += 1
            for mod, n in prog.launches.items():
                mod.credit(n)
        if spec:
            self._count_spec_steps(key[0], key[4], len(warp_slots))
        else:
            self._count_steps(key[0], key[4], len(warp_slots))
        return _InFlight(
            io=io, decode=(t_start, t_end), prefill=prefill,
            running=tuple((b, int(self._slot_epoch[b])) for b in running),
            spec=spec, advance=tok_bound,
        )

    def _resolve(self, inflight: _InFlight) -> np.ndarray:
        """The chunk's harvest flags ``[4, B]`` on the host, once its copy
        is done (pipelined, the host dispatched the next chunk meanwhile);
        a spec chunk's counts are folded into the stats. Counts every
        fetch, and in ``chunk_flag_blocked`` every one that still had to
        wait for the card."""
        self.stats["chunk_flag_fetches"] += 1
        metrics_mod.counters.add(metrics_mod.GEN_CHUNK_FLAG_FETCHES)
        done = inflight.io.done
        if done is not None:
            if not done.query():
                self.stats["chunk_flag_blocked"] += 1
                metrics_mod.counters.add(metrics_mod.GEN_CHUNK_FLAG_BLOCKED)
            done.synchronize()
        seconds = self._clock.seconds(*inflight.decode)
        self.stats["decode_s"] += seconds
        for span in inflight.prefill:
            self.stats["prefill_s"] += self._clock.seconds(*span)
        if inflight.spec:
            self.stats["spec_s"] += seconds
            self._fold_spec_stats(inflight.io.aux.numpy())
        return inflight.io.flags.numpy().copy()

    def _fold_spec_stats(self, aux: np.ndarray):
        """Fold one spec chunk's ``[3, n_steps, B]`` counts (drafted,
        accepted, mean accept probability) into the stats, the
        accept-length histogram and, with adaptive K, its window: host
        arithmetic on the copy the chunk's resolve already waited for."""
        drafted, accepted = aux[0], aux[1]
        d = int(drafted.sum())
        if d == 0:
            return
        live = drafted > 0
        acc = accepted[live].astype(np.int64)
        self.stats["spec_draft_tokens"] += d
        self.stats["spec_accepted_tokens"] += int(acc.sum())
        metrics_mod.counters.add(metrics_mod.GEN_SPEC_DRAFT_TOKENS, d)
        metrics_mod.counters.add(metrics_mod.GEN_SPEC_ACCEPTED_TOKENS,
                                 int(acc.sum()))
        for v, c in zip(*np.unique(acc, return_counts=True)):
            self.spec_accept_hist[int(v)] = (
                self.spec_accept_hist.get(int(v), 0) + int(c))
            metrics_mod.counters.observe(metrics_mod.GEN_SPEC_ACCEPT_LEN,
                                         float(v), n=int(c))
        if self._draft is not None:
            q_acc = aux[2][live]
            self.stats["spec_q_accept_prob_sum"] += float(q_acc.sum())
            self.stats["spec_q_accept_prob_n"] += int(q_acc.size)
        if self.spec_k_adapt:
            self._accept_window.extend(acc.astype(np.float64).tolist())
            self._maybe_adapt_spec_k()

    def _maybe_adapt_spec_k(self):
        """Retune ``spec_k`` from the windowed mean accept length (under
        the engine lock, so the next ``_chunk_key`` sees the new K). K
        moves ONE step within ``_spec_k_choices``, keeping spec programs
        bounded by the choice set; the UP/DOWN hysteresis band keeps a
        workload at a boundary from thrashing between two programs. The
        window resets on every retune, so the new K is judged on its own
        accept lengths."""
        if len(self._accept_window) < self.SPEC_K_ADAPT_WINDOW:
            return
        window = self._accept_window[-self.SPEC_K_ADAPT_WINDOW:]
        mean_acc = sum(window) / len(window)
        i = self._spec_k_choices.index(self.spec_k)
        new_k = self.spec_k
        if (mean_acc >= self.SPEC_K_ADAPT_UP * self.spec_k
                and i + 1 < len(self._spec_k_choices)):
            new_k = self._spec_k_choices[i + 1]
        elif mean_acc <= self.SPEC_K_ADAPT_DOWN * self.spec_k and i > 0:
            new_k = self._spec_k_choices[i - 1]
        if new_k != self.spec_k:
            logger.info("adaptive spec-K: %d -> %d (windowed mean accept "
                        "%.2f)", self.spec_k, new_k, mean_acc)
            self.spec_k = new_k
            self._accept_window.clear()
            metrics_mod.counters.gauge(metrics_mod.GEN_SPEC_K_CURRENT,
                                       float(new_k))
        else:
            del self._accept_window[: -self.SPEC_K_ADAPT_WINDOW]

    def _pull_outputs(self) -> dict:
        """ONE device pull of every slot's accumulated outputs + flags."""
        st = self.state
        flags = torch.stack(
            [st.n_gen, st.active.int(), st.max_gen]
        ).cpu().numpy()
        return {
            "n_gen": flags[0], "active": flags[1].astype(bool),
            "max_gen": flags[2],
            "out_tokens": st.out_tokens.cpu().numpy(),
            "out_logprobs": st.out_logprobs.cpu().numpy(),
        }

    def _release_slot(self, b: int) -> _SlotInfo:
        info = self._slots[b]
        self._slots[b] = None
        self.pool.release(info.pages)
        if info.borrowed:
            self.pool.release(info.borrowed)
        self._table_host[b] = 0
        self._lens_host[b] = 0
        self._warp_host[b] = False
        self._fused_warp_host[b] = False
        self._fused_topk_host[b] = False
        with self._pending_lock:
            self._req_meta.pop(info.rid, None)
        return info

    def _cache_output_pages(self, b: int, out_ids: List[int]):
        """Register slot ``b``'s full pages past its prompt in the prefix
        cache before they are released: a chunked rollout resubmits
        ``prompt + output`` (partial rollout, interrupted requests), and
        its admission then borrows every page whose KV this slot wrote
        instead of prefilling it again. KV exists for every position but
        the last output token's. A slot that ran across a weight update
        holds KV of the old weights and caches nothing, and neither does an
        engine without the prefix cache."""
        if not self.enable_prefix_cache or not out_ids or (
                self._slots[b].n_updates != self._n_updates):
            return
        with self._pending_lock:
            req = self._req_meta.get(self._slots[b].rid)
        if req is None:
            return
        ids = list(req.input_ids) + out_ids
        n_full = (len(ids) - 1) // self.page
        if n_full > (len(req.input_ids) - 1) // self.page:
            self.prefix.insert(ids, self._table_host[b][:n_full].tolist())

    def _harvest(self, b: int, reason: str, host_state: dict) -> GenOutput:
        """Release slot ``b`` and build its output from a host snapshot."""
        n = int(host_state["n_gen"][b])
        out_ids = host_state["out_tokens"][b, :n].tolist()
        self._cache_output_pages(b, out_ids)
        info = self._release_slot(b)
        return GenOutput(
            rid=info.rid,
            output_ids=out_ids,
            output_logprobs=host_state["out_logprobs"][b, :n].tolist(),
            finish_reason=reason,
            version=self.version,
        )

    def step(self, decode_steps: int = 16) -> List[GenOutput]:
        """Admit pending requests, run one decode chunk, harvest finished.

        Pipelined (``pipeline_chunks`` / ``AREAL_DECODE_PIPELINE``): chunk
        k+1 is dispatched first, then chunk k's flags (copied to the host
        while k and k+1 ran) are read and its finishes harvested, one
        chunk late. Output pulls for finished slots still read the current
        state, so a harvest-bearing step waits like the unpipelined one."""
        with self._lock:
            if self.paused:
                return []
            # batch-level chunk span on the engine thread: it roots its own
            # trace (a request's hops join at submit) and times the host's
            # dispatch and harvest, not the device's work
            with tracing.span("gen_engine/chunk", steps=decode_steps) as attrs:
                if self.pipeline:
                    return self._step_pipelined(decode_steps)
                inflight = self._admit_and_dispatch(decode_steps)
                if inflight is None:
                    return []
                attrs["slots"] = len(inflight.running)
                return self._harvest_chunk(inflight)

    def _step_pipelined(self, decode_steps: int) -> List[GenOutput]:
        new = self._admit_and_dispatch(decode_steps)
        prev, self._inflight = self._inflight, new
        self._steps_ahead = new.advance if new is not None else 0
        if prev is None:
            return []
        return self._harvest_chunk(prev)

    def _admit_and_dispatch(self, decode_steps: int) -> Optional[_InFlight]:
        self._spans = []
        self._span_open()
        admitted = self._admit_pending()
        self._span_close()
        if self.n_running() == 0:
            return None
        running = [b for b, s in enumerate(self._slots) if s is not None]
        spec, key, warp_slots, tok_bound = self._chunk_key(decode_steps,
                                                           running)
        self._observe_occupancy()
        return self._dispatch(spec, key, warp_slots, running,
                              self._spans if admitted else [], tok_bound)

    def _harvest_chunk(self, inflight: _InFlight) -> List[GenOutput]:
        """Harvest the slots a resolved chunk finished. Its flags may be a
        chunk stale (pipelined): a slot that turned over since its dispatch
        (released, or re-admitted at a newer epoch) is skipped."""
        active, n_gen, max_gen, lens = self._resolve(inflight)
        same = [
            b for b, ep in inflight.running
            if self._slots[b] is not None and self._slot_epoch[b] == ep
        ]
        for b in same:      # not fresh admissions: their lens is live
            self._lens_host[b] = lens[b]
        finished = [b for b in same if not active[b]]
        if not finished:
            return []
        # one pull of the current state serves every finished slot: the
        # chunk already deactivated them on the device, and they stayed
        # inactive through any chunk dispatched since
        host_state = self._pull_outputs()
        return [
            self._harvest(b, _finish_reason(n_gen[b], max_gen[b]),
                          host_state=host_state)
            for b in finished
        ]

    def run_until_done(self, decode_steps: int = 16, timeout: float = 600.0):
        """Convenience loop: run until every submitted request finished."""
        outs = []
        t0 = time.time()
        while True:
            with self._lock:
                busy = (
                    self._pending or self.n_running() or self.has_inflight
                ) and not self.paused
            if not busy:
                break
            outs.extend(self.step(decode_steps))
            if time.time() - t0 > timeout:
                raise TimeoutError("generation did not finish in time")
        return outs
