#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``areal_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one JSON line:

1. ``build``: builds every CUDA kernel from ``areal_tpu_torch/csrc`` with
   nvcc (one process per source, all started together).
2. ``kernels``: calls each kernel's wrapper on the card and holds it
   against its plain PyTorch version on the same inputs, timing the
   kernel, the plain version and one PyTorch library call with CUDA
   events beside the least time the card could take.
   - paged decode, at the slice shape (B 64, Hq 12, Hkv 2, D 128, page
     128, table width 16, L 28, lens over [0, 2047]) and at the serve
     phase's own shape (B 32, lens 1024-1151 in four groups of 8) in bf16
     and int8 (timed), one 2047-token slot among 63 empty ones, splits of
     3 pages, and at small shapes in f32 and bf16 with soft cap, sliding
     window, GQA groups of 1, 6 and 8, a narrowed table, D 40 and 48 and
     splits of 2 and 3 pages, D 256 (f32: one staging buffer), and V
     scales of ~1e-5 over long slots; each case is held against the plain
     version and against its mirror of the kernel's split arithmetic
     (``decode_plain(pages_per_split=)``), launched twice (the results
     must be bit-identical), and the merge's arrival counters must read 0
     afterwards; timed as CUDA-event time of eager calls (the kernel rows'
     yardstick) and as device time in a CUDA graph, beside the wrapper's
     host time; library: SDPA over K/V already gathered dense (the gather
     is not timed), both ways.
   - fused LM-head sampler, at the serving path's shape (R 32, E 1536,
     V 151936, bf16, half the rows greedy, temperatures 0.7 / 1 / 1.3)
     and at small shapes in f32 and bf16 with soft cap, V 500 / 50257 /
     5000 (not multiples of the tile), R 1 / 33 / 160, excluded and
     gathered tokens, E 70 and 200 and a tied (E-contiguous) head; bf16
     cases run both versions of the product (tensor cores where the layout
     allows, CUDA cores); 20000 draws at V 16 against softmax(warped) by
     chi-square; library: the head GEMM (cuBLAS) + sample_tokens over the
     materialized logits.
   - flash attention forward and backward (dq, dk, dv), at the trainer's
     shape (T 8192, H 12, Hkv 2, D 128, bf16, 8 segments of 512-1536
     tokens plus tail padding), at SyncGenerator's prefill (32 rows of 512
     and 33 of 64, one whole segment a row; the plain version segment by
     segment, no SDPA) and at small shapes in f32 and bf16 with
     soft cap, sliding window, GQA groups of 1, 6, 8 and 16, D 64 and 256
     (bf16 with D 64 or 128 runs the v4 tensor-core kernels, the rest the
     CUDA-core ones), one segment of 4096 tokens (the dk/dv kernel's
     longest walk), single-token segments, T that is a multiple of no tile
     and all-padding tail rows; every case is launched twice (bit-identical
     results) and the dk/dv merge's arrival counters must read 0
     afterwards; library: PyTorch's varlen flash attention over the real
     tokens (FA2; ``torch.nn.attention.varlen.varlen_attn`` where the
     installed torch has it, else ``aten._flash_attention_forward``) and
     SDPA with an explicit [T, T] segment-causal boolean mask (which does
     every pair of the [T, T] square, ~16x the pairs the mask keeps at the
     trainer's shape), forward and backward.
3. ``parity``: a tiny float32 model served by the engine on the card
   (admitting and decoding from CUDA graphs, unpipelined and pipelined)
   and on the CPU (eagerly) must give the same greedy tokens, plain and
   fused sampler, over staggered arrivals (three bursts while decoding:
   prefix hits, a partial hit, prompts of several 16-token waves); on
   the card every admission wave and commit must be a graph replay or
   its key's first use.
4. ``serve``: the engine at the full width of the R1-Distill-Qwen-1.5B
   profile (28 layers, random weights from a seed, bf16) behind the
   port's HTTP server answers 32 concurrent /generate requests (4 prompts
   of 1024 tokens, 8 requests each, greedy / temperature 1 / top-p 0.9),
   queued while the server is paused and admitted together; every answer
   is checked, the prefix cache must have been hit, the paged-decode
   launch count must equal layers x decode steps, and every chunk must
   have replayed a captured CUDA graph: replays x 16 + warm-up steps (one
   per capture) = decode steps. Admission alike: extend and commit
   replays + captures (one eager warm-up wave each) = waves, over exactly
   the extend keys ``(n_rows, width, skip_pool)`` and commit buckets the
   traffic implies (``extend_keys``). Then ``/generate_stream``: a
   greedy request's deltas must equal its ``/generate`` twin's answer,
   and a client that hangs up after the first frame must free its slot.
   ``--profile`` also holds the profiler's own count of paged-decode
   kernels to layers x decode steps and reports the card's busy share.
5. ``serve_fused``: ``serve`` with the fused sampler (two fused engines
   with one seed must draw the same tokens first); ``serve_int8``: with an
   int8 KV pool and 8 requests; ``serve_pipelined``: ``serve`` with
   pipelined chunks, whose greedy tokens must equal ``serve``'s. A
   ``weight_sync`` phase reloads a trainer's export into a running server
   and checks that the replayed graphs decode with the new weights and
   that admission after the update replays extend graphs captured before
   it, with greedy tokens equal to a fresh engine's on the new weights.
6. ``async_rollout``: AReaL's async loop closed once at the 1.5B profile's
   widths (full depth where two f32 exports fit on the disk, else cut
   only as far as they do): a bf16 server behind the gserver manager
   (staleness window 4, batch 8), one rollout worker with the math agent
   over 64 prompts of 512 tokens in groups of 4, 512 new tokens in
   chunks of 256, and the trainer worker (``AsyncPPOTrainerWorker``) of
   an f32-master trainer (same seed-0 weights): one ``run_step`` pulls
   the first 8 groups into its staleness-ordered buffer, runs the PPO
   graph (actor_inf -> actor_train), bumps ``training_samples`` and
   publishes its HF export while rollouts run; the manager flushes to
   version 1 and the interrupted rollouts finish at version 1. Checks
   trajectory shapes, the gate (a staleness denial before the step,
   running groups within the window), the update (versions,
   interruptions, a trajectory spanning 0 -> 1), the worker's records
   (step 1, ``training_samples`` 8, ``model_version`` ``1:<path>`` of a
   committed export, one finite ``metrics.jsonl`` line, the graph's
   levels), rollout-vs-trainer logprobs (0.1), finite PPO stats, no drop
   or failure, and the launch counts (paged decode = layers x steps,
   replays x 16 + captures = steps, flash = layers x micro-batches).
6b. ``async_ppo``: the port's own entry point, ``python -m
   areal_tpu_torch.apps.main async-ppo`` with dotted overrides, at the
   1.5B widths (full depth where seven f32 exports fit on the disk): the
   generation server and the trainer as two CUDA processes on the card,
   the manager and one rollout worker on the host, the same traffic as
   ``async_rollout``, two trainer steps with a weight publish after each
   and a committed recover checkpoint at step 2. Checks exit code 0,
   every process gone, two finite ``metrics.jsonl`` lines, weight-sync
   dirs v1 and v2, the server's metrics dump (version 2, replays x 16 +
   captures = decode steps = paged-decode launches / layers), the
   recover checkpoint (version 2, 16 groups consumed) and, loaded into a
   fresh trainer on the card, its params equal to the v2 export bit for
   bit. ``--keep-logs DIR`` keeps the run's log.
7. ``train_parity``: a tiny float32 model trained two SFT optimizer steps
   on the card and on the CPU from the same numpy params and batch; loss,
   grad norm and weights must agree.
8. ``train``: critic-free GRPO rounds of the PPO actor (decoupled loss,
   2 minibatches) at the 1.5B profile's full width (f32 master weights
   from seed 0, bf16 compute, full remat, chunked loss), 2 prompts x 8
   samples of 512 + 256-1024 tokens, micro-batches of 8192 tokens: each
   round runs inference (proximal logprobs) then train_step (two
   optimizer steps). A first round takes the one-time costs; the second
   is measured and counted. Stats must be finite, the weights must move,
   and the flash launch counts must equal layers x micro-batches (full
   remat re-runs each layer's forward in the backward). Prints trained
   tokens/s, seconds per optimizer step and peak memory; ``--profile``
   adds the busy share and device time by kernel over the second round.

9. ``sync_ppo``: sync PPO at the 1.5B profile's widths in this process
   (f32 master weights from seed 0, bf16 compute): first a tiny f32
   model's SyncGenerator greedy tokens on the card equal to the CPU's,
   and a tiny model with position-free logits sampled at temperature 1
   (one seed reproduces its tokens, another does not, the draws hold to
   softmax by chi-square and a row's replays draw fresh numbers: its
   consecutive tokens repeat only as often as independent draws do);
   then the SyncGenerator of an engine built by the launcher's
   ``_load_engine`` generates 8 prompts of 512 tokens x 4 samples, 256 new
   tokens at temperature 1, twice with two seeds: shapes, one CUDA graph
   captured for the key and none on the second call (replays + captures
   = decode steps), 28 flash forward launches per call (prefill), and
   ``gen_logprobs`` within 0.1 mean absolute error of the same tokens
   scored by a packed forward; every layer's flash output in prefill
   (this layout, and short prompts with a padding row) within FLASH_TOL
   of the plain version on that layer's q/k/v; then two ``SyncPPOTrainerWorker``
   ``run_step``s (a ref engine, the math reward, PPO with 4 minibatches)
   through the same generator with no new capture: finite stats, rewards
   in [-1, 1], 32 sequences a step, the step-2 HF export committed; then
   ``sft`` (3 steps and a save), ``rw`` (2 steps), ``sync-ppo`` (2 steps
   and a save) and ``profile --seqlens 1024x8 --n-steps 3`` through
   ``areal_tpu_torch.apps.main.main`` at 2 layers of the same widths on
   the card: each returns 0 with finite metrics lines and a finite MFU.
   Prints the generation's device time (prefill and decode), generated
   tokens/s, capture seconds, graph pool, seconds and trained tokens/s
   per step, peak memory and the profile's tokens/s, TFLOP/s and MFU.

Extra phases, run only when named: ``decode_time`` and ``flash_time``
time the paged-decode and flash kernels of the package imported (with
``--package DIR``, an earlier commit's) through their public signatures,
so that two versions compare in one call.

Then it prints the kernel table line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Any failed check raises: the
script exits non-zero without that last line. It needs a CUDA device and
the ``areal_tpu_torch`` package beside it; it imports nothing of JAX.
"""

import argparse
import json
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

PHASES = ("build", "kernels", "parity", "serve", "serve_fused", "serve_int8",
          "serve_pipelined", "weight_sync", "async_rollout", "async_ppo",
          "train_parity", "train", "sync_ppo")
SOURCES = ("paged_decode", "flash_attention", "fused_sample")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, per type
# Tolerances, elementwise: |kernel - plain| <= atol + rtol * |plain|, as
# (atol, rtol) by the queries' dtype. f32: both sides are f32 end to end
# and differ only in summation order. bf16 queries (bf16 or int8 pool):
# both sides round the output to bf16, so they may differ by one bf16 ulp
# of the larger of the two (rtol 2^-7; atol covers the step where the two
# straddle a power of two, and outputs near zero). Inside, both round P to
# bf16 before PV over a bf16 pool, as the reference does; over an int8
# pool the plain version keeps P times the V scale in f32 and the kernel
# rounds it to f16 after a power-of-two rescale (11 significant bits).
# Cases with small V scales compare outputs divided by the power of two
# the scales and v_self were multiplied by (exact), so atol keeps its
# meaning. Output scale at the slice shape: q and K ~
# N(0, 1) give N(0, 1) scores, so a slot with n resident tokens outputs
# values of about sqrt(e / n), ~0.04 at the long slots and O(1) only at
# the short ones; the limit there is ~2.3e-3. On an H100 every difference
# was at most one output ulp: 0.0039 (bf16 pool, slice shape), 0.0020
# (int8 pool), 0.0078 at a value near 1 (soft cap and window), which is
# 0.82 of its limit.
TOL = {"float32": (1e-4, 0.0), "bfloat16": (2e-3, 2.0 ** -7)}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def cuda_ms(fn, iters):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters):
    """Host time (ms) per eager call, without waiting for the device: what
    a caller that only enqueues pays for the wrapper."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


def graph_ms(fns, reps=3):
    """Device time (ms) per call of a sequence of calls, captured once in a
    CUDA graph and replayed ``reps`` times: the host's enqueue cost (the
    wrapper's checks, ctypes) is left out, which event timing of eager
    calls cannot do once a kernel is faster than its wrapper."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns[:3]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * len(fns))
    del graph
    return ms


# --------------------------------------------------------------------------- #
# kernels
# --------------------------------------------------------------------------- #


def make_decode_inputs(torch, *, B, Hq, Hkv, D, page, W, L, dtype, quant,
                       lens, seed, table_pad=0, soft_cap=None, window=None,
                       v_unit=1.0):
    """Random decode operands on the card: pages in permuted order, each
    slot owning W pages; ``table_pad`` extra columns make the table a
    narrowed view with a wider row stride, as the engine passes it. An
    int8 pool's V scales and ``v_self`` are multiplied by ``v_unit`` (a
    power of two), which multiplies the output by it exactly."""
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    P = B * W
    qdt = getattr(torch, dtype)
    q = torch.randn(B, Hq, D, generator=g, device=dev).to(qdt)
    k_self = torch.randn(B, Hkv, D, generator=g, device=dev).to(qdt)
    v_self = torch.randn(B, Hkv, D, generator=g, device=dev).to(qdt)
    shape = (L, P, 2, Hkv, page, D)
    if quant:
        pages = torch.randint(-127, 128, shape, generator=g, device=dev,
                              dtype=torch.int8)
        scales = 0.002 + 0.02 * torch.rand(shape[:-1], generator=g,
                                           device=dev)
        scales[:, :, 1] *= v_unit
        v_self = v_self * v_unit
    else:
        pages = torch.randn(shape, generator=g, device=dev).to(qdt)
        scales = None
    perm = torch.randperm(P, generator=g, device=dev).to(torch.int32)
    full = torch.zeros(B, W + table_pad, dtype=torch.int32, device=dev)
    full[:, :W] = perm.view(B, W)
    table = full[:, :W]
    lens_t = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    return dict(q=q, k_self=k_self, v_self=v_self, pages=pages, layer=L - 1,
                table=table, lens=lens_t, scales=scales,
                soft_cap=soft_cap, sliding_window=window)


def decode_bound(torch, x):
    """Least time (ms) for one decode call on these inputs: bytes that
    must move (each resident K/V row, scale, q, self K/V, used table
    entries and lens read once, the output written once) over HBM
    bandwidth, vs the QK and PV flops over the peak for q's type."""
    q, pages, lens = x["q"], x["pages"], x["lens"].long()
    B, Hq, D = q.shape
    Hkv, page = pages.shape[3], pages.shape[4]
    tok = int(lens.sum())
    nbytes = tok * Hkv * D * 2 * pages.element_size()
    if x["scales"] is not None:
        nbytes += tok * Hkv * 2 * 4
    nbytes += (q.numel() * 2 + 2 * x["k_self"].numel()) * q.element_size()
    nbytes += int(((lens + page - 1) // page).sum()) * 4 + B * 4
    ops = 4 * (tok + B) * Hq * D
    dt = "float32" if q.dtype == torch.float32 else "bfloat16"
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dt]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def sdpa_call(torch, x):
    """One PyTorch library call computing the same function: SDPA over the
    slots' K/V already gathered dense (self token appended), masked."""
    import torch.nn.functional as F

    from areal_tpu_torch.ops.paged_attention import gather_dequant_pages

    q, lens = x["q"], x["lens"].long()
    k, v = gather_dequant_pages(x["pages"], x["table"], x["layer"], x["scales"])
    k = torch.cat([k, x["k_self"][:, None]], 1).transpose(1, 2).to(q.dtype)
    v = torch.cat([v, x["v_self"][:, None]], 1).transpose(1, 2).to(q.dtype)
    S = k.shape[2] - 1
    pos = torch.arange(S + 1, device=q.device)
    mask = (pos[None] < lens[:, None]) | (pos[None] == S)
    mask = mask[:, None, None, :]
    qq = q[:, :, None, :]
    Hq, Hkv = q.shape[1], k.shape[1]
    gqa = tuple(int(p) for p in torch.__version__.split(".")[:2]) >= (2, 5)
    if not gqa:
        k = k.repeat_interleave(Hq // Hkv, 1)
        v = v.repeat_interleave(Hq // Hkv, 1)
    kw = {"enable_gqa": True} if gqa else {}
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask,
                                                  **kw)


# the paged-decode kernel's timed shapes: the slice (64 slots, lens over
# [0, 2047], lens[0] == 0) and the serve phase's own (32 slots, 4 GRPO
# groups of 8 equal lens)
DECODE_SLICE = dict(B=64, Hq=12, Hkv=2, D=128, page=128, W=16, L=28,
                    lens=np.linspace(0, 2047, 64).astype(np.int64))
DECODE_SERVE = dict(DECODE_SLICE, B=32, lens=np.repeat(
    np.linspace(1024, 1151, 4).astype(np.int64), 8))


def decode_calls(torch, cuda_paged, x, pps, n):
    """``n`` kernel calls on ``x``'s operands, layer by layer through the
    pool (wrapping around)."""
    a = (x["q"], x["k_self"], x["v_self"], x["pages"])
    kw = dict(soft_cap=x["soft_cap"], sliding_window=x["sliding_window"],
              scales=x["scales"])
    if pps is not None:
        kw["pages_per_split"] = pps
    n_layers = x["pages"].shape[0]
    return [lambda i=i: cuda_paged.decode(*a, i % n_layers, x["table"],
                                           x["lens"], **kw)
            for i in range(n)]


def time_decode(torch, x, launch, calls):
    """The timed paged-decode numbers on ``x``: ``kernel_ms``, CUDA events
    around 50 eager calls on the same inputs (the yardstick of every
    kernel row; the wrapper's host time is inside it once the kernel is
    the shorter of the two); ``device_ms``, the device time of
    ``calls`` (calls walking the pool's layers) captured in a CUDA graph;
    ``host_ms``, the wrapper's host time alone; the library call (SDPA over
    K/V gathered before timing) both ways, ``library_device_ms`` over four
    layers' K/V in turn so that each call, like the kernel's, finds its
    K/V cold in L2; and the bound."""
    row = {"kernel_ms": cuda_ms(launch, 50),
           "device_ms": graph_ms(calls),
           "host_ms": host_ms(launch, 50),
           "library_ms": cuda_ms(sdpa_call(torch, x), 20)}
    n_layers = min(4, x["pages"].shape[0])
    sdpa = [sdpa_call(torch, dict(x, layer=x["layer"] - i))
            for i in range(n_layers)]
    row["library_device_ms"] = graph_ms(sdpa * (20 // n_layers))
    del sdpa
    row["bound_ms"], row["bound_by"] = decode_bound(torch, x)
    pages = x["pages"]
    row["kv_bytes"] = int(x["lens"].long().sum()) * pages.shape[3] \
        * pages.shape[5] * 2 * pages.element_size()
    return row


def kernels_phase(torch):
    from areal_tpu_torch.ops.cuda import paged_attention as cuda_paged
    from areal_tpu_torch.ops.paged_attention import decode_plain

    def kw(x):
        return dict(softmax_scale=None, soft_cap=x["soft_cap"],
                    sliding_window=x["sliding_window"], scales=x["scales"])

    def args(x):
        return (x["q"], x["k_self"], x["v_self"], x["pages"], x["layer"],
                x["table"], x["lens"])

    slice_shape, serve_shape = DECODE_SLICE, DECODE_SERVE
    one_long = dict(slice_shape, lens=[0] * 31 + [2047] + [0] * 32)
    small = dict(B=8, Hq=4, Hkv=2, D=64, page=16, W=8, L=2,
                 lens=[0, 1, 15, 16, 17, 64, 100, 127])
    # V scales of ~1e-5: P times the scale far below f16's normal range
    small_v = 2.0 ** -10
    # (name, inputs, timed, pages per split: None = the wrapper's default)
    cases = [
        ("slice_bf16", dict(slice_shape, dtype="bfloat16", quant=False), True,
         None),
        ("slice_int8", dict(slice_shape, dtype="bfloat16", quant=True), True,
         None),
        ("serve_bf16", dict(serve_shape, dtype="bfloat16", quant=False), True,
         None),
        ("serve_int8", dict(serve_shape, dtype="bfloat16", quant=True), True,
         None),
        ("one_long_bf16", dict(one_long, dtype="bfloat16", quant=False),
         False, None),
        ("one_long_int8", dict(one_long, dtype="bfloat16", quant=True),
         False, None),
        ("slice_bf16_split3", dict(slice_shape, dtype="bfloat16",
                                   quant=False), False, 3),
        ("f32", dict(small, dtype="float32", quant=False), False, None),
        ("f32_soft_cap", dict(small, dtype="float32", quant=False,
                              soft_cap=5.0), False, None),
        ("f32_window", dict(small, dtype="float32", quant=False,
                            window=20), False, None),
        ("f32_rep1", dict(small, Hq=2, dtype="float32", quant=False), False,
         None),
        ("f32_rep8", dict(small, Hq=16, dtype="float32", quant=False), False,
         None),
        ("f32_narrow_table", dict(small, dtype="float32", quant=False,
                                  table_pad=5), False, None),
        ("f32_int8_d48", dict(small, D=48, dtype="float32", quant=True),
         False, None),
        ("f32_split3_window", dict(small, dtype="float32", quant=False,
                                   window=40), False, 3),
        ("bf16_cap_window", dict(small, dtype="bfloat16", quant=False,
                                 soft_cap=30.0, window=40), False, None),
        ("bf16_int8_window", dict(small, dtype="bfloat16", quant=True,
                                  window=33), False, None),
        ("bf16_int8_split2_d64", dict(small, dtype="bfloat16", quant=True,
                                      table_pad=3), False, 2),
        ("bf16_d40_rep6", dict(small, Hq=12, D=40, dtype="bfloat16",
                               quant=False), False, None),
        ("slice_int8_small_v", dict(slice_shape, dtype="bfloat16",
                                    quant=True, v_unit=small_v), False, None),
        # D 256 (the kernels' widest instantiation); f32 stages one buffer
        ("bf16_d256_rep6", dict(small, Hq=12, D=256, dtype="bfloat16",
                                quant=False, window=40), False, None),
        ("bf16_int8_d256_rep4", dict(small, Hq=8, D=256, dtype="bfloat16",
                                     quant=True), False, 3),
        ("f32_d256_rep4", dict(small, Hq=8, D=256, dtype="float32",
                               quant=False), False, None),
        ("f32_d256_split3_cap", dict(small, Hq=8, D=256, dtype="float32",
                                     quant=False, soft_cap=5.0), False, 3),
    ]
    results = {}
    for i, (name, spec, timed, pps) in enumerate(cases):
        x = make_decode_inputs(torch, seed=100 + i, **spec)
        unit = spec.get("v_unit", 1.0)
        sp = cuda_paged.plan(x["table"].shape[1], x["pages"].shape[4], pps)

        def launch():
            return cuda_paged.decode(*args(x), **kw(x), pages_per_split=pps)

        got = launch()
        # the plain version in one pass, and its mirror of the kernel's
        # split arithmetic under the same plan
        wants = {"plain": decode_plain(*args(x), **kw(x)),
                 "split_mirror": decode_plain(
                     *args(x), **kw(x), pages_per_split=sp.pages_per_split)}
        torch.cuda.synchronize()
        atol, rtol = TOL[spec["dtype"]]
        row = {}
        for ref, want in wants.items():
            diff = (got.float() - want.float()).abs() / unit
            over = (diff / (atol + rtol * want.float().abs() / unit)).max()
            over, err = over.item(), diff.max().item()
            if not (np.isfinite(over) and over <= 1.0):
                raise AssertionError(
                    f"paged_decode {name}: |kernel - {ref}| reaches {over} x "
                    f"(atol {atol} + rtol {rtol} |{ref}|); max abs err {err}"
                )
            key = "" if ref == "plain" else ref + "_"
            row[key + "max_abs_err"] = err
            row[key + "err_over_tol"] = over
        want = wants["plain"]
        # the merge is deterministic and leaves its arrival counters at 0
        again = launch()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"paged_decode {name}: two launches on the "
                                 "same inputs differ")
        n_live = x["q"].shape[0] * x["pages"].shape[3]
        if int(cuda_paged.counters(got.device)[:n_live].abs().sum()) != 0:
            raise AssertionError(f"paged_decode {name}: arrival counters "
                                 "not 0 after a launch")
        row.update({"atol": atol, "rtol": rtol, "bit_identical_rerun": True,
                    "counters_zero": True, "pages_per_split":
                    sp.pages_per_split, "plain_rms":
                    (want.float() / unit).pow(2).mean().sqrt().item()})
        if unit != 1.0:
            row["compared_in_units_of"] = unit
        if timed:
            row.update(time_decode(torch, x, launch, decode_calls(
                torch, cuda_paged, x, pps, 56)))
            row["plain_ms"] = cuda_ms(
                lambda: decode_plain(*args(x), **kw(x)), 10
            )
        results[name] = row
        del x
    torch.cuda.empty_cache()
    emit(phase="kernels", kernel="paged_decode", cases=results)
    return results


def decode_time_phase(torch):
    """The timed paged-decode cases alone, through the wrapper's public
    signature only, so that the same script times any version of the
    package (``--package``): two versions compare in one call, on one
    yardstick. Each case is checked against the package's plain version
    first."""
    import hashlib
    import pathlib

    from areal_tpu_torch.ops.cuda import paged_attention as cuda_paged
    from areal_tpu_torch.ops.paged_attention import decode_plain

    src = pathlib.Path(cuda_paged.__file__).parents[2] / "csrc" / \
        "paged_decode.cu"
    rows = {}
    for i, (name, shape, quant) in enumerate((
            ("slice_bf16", DECODE_SLICE, False),
            ("slice_int8", DECODE_SLICE, True),
            ("serve_bf16", DECODE_SERVE, False),
            ("serve_int8", DECODE_SERVE, True))):
        x = make_decode_inputs(torch, seed=100 + i, dtype="bfloat16",
                               quant=quant, **shape)
        a = (x["q"], x["k_self"], x["v_self"], x["pages"], x["layer"],
             x["table"], x["lens"])

        def launch():
            return cuda_paged.decode(*a, scales=x["scales"])

        got, want = launch(), decode_plain(*a, scales=x["scales"])
        atol, rtol = TOL["bfloat16"]
        diff = (got.float() - want.float()).abs()
        over = (diff / (atol + rtol * want.float().abs())).max().item()
        if not (np.isfinite(over) and over <= 1.0):
            raise AssertionError(f"paged_decode {name}: {over} x its limit")
        rows[name] = dict(err_over_tol=over, **time_decode(
            torch, x, launch, decode_calls(torch, cuda_paged, x, None, 56)))
        del x
    torch.cuda.empty_cache()
    emit(phase="decode_time", package=str(src.parents[2]),
         source_sha256=hashlib.sha256(src.read_bytes()).hexdigest()[:16],
         cases=rows)


# --------------------------------------------------------------------------- #
# kernels: packed flash attention, forward and backward
# --------------------------------------------------------------------------- #

# Tolerances, |kernel - plain| against the plain version (autograd through
# ops/attention.py::attention_plain for the gradients). float32: elementwise
# atol + rtol*|plain|, both sides f32, summation order only (sums run over
# up to 384 keys or queries); on an H100 the worst case read 3.6e-5 at a
# value of 10.8 (dv, GQA 8). bfloat16: both sides round outputs to bf16 and
# round at different points inside (P before PV in both; the plain version
# also rounds dP, the kernel dS), so they differ by an output ulp or two: the
# largest difference must stay within 2 ulps of the tensor's largest element
# (2^-6 of its max magnitude) and the rms difference within 2^-6 of its rms.
# On an H100 the largest differences read 1 ulp (0.0156 at max 4.1 for out,
# 0.031 at max 7.5 / 12.1 for dk / dv at the slice shape).
FLASH_TOL = {"float32": ("elementwise", 1e-4, 1e-4),
             "bfloat16": ("normwise", 2.0 ** -6, 2.0 ** -6)}
SLICE_LENS = [512, 1536, 768, 1280, 640, 1024, 896, 1152]  # + 384 pad of 8192


def make_flash_inputs(torch, *, T, H, Hkv, D, lens, dtype, seed, **_):
    """Random attention operands on the card; segments packed from token 0
    (ids 1, 2, ...), padding (id 0) at the tail, as the packer lays them."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dt = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dt)

    seg = np.zeros(T, np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[off:off + n] = i + 1
        off += n
    return dict(q=randn(T, H, D), k=randn(T, Hkv, D), v=randn(T, Hkv, D),
                do=randn(T, H, D), seg=torch.from_numpy(seg).cuda(),
                seg_np=seg)


def flash_pairs(seg, window):
    """(query, key) pairs the segment-causal (windowed) mask keeps."""
    pairs = 0
    for sid in np.unique(seg[seg > 0]):
        n = int((seg == sid).sum())
        i = np.arange(n)
        pairs += int(np.minimum(i + 1, window or n).sum())
    return pairs


def flash_bound(torch, x, kw, backward):
    """Least time (ms) on the card: the larger of the bytes the call must
    move (each input read once, each output written once) over HBM
    bandwidth and its matrix-product operations over the peak for the
    inputs' type. Forward: QK^T and PV, 4 flops per kept pair, head and
    head-dim element; backward: five products (S recomputed, dP, dV, dK,
    dQ), 10 flops. The soft cap's tanh and the softmax are not counted."""
    q, k = x["q"], x["k"]
    T, H, D = q.shape
    es = q.element_size()
    pairs = flash_pairs(x["seg_np"], kw.get("sliding_window"))
    io = q.numel() + 2 * k.numel()            # q, k, v
    if backward:
        ops = 10 * pairs * H * D
        # q k v out dO read, lse read, dq dk dv written
        nbytes = (io + 2 * q.numel() + io) * es + H * T * 4 + T * 4
    else:
        ops = 4 * pairs * H * D
        nbytes = (io + q.numel()) * es + H * T * 4 + T * 4   # + out, lse
    dt = "float32" if q.dtype == torch.float32 else "bfloat16"
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dt]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def flash_sdpa(torch, x, kw):
    """The PyTorch library call for the same attention: SDPA with an
    explicit [T, T] segment-causal (windowed) boolean mask, K/V heads
    repeated to H beforehand; None with a soft cap (SDPA has none).
    Returns (forward, backward) callables."""
    import torch.nn.functional as F

    if kw.get("soft_cap") is not None:
        return None, None
    q, k, v, seg = x["q"], x["k"], x["v"], x["seg"]
    T, H, D = q.shape
    rep = H // k.shape[1]
    idx = torch.arange(T, device=q.device)
    mask = (seg[:, None] == seg[None, :]) & (seg[:, None] > 0)
    mask &= idx[:, None] >= idx[None, :]
    if kw.get("sliding_window"):
        mask &= idx[:, None] - idx[None, :] < kw["sliding_window"]
    mask = mask[None, None]

    def heads(t):
        return t.repeat_interleave(rep, 1) if t.shape[1] != H else t

    q4, k4, v4 = (heads(t).transpose(0, 1)[None].detach().requires_grad_(True)
                  for t in (q, k, v))
    scale = D ** -0.5

    def fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                              scale=scale)

    out = fwd()
    do4 = x["do"].transpose(0, 1)[None]

    def bwd():
        return torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True)

    return fwd, bwd


def flash_varlen(torch, x, kw):
    """PyTorch's own varlen flash attention (FA2) over the real tokens, the
    same packed segment-causal (windowed) function: ``torch.nn.attention.
    varlen.varlen_attn`` where the installed torch has it, else
    ``aten._flash_attention_forward`` / ``_backward``; K/V repeated to H
    where the call lacks GQA. Returns (forward, backward, call name), or
    (None, None, reason) where it cannot compute the function (a soft cap;
    f32, which FA2 does not take)."""
    import inspect

    if kw.get("soft_cap") is not None or x["q"].dtype != torch.bfloat16:
        return None, None, "no soft cap / f32 in FA2"
    seg = x["seg_np"]
    n = int((seg > 0).sum())
    lens = np.bincount(seg[:n])[1:]
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]), dtype=torch.int32,
                      device="cuda")
    max_len = int(lens.max())
    q, k, v = (x[name][:n].detach() for name in ("q", "k", "v"))
    do = x["do"][:n]
    H, D = q.shape[1:]
    rep = H // k.shape[1]
    window = kw.get("sliding_window")
    scale = D ** -0.5
    try:
        from torch.nn.attention.varlen import varlen_attn
    except ImportError:
        varlen_attn = None
    if varlen_attn is not None:
        params = inspect.signature(varlen_attn).parameters
        opts = {"scale": scale}
        if "window_size" in params:
            opts["window_size"] = (window - 1 if window else -1, 0)
        elif window:
            return None, None, "varlen_attn without window_size"
        else:
            opts["is_causal"] = True
        if "enable_gqa" in params:
            opts["enable_gqa"] = True
        else:
            k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))

        def fwd():
            return varlen_attn(q, k, v, cu, cu, max_len, max_len, **opts)
        name = "torch.nn.attention.varlen.varlen_attn"
    else:
        k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        wl = window - 1 if window else -1

        def fwd():
            return torch.ops.aten._flash_attention_forward(
                q, k, v, cu, cu, max_len, max_len, 0.0, True, False,
                scale=scale, window_size_left=wl, window_size_right=0)[0]
        name = "aten._flash_attention_forward"
    try:
        out = fwd()
    except RuntimeError as e:  # a build of torch without this path
        return None, None, f"{name} failed: {str(e)[:160]}"

    def bwd():
        return torch.autograd.grad(out, (q, k, v), do, retain_graph=True)

    return fwd, bwd, name


def flash_compare(torch, got, want, dtype):
    """(max abs err, err / limit) under FLASH_TOL; raises past the limit."""
    mode, a, r = FLASH_TOL[dtype]
    diff = (got.float() - want.float()).abs()
    if mode == "elementwise":
        over = (diff / (a + r * want.float().abs())).max().item()
    else:
        over = max(diff.max().item() / (a * want.float().abs().max().item()),
                   diff.pow(2).mean().sqrt().item()
                   / (r * want.float().pow(2).mean().sqrt().item()))
    return diff.max().item(), over


def plain_slices(seg, limit):
    """``(start, end)`` token ranges of at most ``limit`` tokens (a longer
    segment alone) that cut ``seg`` only between segments: no query
    attends across a cut, so the plain version over each range is the
    plain version over the whole, without its ``[T, T]`` scores."""
    cuts = np.flatnonzero(np.diff(seg)) + 1
    edges = np.concatenate([[0], cuts, [len(seg)]])
    out, a = [], 0
    for e0, e1 in zip(edges[:-1], edges[1:]):
        if e1 - a > limit and e0 > a:
            out.append((a, int(e0)))
            a = int(e0)
    out.append((a, len(seg)))
    return out


def flash_plain_sliced(torch, q, k, v, seg, seg_np, scale, kw, limit, do=None):
    """The plain version (``attention_plain``) over ``plain_slices``:
    ``(out, lse)``, plus ``(dq, dk, dv)`` for the cotangent ``do``."""
    from areal_tpu_torch.ops.attention import attention_plain

    outs, lses, grads = [], [], ([], [], [])
    for a, b in plain_slices(seg_np, limit):
        qs, ks, vs = (t[a:b].detach().requires_grad_(do is not None)
                      for t in (q, k, v))
        with torch.set_grad_enabled(do is not None):
            o, lse = attention_plain(qs, ks, vs, seg[a:b], scale,
                                     kw.get("soft_cap"),
                                     kw.get("sliding_window"))
        if do is not None:
            for acc, g in zip(grads, torch.autograd.grad(o, (qs, ks, vs),
                                                         do[a:b])):
                acc.append(g)
        outs.append(o.detach())
        lses.append(lse.detach())
    out, lse = torch.cat(outs), torch.cat(lses, 1)
    if do is None:
        return out, lse
    return out, lse, tuple(torch.cat(g) for g in grads)


def flash_kernels_phase(torch):
    from areal_tpu_torch.ops.attention import attention_plain
    from areal_tpu_torch.ops.cuda import flash_attention as cuda_flash

    slice_shape = dict(T=8192, H=12, Hkv=2, D=128, lens=SLICE_LENS)
    small = dict(T=384, H=4, Hkv=2, D=64, lens=[100, 156, 60])
    # bf16 at D 64 / 128 runs the v4 kernels: GQA 6 with cap and window at D
    # 64, GQA 16, one 4096-token segment (the dk/dv kernel's longest walk),
    # single-token segments, and T a multiple of no tile
    v4 = dict(T=501, H=6, Hkv=1, D=64, lens=[300, 150], dtype="bfloat16")
    cases = [
        ("bf16_rep6_d64_cap_window", v4, dict(soft_cap=30.0, sliding_window=100)),
        ("bf16_rep16_d128", dict(v4, T=700, H=16, D=128, lens=[700]), {}),
        ("bf16_seg4096", dict(slice_shape, T=4096, lens=[4096], dtype="bfloat16"),
         {}),
        ("bf16_single_tokens", dict(v4, T=333, H=2, Hkv=2, D=128,
                                    lens=[1, 1, 200, 1, 77]), {}),
        ("bf16_odd_t", dict(v4, T=1001, H=6, Hkv=2, D=128, lens=[333, 1, 500, 97]),
         dict(sliding_window=150)),
        ("slice_bf16", dict(slice_shape, dtype="bfloat16"), {}),
        # SyncGenerator's prefill: one segment per row of Sp tokens, a row's
        # padding tail and a padding row inside their segments (so every
        # row is a whole segment to the kernel), T = B * Sp: the sync_ppo
        # generation's 32 x 512, and 33 rows of the narrowest Sp (64), T a
        # multiple of no tile; the plain version segment by segment
        ("prefill_bf16", dict(slice_shape, T=32 * 512, lens=[512] * 32,
                              dtype="bfloat16", plain_slice=4096), {}),
        ("prefill_sp64_bf16", dict(slice_shape, T=33 * 64, lens=[64] * 33,
                                   dtype="bfloat16", plain_slice=512), {}),
        ("f32", dict(small, dtype="float32"), {}),
        ("f32_soft_cap", dict(small, dtype="float32"), dict(soft_cap=5.0)),
        ("f32_window", dict(small, dtype="float32"), dict(sliding_window=40)),
        ("f32_rep1", dict(small, H=2, lens=[300], dtype="float32"), {}),
        ("f32_rep8", dict(small, H=16, lens=[384], dtype="float32"), {}),
        ("f32_pad_tail", dict(small, lens=[100], dtype="float32"), {}),
        ("f32_d256", dict(small, T=200, Hkv=1, D=256, lens=[70, 90],
                          dtype="float32"), {}),
        ("bf16", dict(small, dtype="bfloat16"), {}),
        ("bf16_cap_window", dict(small, H=6, lens=[200, 100],
                                 dtype="bfloat16"),
         dict(soft_cap=30.0, sliding_window=64)),
        ("bf16_rep8", dict(small, H=16, lens=[384], dtype="bfloat16"), {}),
        # bf16 outside the tensor-core kernels' head dims (64, 128)
        ("bf16_d256", dict(small, T=200, Hkv=1, D=256, lens=[70, 90],
                           dtype="bfloat16"), {}),
    ]
    results = {}
    for i, (name, spec, kw) in enumerate(cases):
        x = make_flash_inputs(torch, seed=200 + i, **spec)
        q, k, v, seg, do = x["q"], x["k"], x["v"], x["seg"], x["do"]
        out, lse = cuda_flash.flash_forward(q, k, v, seg, **kw)
        dq, dk, dv = cuda_flash.flash_backward(q, k, v, seg, out, lse, do, **kw)
        torch.cuda.synchronize()
        # deterministic (the dk/dv parts merge in part order, no float
        # atomics), and the merge leaves its arrival counters at 0
        again = cuda_flash.flash_forward(q, k, v, seg, **kw)
        again += cuda_flash.flash_backward(q, k, v, seg, out, lse, do, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(again, (out, lse, dq, dk, dv))):
            raise AssertionError(f"flash {name}: two launches on the same inputs "
                                 "differ")
        if int(cuda_flash.counters(q.device).abs().sum()) != 0:
            raise AssertionError(f"flash {name}: arrival counters not 0 after "
                                 "a launch")
        del again
        sliced = spec.get("plain_slice")
        qp, kp, vp = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        if sliced:
            pout, plse, pgrads = flash_plain_sliced(
                torch, q, k, v, seg, x["seg_np"], spec["D"] ** -0.5, kw,
                sliced, do=do)
        else:
            pout, plse = attention_plain(qp, kp, vp, seg, spec["D"] ** -0.5,
                                         kw.get("soft_cap"),
                                         kw.get("sliding_window"))
            pgrads = torch.autograd.grad(pout, (qp, kp, vp), do,
                                         retain_graph=True)
        torch.cuda.synchronize()
        row = {"atol_or_rel": FLASH_TOL[spec["dtype"]][1],
               "rtol_or_rms": FLASH_TOL[spec["dtype"]][2],
               "mode": FLASH_TOL[spec["dtype"]][0],
               "bit_identical_rerun": True, "counters_zero": True,
               "plain_in_slices_of": sliced}
        live = seg > 0
        checks = [("out", out, pout), ("lse", lse[:, live], plse[:, live]),
                  ("dq", dq, pgrads[0]), ("dk", dk, pgrads[1]),
                  ("dv", dv, pgrads[2])]
        for part, got, want in checks:
            # lse is f32 on both sides whatever the inputs' type
            dt = "float32" if part == "lse" else spec["dtype"]
            err, over = flash_compare(torch, got, want, dt)
            if not (np.isfinite(over) and over <= 1.0):
                raise AssertionError(
                    f"flash {name} {part}: |kernel - plain| reaches {over} x "
                    f"its limit {FLASH_TOL[dt]}; max abs err {err}"
                )
            row[f"{part}_max_abs_err"] = err
            row[f"{part}_err_over_tol"] = over
        pad = ~live
        if not (bool((out[pad] == 0).all())
                and bool((lse[:, pad] == plse[:, pad]).all())
                and bool((dq[pad] == 0).all())):
            raise AssertionError(f"flash {name}: pad rows are not 0 / NEG_INF")
        row["fwd_max_abs_err"] = max(row["out_max_abs_err"],
                                     row["lse_max_abs_err"])
        row["bwd_max_abs_err"] = max(row[f"{p}_max_abs_err"]
                                     for p in ("dq", "dk", "dv"))
        slice_case = name == "slice_bf16"
        it = 10 if slice_case else 20
        row["fwd_ms"] = cuda_ms(
            lambda: cuda_flash.flash_forward(q, k, v, seg, **kw), it)
        row["bwd_ms"] = cuda_ms(
            lambda: cuda_flash.flash_backward(q, k, v, seg, out, lse, do, **kw),
            it)
        if sliced:
            # the sliced plain version's forward; its backward is timed
            # nowhere, and SDPA's [T, T] mask is left out alike
            row["plain_fwd_ms"] = cuda_ms(
                lambda: flash_plain_sliced(torch, q, k, v, seg, x["seg_np"],
                                           spec["D"] ** -0.5, kw, sliced), 3)
            row["plain_bwd_ms"] = None
        else:
            row["plain_fwd_ms"] = cuda_ms(
                lambda: attention_plain(q, k, v, seg, spec["D"] ** -0.5,
                                        kw.get("soft_cap"),
                                        kw.get("sliding_window")), 3)
            row["plain_bwd_ms"] = cuda_ms(
                lambda: torch.autograd.grad(pout, (qp, kp, vp), do,
                                            retain_graph=True), 3)
        del pout, plse, pgrads
        lib_fwd, lib_bwd = (None, None) if sliced else flash_sdpa(torch, x, kw)
        row["library_fwd_ms"] = cuda_ms(lib_fwd, it) if lib_fwd else None
        row["library_bwd_ms"] = cuda_ms(lib_bwd, it) if lib_bwd else None
        del lib_fwd, lib_bwd
        var_fwd, var_bwd, row["library_varlen_call"] = flash_varlen(torch, x, kw)
        row["library_varlen_fwd_ms"] = cuda_ms(var_fwd, it) if var_fwd else None
        row["library_varlen_bwd_ms"] = cuda_ms(var_bwd, it) if var_bwd else None
        del var_fwd, var_bwd
        row["fwd_bound_ms"], row["fwd_bound_by"] = flash_bound(torch, x, kw, False)
        row["bwd_bound_ms"], row["bwd_bound_by"] = flash_bound(torch, x, kw, True)
        row["pairs"] = flash_pairs(x["seg_np"], kw.get("sliding_window"))
        results[name] = row
        del x, q, k, v, seg, do, out, lse, dq, dk, dv, qp, kp, vp
        torch.cuda.empty_cache()
    emit(phase="kernels", kernel="flash_attention", cases=results)
    return results


def flash_time_phase(torch):
    """The slice-shape flash case alone, through the wrappers' public
    signature only, so that the same script times any version of the
    package (``--package``): two versions compare in one call, on one
    yardstick. Checked against the package's plain version first. Event
    time of eager calls as every kernel row, and device time summed over
    every kernel each wrapper launches (torch.profiler)."""
    import hashlib
    import pathlib

    from areal_tpu_torch.ops.attention import attention_plain
    from areal_tpu_torch.ops.cuda import flash_attention as cuda_flash

    src = pathlib.Path(cuda_flash.__file__).parents[2] / "csrc" / \
        "flash_attention.cu"
    x = make_flash_inputs(torch, seed=200, T=8192, H=12, Hkv=2, D=128,
                          lens=SLICE_LENS, dtype="bfloat16")
    q, k, v, seg, do = x["q"], x["k"], x["v"], x["seg"], x["do"]

    def fwd():
        return cuda_flash.flash_forward(q, k, v, seg)

    out, lse = fwd()

    def bwd():
        return cuda_flash.flash_backward(q, k, v, seg, out, lse, do)

    got = (out,) + bwd()
    qp, kp, vp = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    pout, _ = attention_plain(qp, kp, vp, seg, 128 ** -0.5)
    want = (pout,) + torch.autograd.grad(pout, (qp, kp, vp), do)
    row = {}
    for part, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        err, over = flash_compare(torch, a, b, "bfloat16")
        if not (np.isfinite(over) and over <= 1.0):
            raise AssertionError(f"flash_time {part}: {over} x its limit")
        row[f"{part}_err_over_tol"] = over
    del qp, kp, vp, pout, want, got
    row["fwd_ms"] = cuda_ms(fwd, 20)
    row["bwd_ms"] = cuda_ms(bwd, 20)
    for part, fn in (("fwd", fwd), ("bwd", bwd)):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        row[f"{part}_device_ms"] = sum(
            ev.device_time_total for ev in prof.key_averages()) / 10 / 1e3
        row[f"{part}_device_ms_by_kernel"] = {
            ev.key[:60]: ev.device_time_total / ev.count / 1e3
            for ev in prof.key_averages() if ev.device_time_total > 0}
    row["fwd_bound_ms"], _ = flash_bound(torch, x, {}, False)
    row["bwd_bound_ms"], _ = flash_bound(torch, x, {}, True)
    del x, q, k, v, seg, do, out, lse
    torch.cuda.empty_cache()
    emit(phase="flash_time", package=str(src.parents[2]),
         source_sha256=hashlib.sha256(src.read_bytes()).hexdigest()[:16],
         cases={"slice_bf16": row})


# --------------------------------------------------------------------------- #
# kernels: fused LM-head sampling epilogue
# --------------------------------------------------------------------------- #

# Limits, kernel against plain version (ops/fused_sample.py::
# fused_sample_plain) on the same CUDA inputs. Both sides accumulate the
# head product in float32 from the same f32 or bf16 operands (bf16 products
# are exact in f32), so they differ by summation order only: about 1e-6 of
# a logit. A row's limit is atol 1e-4 + rtol 1e-5 * |norm| of the plain
# version: a greedy row divides by the 1e-6 temperature floor, so its
# warped values, its norm and the two terms of its logprob are ~1e6, where
# one float32 ulp is 0.06 to 0.5. Within that limit: norm, gathered_lp and
# logprobs; argmax and sampled tokens must be EQUAL, except on a near tie:
# where they differ, the plain version's raw logits (perturbed values, for
# a sampled token) of the two candidates must lie within the row's limit.
# A sampled row's logprob must also equal warped[token] - norm recomputed
# from the plain version's full logits.
FUSED_ATOL, FUSED_RTOL = 1e-4, 1e-5
FUSED_TEMPS = (0.0, 0.7, 0.0, 1.0, 0.0, 1.3, 0.0, 1.0)   # half greedy


def make_fused_inputs(torch, *, R, E, V, dtype, seed, tied=False,
                      exclude=False, gather=False, soft_cap=None, **_):
    """Random epilogue operands on the card: final-norm-like hidden states
    ~N(0, 1) and a head ~N(0, 0.02), so logits have the serving path's
    scale; a tied head is ``embed.T``, a view with E contiguous."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dt = getattr(torch, dtype)
    x = torch.randn(R, E, generator=g, device="cuda").to(dt)
    if tied:
        w = (torch.randn(V, E, generator=g, device="cuda") * 0.02).to(dt).T
    else:
        w = (torch.randn(E, V, generator=g, device="cuda") * 0.02).to(dt)
    temp = torch.tensor([FUSED_TEMPS[i % len(FUSED_TEMPS)] for i in range(R)],
                        device="cuda")
    out = dict(seed=torch.tensor([seed * 7919 - 5], dtype=torch.int32,
                                 device="cuda"),
               x=x, w=w, temperature=temp, greedy=temp <= 0.0,
               exclude=None, gather_ids=None, soft_cap=soft_cap)
    if exclude:   # the likeliest token, so that the exclusion binds
        out["exclude"] = (x.float() @ w.float()).argmax(-1).to(torch.int32)
    if gather:
        out["gather_ids"] = torch.randint(0, V, (R,), generator=g,
                                          device="cuda", dtype=torch.int32)
    return out


def fused_bound(torch, a):
    """Least time (ms) for one call on these inputs: W and x read once
    (the per-row operands and outputs are a few hundred bytes) over HBM
    bandwidth, vs the product's 2 R E V flops over the peak for its type."""
    x, w = a["x"], a["w"]
    R, E = x.shape
    V = w.shape[1]
    nbytes = (E * V + R * E) * w.element_size() + R * (4 + 1 + 4 + 4 + 5 * 4)
    dt = "float32" if w.dtype == torch.float32 else "bfloat16"
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * R * E * V / PEAK_OPS[dt]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def fused_compare(torch, name, a, got, want):
    """Hold the kernel's outputs against the plain version's under the
    limits above; returns the row's numbers."""
    from areal_tpu_torch.ops.fused_sample import _MASK, _gumbel

    x, w = a["x"], a["w"]
    R, V = x.shape[0], w.shape[1]
    logits = x.float() @ w.float()
    if a["soft_cap"]:
        logits = torch.tanh(logits / a["soft_cap"]) * a["soft_cap"]
    t = a["temperature"].clamp_min(1e-6)
    warped = logits / t[:, None]
    limit = FUSED_ATOL + FUSED_RTOL * want["norm"].abs()
    rows = torch.arange(R, device="cuda")
    greedy = a["greedy"]

    def fail(msg):
        raise AssertionError(f"fused_sample {name}: {msg}")

    over, err = 0.0, 0.0
    for k in ("norm", "logprobs") + (("gathered_lp",) if "gathered_lp" in want
                                     else ()):
        diff = (got[k] - want[k]).abs()
        if k == "logprobs":       # sampled rows: only where the tokens agree
            diff = torch.where(greedy | (got["tokens"] == want["tokens"]),
                               diff, 0.0)
        ratio = (diff / limit).max().item()
        if not (np.isfinite(ratio) and ratio <= 1.0):
            fail(f"{k} differs by {diff.max().item()} ({ratio} x the limit)")
        over = max(over, ratio)
        if (~greedy).any():
            err = max(err, diff[~greedy].max().item())
    # raw argmax: equal, or a near tie of the plain logits
    ka, pa = got["argmax"].long(), want["argmax"].long()
    gap = (logits[rows, ka] - logits[rows, pa]).abs()
    n_arg = int((ka != pa).sum())
    if not bool(((ka == pa) | (gap <= limit * t)).all()):
        fail(f"argmax differs beyond a near tie: gaps {gap[ka != pa].tolist()}")
    # tokens: greedy rows are the argmax; sampled rows equal or a near tie
    # of the plain version's perturbed values
    kt, pt = got["tokens"].long(), want["tokens"].long()
    if not bool((kt[greedy] == ka[greedy]).all()):
        fail("a greedy row's token is not its argmax")
    pert = warped + _gumbel(a["seed"], rows[:, None],
                            torch.arange(V, device="cuda")[None, :])
    if a["exclude"] is not None:
        cols = torch.arange(V, device="cuda")[None, :]
        pert = torch.where(cols == a["exclude"][:, None].long(), _MASK, pert)
        if bool((kt[~greedy] == a["exclude"].long()[~greedy]).any()):
            fail("a sampled row drew its excluded token")
    pgap = (pert[rows, kt] - pert[rows, pt]).abs()
    n_tok = int(((kt != pt) & ~greedy).sum())
    if not bool((greedy | (kt == pt) | (pgap <= limit)).all()):
        fail(f"sampled tokens differ beyond a near tie: {n_tok} rows")
    want_lp = warped[rows, kt] - want["norm"]
    lp_diff = torch.where(greedy, 0.0, (got["logprobs"] - want_lp).abs())
    if not bool((lp_diff <= limit).all()):
        fail(f"sampled logprobs differ from warped[token] - norm by "
             f"{lp_diff.max().item()}")
    return {"max_abs_err": max(err, lp_diff.max().item()),
            "err_over_tol": over, "atol": FUSED_ATOL, "rtol": FUSED_RTOL,
            "argmax_near_ties": n_arg, "token_near_ties": n_tok}


def fused_library(torch, a):
    """The unfused epilogue the port runs without the kernel: the head
    GEMM in the serving dtype (cuBLAS), the logits widened to f32, then
    ``sample_tokens(warp=False)`` over them."""
    from areal_tpu_torch.gen.sampling import SamplingParams, sample_tokens

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    R = a["x"].shape[0]
    sp = SamplingParams.filled(R, device="cuda")
    sp.temperature = a["temperature"]
    cap = a["soft_cap"]

    def call():
        logits = (a["x"] @ a["w"]).float()
        if cap:
            logits = cap * torch.tanh(logits / cap)
        return sample_tokens(gen, logits, sp, warp=False)

    return call


def fused_chi_square(torch, exclude):
    """20000 independent draws at V 16 in one launch (the row index enters
    the hash as the seed does) against softmax(warped); chi-square, df 15
    (14 with a token excluded), limit 45 (p ~ 1e-4)."""
    from areal_tpu_torch.ops.cuda import fused_sample as cuda_fused

    n, V, E = 20000, 16, 8
    g = torch.Generator(device="cuda")
    g.manual_seed(77)
    x1 = torch.randn(1, E, generator=g, device="cuda")
    w = torch.randn(E, V, generator=g, device="cuda") * 0.5
    p = torch.softmax((x1 @ w)[0].double(), -1)
    excl = None
    if exclude:
        ex = int(p.argmax())
        excl = torch.full((n,), ex, dtype=torch.int32, device="cuda")
        p[ex] = 0.0
        p = p / p.sum()
    out = cuda_fused.fused_sample(
        torch.tensor([4242], dtype=torch.int32, device="cuda"),
        x1.expand(n, E).contiguous(), w, torch.ones(n, device="cuda"),
        torch.zeros(n, dtype=torch.bool, device="cuda"), exclude=excl,
    )
    counts = torch.bincount(out["tokens"].long(), minlength=V).double()
    keep = p > 0
    if bool((counts[~keep] > 0).any()):
        raise AssertionError("fused_sample: drew an excluded token")
    chi2 = (((counts[keep] - n * p[keep]) ** 2) / (n * p[keep])).sum().item()
    if not chi2 < 45.0:
        raise AssertionError(f"fused_sample: chi-square {chi2} against "
                             f"softmax(warped), exclude={exclude}")
    return chi2


def fused_kernels_phase(torch):
    from areal_tpu_torch.ops.cuda import fused_sample as cuda_fused
    from areal_tpu_torch.ops.fused_sample import fused_sample_plain

    cases = [
        ("slice_bf16", dict(R=32, E=1536, V=151936, dtype="bfloat16"), True),
        ("f32_v500", dict(R=6, E=32, V=500, dtype="float32"), False),
        ("f32_cap_excl_gather", dict(R=6, E=64, V=50257, dtype="float32",
                                     soft_cap=30.0, exclude=True,
                                     gather=True), False),
        ("f32_e70", dict(R=5, E=70, V=300, dtype="float32"), False),
        ("f32_r1", dict(R=1, E=128, V=500, dtype="float32"), False),
        ("f32_tied", dict(R=6, E=64, V=500, dtype="float32", tied=True,
                          gather=True), False),
        ("bf16_v50257_cap", dict(R=8, E=256, V=50257, dtype="bfloat16",
                                 soft_cap=30.0), False),
        ("bf16_r160", dict(R=160, E=128, V=5000, dtype="bfloat16",
                           exclude=True, gather=True), False),
        ("bf16_e200_cap", dict(R=33, E=200, V=1000, dtype="bfloat16",
                               soft_cap=20.0, gather=True), False),
        ("bf16_tied", dict(R=32, E=1536, V=20000, dtype="bfloat16",
                           tied=True, exclude=True), False),
    ]
    results = {}
    for i, (name, spec, timed) in enumerate(cases):
        a = make_fused_inputs(torch, seed=300 + i, **spec)
        args = (a["seed"], a["x"], a["w"], a["temperature"], a["greedy"])
        kw = dict(exclude=a["exclude"], gather_ids=a["gather_ids"],
                  soft_cap=a["soft_cap"])
        got = cuda_fused.fused_sample(*args, **kw)
        want = fused_sample_plain(*args, **kw)
        torch.cuda.synchronize()
        row = fused_compare(torch, name, a, got, want)
        if spec["dtype"] == "bfloat16":
            # the same input through the CUDA-core version of the product
            # (a no-op choice where the tensor-core version cannot run)
            other = cuda_fused.fused_sample(*args, **kw, cuda_cores=True)
            torch.cuda.synchronize()
            row["cuda_core_err_over_tol"] = fused_compare(
                torch, name + "[cuda cores]", a, other, want)["err_over_tol"]
        if timed:
            row["kernel_ms"] = cuda_ms(
                lambda: cuda_fused.fused_sample(*args, **kw), 20)
            row["cuda_core_ms"] = cuda_ms(
                lambda: cuda_fused.fused_sample(*args, **kw,
                                                cuda_cores=True), 20)
            row["plain_ms"] = cuda_ms(
                lambda: fused_sample_plain(*args, **kw), 3)
            row["library_ms"] = cuda_ms(fused_library(torch, a), 20)
            row["bound_ms"], row["bound_by"] = fused_bound(torch, a)
            row["w_bytes"] = a["w"].numel() * a["w"].element_size()
        results[name] = row
        del a, args, kw, got, want
        torch.cuda.empty_cache()
    results["chi_square"] = {"plain": fused_chi_square(torch, False),
                             "excluded": fused_chi_square(torch, True),
                             "draws": 20000, "limit": 45.0}
    emit(phase="kernels", kernel="fused_sample", cases=results)
    return results


def sweep_phase(torch):
    """Paged-decode time against pages per slot at the serving widths: one
    slot alone (the kernel's critical path) and all 64 slots equal, as
    CUDA-event time of eager calls (``kernel_ms``, the kernel rows'
    yardstick) and as device time (``device_ms``, see ``time_decode``);
    then device time against pages per split."""
    from areal_tpu_torch.ops.cuda import paged_attention as cuda_paged

    rows = []
    for pages in (1, 2, 4, 8, 16):
        for label, lens in (("one_slot", [128 * pages - 1] + [0] * 63),
                            ("all_slots", [128 * pages - 1] * 64)):
            x = make_decode_inputs(torch, B=64, Hq=12, Hkv=2, D=128,
                                   page=128, W=16, L=28, dtype="bfloat16",
                                   quant=False, lens=lens, seed=7)
            calls = decode_calls(torch, cuda_paged, x, None, 56)
            rows.append({"pages_per_slot": pages, "slots": label,
                         "kernel_ms": cuda_ms(calls[-1], 30),
                         "device_ms": graph_ms(calls)})
            del x
    # pages per split (the wrapper's default is 2 at page 128) at the slice
    # shape and the serve phase's shape, both pools
    for label, shape in (("slice", DECODE_SLICE), ("serve", DECODE_SERVE)):
        for quant in (False, True):
            x = make_decode_inputs(torch, dtype="bfloat16", quant=quant,
                                   seed=7, **shape)
            for pps in (1, 2, 4):
                rows.append({"shape": label, "pool": "int8" if quant else
                             "bfloat16", "pages_per_split": pps,
                             "device_ms": graph_ms(decode_calls(
                                 torch, cuda_paged, x, pps, 56))})
            del x
    torch.cuda.empty_cache()
    emit(phase="sweep", kernel="paged_decode", rows=rows)


# --------------------------------------------------------------------------- #
# parity: the engine on the card vs on the CPU (tiny float32 model)
# --------------------------------------------------------------------------- #


def admission_graphed(name, stats, eng=None):
    """Every admission program run on the card was a graph replay, or the
    eager warm-up of its key's capture (a wave like the rest to the
    counts): replays + captures = waves, for extends and for commits, one
    capture per program built."""
    ok = (stats["extend_replays"] + stats["extend_captures"]
          == stats["prefill_waves"] > 0) and (
        stats["commit_replays"] + stats["commit_captures"]
        == stats["commit_waves"] > 0)
    if eng is not None:
        ok = ok and stats["extend_captures"] == len(eng._jit_extend) and (
            stats["commit_captures"] == len(eng._jit_commit))
    if not ok:
        raise AssertionError(f"{name}: admission not all graph replays: "
                             f"{stats}")


def extend_keys(rows, chunk=128, page=128, width_cap=16, buckets=(1, 2, 4, 8)):
    """The extend programs ``(n_rows, width, skip_pool)`` that one wave of
    admission rows needs, each row ``(start, n_tokens)``: the engine's
    bucketing and table-width rule written out independently."""
    keys, i = set(), 0
    while i < len(rows):
        n = next(b for b in buckets if b >= min(len(rows) - i, buckets[-1]))
        grp = rows[i:i + n]
        i += len(grp)
        for c in range(-(-max(t for _, t in grp) // chunk)):
            max_pos = max(s + min(t, (c + 1) * chunk) for s, t in grp)
            width = 32
            while width < -(-max_pos // page):
                width *= 2
            keys.add((n, min(width, width_cap),
                      c == 0 and not any(s for s, _ in grp)))
    return keys


PARITY_STEPS = 8


def parity_phase(torch):
    from areal_tpu_torch.gen.engine import GenerationEngine, GenRequest
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=64,
                      hidden_dim=128, intermediate_dim=256, vocab_size=512,
                      use_attention_bias=True, dtype="float32")
    params = tfm.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 512, size=40).tolist()
    prompts = [shared + rng.integers(0, 512, size=int(n)).tolist()
               for n in (1, 5, 17, 30)] + [rng.integers(0, 512, 9).tolist()]
    # staggered admission while decoding: arrivals by engine step; group
    # members borrow the shared pages (prefix hits), every prompt but the
    # last runs several 16-token waves, one member diverges inside a page
    # it borrows from (a partial hit)
    later = shared[:32] + rng.integers(0, 512, size=21).tolist()
    schedule = {
        0: [(str(i), p, 24) for i, p in enumerate(prompts)],
        2: [("s0", prompts[3], 12), ("s1", later, 16)],
        5: [("s2", shared + [7], 10), ("s3", later, 9),
            ("s4", rng.integers(0, 512, size=70).tolist(), 6)],
    }
    outs = {}
    # the card decodes and admits from CUDA graphs, the CPU eagerly; the
    # card also pipelined (each chunk harvested one step late)
    for dev, pipelined in (("cuda", False), ("cuda", True), ("cpu", False)):
        for fused in (False, True):
            eng = GenerationEngine(cfg, params, max_slots=4, max_seqlen=128,
                                   page_size=16, fused_sample=fused,
                                   pipeline_chunks=pipelined, device=dev)
            got = {}
            for step in range(max(schedule) + 1):
                for rid, p, n in schedule.get(step, ()):
                    eng.submit(GenRequest(rid=rid, input_ids=p,
                                          max_new_tokens=n, greedy=True))
                got.update({o.rid: o.output_ids
                            for o in eng.step(PARITY_STEPS)})
            got.update({o.rid: o.output_ids
                        for o in eng.run_until_done(PARITY_STEPS)})
            outs[dev, fused, pipelined] = got
            if fused and eng.stats["fused_sample_steps"] <= 0:
                raise AssertionError("parity: the fused engine took no "
                                     "fused step")
            st = eng.stats
            if st["prefix_hits"] < 6 or len(got) != 10:
                raise AssertionError(f"parity: traffic {st} {sorted(got)}")
            graphed = st["graph_captures"] == len(eng._jit_chunk) > 0 and (
                st["graph_replays"] * PARITY_STEPS + st["graph_captures"]
                == st["decode_steps"])
            if graphed != (dev == "cuda"):
                raise AssertionError(f"parity: {dev} engine graphs: {st}")
            if dev == "cuda":
                admission_graphed("parity", st, eng)
            elif st["extend_captures"] or st["commit_captures"]:
                raise AssertionError(f"parity: the cpu engine captured: {st}")
    # float32: the fused and the unfused epilogue agree on every argmax
    want = outs["cpu", False, False]
    for key, got in outs.items():
        if got != want:
            raise AssertionError(f"greedy {key} != cpu unfused: {got} {want}")
    emit(phase="parity", requests=len(want), staggered_arrivals=len(schedule),
         token_exact=True, fused_token_exact=True,
         pipelined_token_exact=True, admission_graphed=True)


# --------------------------------------------------------------------------- #
# serving at the 1.5B profile's width, over HTTP
# --------------------------------------------------------------------------- #


# R1-Distill-Qwen-1.5B widths (the repo's generation bench profile)
QWEN_1P5B_ARCH = dict(
    n_layers=28, n_q_heads=12, n_kv_heads=2, head_dim=128,
    hidden_dim=1536, intermediate_dim=8960, vocab_size=151936,
    use_attention_bias=True, dtype="bfloat16",
)


def qwen_1p5b_cfg():
    from areal_tpu_torch.models.config import ModelConfig

    return ModelConfig(**QWEN_1P5B_ARCH)


def post(port, path, body, timeout=900):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def device_profile(prof, wall_s, kernels, top=10):
    """Device time by kernel from a ``torch.profiler`` window: total, the
    busy share of the wall time, each named kernel's time, share and
    number of runs the profiler saw (``kernels``: label -> substring of the
    kernel's name), and the ``top`` kernels."""
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0)
        if t > 0:
            rows.append((ev.key, t / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    out = dict(device_ms=total, busy_share=total / 1e3 / wall_s)
    for label, needle in kernels.items():
        ms = sum(r[1] for r in rows if needle in r[0])
        out[f"{label}_ms"] = ms
        out[f"{label}_share"] = ms / max(total, 1e-9)
        out[f"{label}_runs"] = sum(r[2] for r in rows if needle in r[0])
    out["top"] = [[k[:80], ms, n] for k, ms, n in rows[:top]]
    return out


TOPK_NEW_TOKENS = 32   # serve_fused: top-k requests leave early
DECODE_STEPS = 16      # decode steps per chunk in the serve phases


def stream_check(port, eng, vocab):
    """``/generate_stream`` at the served widths: a greedy request's deltas
    equal its ``/generate`` twin's answer (both run alone, the prompt under
    one page so neither borrows a page), and a client that hangs up after
    the first frame frees its slot."""
    import socket

    rng = np.random.default_rng(5)
    ids = rng.integers(0, vocab, size=100).tolist()
    sp = {"max_new_tokens": 64, "greedy": True}
    _, want = post(port, "/generate", {"rid": "twin", "input_ids": ids,
                                       "sampling_params": sp})
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate_stream",
        data=json.dumps({"rid": "stream", "input_ids": ids,
                         "sampling_params": sp}).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        ctype, raw = r.headers.get("Content-Type"), r.read()
    frames = [ln[5:].strip() for ln in raw.split(b"\n")
              if ln.startswith(b"data:")]
    events = [json.loads(f) for f in frames[:-1]]
    toks = [t for e in events for t in e["token_ids"]]
    if ctype != "text/event-stream" or frames[-1] != b"[DONE]" or (
            toks != want["output_ids"]) or len(events) < 2 or (
            events[-1]["finish_reason"] != want["finish_reason"]):
        raise AssertionError(f"stream: {toks} != {want['output_ids']}; "
                             f"{raw[-300:]!r}")
    free = eng.free_slots()
    sock = socket.create_connection(("127.0.0.1", port))
    data = json.dumps({"rid": "gone", "input_ids": ids, "sampling_params": {
        "max_new_tokens": 1000, "greedy": True}}).encode()
    sock.sendall(b"POST /generate_stream HTTP/1.1\r\nHost: x\r\n"
                 + f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
    got = b""
    while b"data: {" not in got:
        chunk = sock.recv(4096)
        if not chunk:
            raise AssertionError(f"stream: no first frame: {got!r}")
        got += chunk
    steps = eng.stats["decode_steps"]
    sock.close()
    deadline = time.time() + 60
    while eng.free_slots() < free or eng.n_running():
        if time.time() > deadline:
            raise AssertionError("stream: a disconnect kept its slot")
        time.sleep(0.005)
    return dict(stream_frames=len(events), stream_tokens=len(toks),
                disconnect_steps=eng.stats["decode_steps"] - steps)


def serve_phase(torch, name, params, cfg, *, kv_dtype, n_prompts,
                group, plen=1024, max_new=128, profile=False, fused=False,
                pipelined=False, stream=False):
    """Serve ``n_prompts`` x ``group`` requests over HTTP. ``fused`` runs
    the engine with the fused sampling epilogue and turns the group's last
    member into a top-k 20 request of TOPK_NEW_TOKENS tokens: while it is
    resident the streamed top-k route runs, afterwards the kernel.
    ``pipelined`` harvests each decode chunk one step late. The requests
    queue while the server is paused and are admitted together, so two
    runs batch their prefills alike. Every admission wave must replay a
    graph (or be its key's first use), over the extend keys the traffic
    implies. ``stream`` then runs ``stream_check`` on the same server."""
    from areal_tpu_torch.gen.engine import GenerationEngine
    from areal_tpu_torch.gen.server import serve
    from areal_tpu_torch.ops.cuda import fused_sample as cuda_fused
    from areal_tpu_torch.ops.cuda import paged_attention as cuda_paged

    eng = GenerationEngine(cfg, params, max_slots=32, max_seqlen=2048,
                           page_size=128, seed=0, kv_dtype=kv_dtype,
                           fused_sample=fused, pipeline_chunks=pipelined,
                           device="cuda")
    srv = serve(eng, "127.0.0.1", 0, decode_steps=DECODE_STEPS)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=plen).tolist()
               for _ in range(n_prompts)]
    modes = ["greedy"] * (group // 2) + ["temp"] * (group // 4) + (
        ["top_p"] * (group - group // 2 - group // 4))
    if fused:
        modes[-1] = "top_k"
    bodies = []
    for g, p in enumerate(prompts):
        for m, mode in enumerate(modes):
            sp = {"max_new_tokens": max_new}
            if mode == "greedy":
                sp["greedy"] = True
            else:
                sp["temperature"] = 1.0
                if mode == "top_p":
                    sp["top_p"] = 0.9
                if mode == "top_k":
                    sp["top_k"] = 20
                    sp["max_new_tokens"] = TOPK_NEW_TOKENS
            bodies.append({"rid": f"g{g}m{m}", "input_ids": p,
                           "sampling_params": sp})
    try:
        # the main path's run: every launch counted from here on
        cuda_paged.reset_launches()
        cuda_fused.reset_launches()
        steps0 = eng.stats["decode_steps"]
        prof = None
        if profile:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]
            )
            prof.__enter__()
        t0 = time.perf_counter()
        post(srv.port, "/pause_generation", {})
        with ThreadPoolExecutor(len(bodies)) as ex:
            futs = [ex.submit(post, srv.port, "/generate", b) for b in bodies]
            deadline = time.time() + 60
            while eng.n_pending() < len(bodies):
                if time.time() > deadline:
                    raise AssertionError(f"{name}: requests did not queue")
                time.sleep(0.005)
            post(srv.port, "/continue_generation", {})
            answers = [f.result() for f in futs]
        # pipelined: the engine loop resolves the chunk it dispatched
        # after the last finish
        deadline = time.time() + 60
        while eng.has_inflight:
            if time.time() > deadline:
                raise AssertionError(f"{name}: a chunk stayed in flight")
            time.sleep(0.005)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
        launches = cuda_paged.launches
        fused_launches = cuda_fused.launches
        steps = eng.stats["decode_steps"] - steps0
        metrics = get(srv.port, "/metrics_json")
        stats = dict(eng.stats)
        keys = (set(eng._jit_extend), set(eng._jit_commit))
        n_chunk_programs = len(eng._jit_chunk)
        admission_graphed(name, stats, eng)
        streamed = stream_check(srv.port, eng, cfg.vocab_size) if stream \
            else {}
        if stream:
            admission_graphed(f"{name} stream", eng.stats, eng)
    finally:
        srv.stop()
    by_rid = {}
    for body, (status, ans) in zip(bodies, answers):
        ids, lps = ans.get("output_ids"), ans.get("output_logprobs")
        ok = (
            status == 200 and ans.get("rid") == body["rid"]
            and isinstance(ids, list) and isinstance(lps, list)
            and len(ids) == len(lps)
            and (len(ids) == body["sampling_params"]["max_new_tokens"]
                 or ans.get("finish_reason") == "stop")
            and all(0 <= t < cfg.vocab_size for t in ids)
            and bool(np.all(np.isfinite(lps)))
        )
        if not ok:
            raise AssertionError(f"{name}: bad answer to {body['rid']}: "
                                 f"{status} {str(ans)[:300]}")
        by_rid[body["rid"]] = ids
    if metrics["engine_prefix_hits"] <= 0:
        raise AssertionError(f"{name}: no prefix hits: {metrics}")
    # one admission: the groups' first members cold, the rest borrowing
    # their full pages and prefilling the tail
    shared = (plen - 1) // 128 * 128
    want_keys = extend_keys([(0, plen - 1)] * n_prompts) | extend_keys(
        [(shared, plen - 1 - shared)] * (n_prompts * (group - 1)))
    if keys != (want_keys, {8}):
        raise AssertionError(f"{name}: extend and commit keys {keys}, the "
                             f"traffic implies {want_keys}, {{8}}")
    if steps <= 0 or launches != cfg.n_layers * steps:
        raise AssertionError(
            f"{name}: paged_decode launched {launches} times over {steps} "
            f"decode steps of {cfg.n_layers} layers"
        )
    # every chunk replayed a captured graph; each capture followed one
    # eager warm-up step over no active slot, a decode step like the rest
    if stats["graph_replays"] <= 0 or (
            stats["graph_captures"] != n_chunk_programs) or (
            stats["graph_replays"] * DECODE_STEPS + stats["graph_captures"]
            != steps):
        raise AssertionError(f"{name}: {steps} decode steps from graph "
                             f"replays and warm-ups: {stats}")
    if stats["chunk_flag_fetches"] != stats["graph_replays"] or (
            metrics["chunk_flag_fetches"] != stats["chunk_flag_fetches"]) or (
            metrics["pipeline_chunks"] != pipelined):
        raise AssertionError(f"{name}: flag fetches {stats}; /metrics_json "
                             f"{metrics}")
    if fused:
        # every step sampled by the fused epilogue; the kernel in exactly
        # those steps in which no plain-top-k slot was resident (the
        # engine counts the steps it routed through the top-k buffer)
        kernel_steps = stats["fused_sample_steps"] - stats["fused_topk_steps"]
        if stats["fused_sample_steps"] != steps or fused_launches <= 0 or (
                fused_launches != kernel_steps):
            raise AssertionError(
                f"{name}: fused_sample launched {fused_launches} times; "
                f"{steps} decode steps, {stats['fused_sample_steps']} fused, "
                f"{stats['fused_topk_steps']} on the top-k route"
            )
        if stats["fused_topk_steps"] <= 0 or stats["sampler_fallback_rows"] <= 0:
            raise AssertionError(f"{name}: the top-k route or the sorted "
                                 f"fallback never ran: {stats}")
        if not metrics["fused_sample"]:
            raise AssertionError(f"{name}: /metrics_json: {metrics}")
    elif fused_launches or stats["fused_sample_steps"]:
        raise AssertionError(f"{name}: the unfused engine launched the "
                             f"fused kernel {fused_launches} times")
    # informational: borrowers prefill their tail in another batch shape
    # than the group's first member, so bf16 may differ slightly
    agree = []
    for g in range(n_prompts):
        first = by_rid[f"g{g}m0"]
        for m in range(1, group // 2):
            other = by_rid[f"g{g}m{m}"]
            agree.append(float(np.mean(np.asarray(first) == np.asarray(other))))
    gen_tokens = sum(len(v) for v in by_rid.values())
    row = dict(
        requests=len(bodies), answered=len(by_rid), max_new_tokens=max_new,
        prompt_tokens=plen, kv_dtype=eng.kv_dtype, wall_s=wall,
        prefill_tokens=stats["prefill_tokens"],
        prefix_hits=stats["prefix_hits"],
        prefix_hit_tokens=stats["prefix_hit_tokens"],
        prefill_tok_per_s=stats["prefill_tokens"] / max(stats["prefill_s"], 1e-9),
        decode_tok_per_s=gen_tokens / max(stats["decode_s"], 1e-9),
        prefill_s=stats["prefill_s"], decode_s=stats["decode_s"],
        decode_steps=steps, paged_decode_launches=launches,
        fused_sample=fused, fused_sample_launches=fused_launches,
        fused_sample_steps=stats["fused_sample_steps"],
        fused_topk_steps=stats["fused_topk_steps"],
        sampler_fallback_rows=stats["sampler_fallback_rows"],
        greedy_tokens={r: t for r, t in by_rid.items()
                       if modes[int(r.split("m")[1])] == "greedy"},
        greedy_group_agreement=agree,
        kv_pool_bytes=metrics["kv_pool_bytes"],
        pipeline_chunks=pipelined,
        graph_captures=stats["graph_captures"],
        graph_replays=stats["graph_replays"],
        graph_capture_s=stats["graph_capture_s"],
        graph_pool_gb=stats["graph_pool_bytes"] / 1e9,
        chunk_flag_fetches=stats["chunk_flag_fetches"],
        chunk_flag_blocked=stats["chunk_flag_blocked"],
        prefill_waves=stats["prefill_waves"],
        extend_captures=stats["extend_captures"],
        extend_replays=stats["extend_replays"],
        commit_captures=stats["commit_captures"],
        commit_replays=stats["commit_replays"],
        admit_capture_s=stats["admit_capture_s"],
        extend_keys=sorted(keys[0]),
        **streamed,
    )
    if prof is not None:
        pr = row["profile"] = device_profile(
            prof, wall, {"paged_decode": "paged_decode_split_kernel",
                         "fused_sample": "fused_sample_"})
        # the profiler's own count, independent of the Python counters
        if pr["paged_decode_runs"] != cfg.n_layers * steps:
            raise AssertionError(
                f"{name}: the profiler saw {pr['paged_decode_runs']} "
                f"paged-decode kernels over {steps} steps of {cfg.n_layers} "
                f"layers; {json.dumps(pr)}")
        row["paged_decode_ms_per_step"] = pr["paged_decode_ms"] / steps
        # the window holds the one-time captures, decode and admission
        # (host time, the card idles): the share over the rest of it
        pr["busy_share_after_capture"] = pr["device_ms"] / 1e3 / max(
            wall - stats["graph_capture_s"] - stats["admit_capture_s"], 1e-9)
    emit(phase=name, **{k: v for k, v in row.items() if k != "greedy_tokens"})
    del eng
    torch.cuda.empty_cache()
    return row


def fused_determinism(torch, params, cfg):
    """Two fresh fused engines, the same 8 requests submitted in the same
    order: the per-step seeds come from the engine's seeded generator and
    the uniforms are a function of (seed, row, column), so every token,
    sampled ones included, must come out the same twice."""
    from areal_tpu_torch.gen.engine import GenerationEngine, GenRequest

    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=256).tolist()
               for _ in range(2)]
    runs = []
    for _ in range(2):
        eng = GenerationEngine(cfg, params, max_slots=8, max_seqlen=512,
                               page_size=128, seed=0, fused_sample=True,
                               device="cuda")
        for g, p in enumerate(prompts):
            eng.submit(GenRequest(rid=f"g{g}", input_ids=p, max_new_tokens=24,
                                  greedy=True))
            eng.submit(GenRequest(rid=f"t{g}", input_ids=p, max_new_tokens=24,
                                  temperature=1.0))
            eng.submit(GenRequest(rid=f"p{g}", input_ids=p, max_new_tokens=24,
                                  top_p=0.9))
            eng.submit(GenRequest(rid=f"k{g}", input_ids=p, max_new_tokens=8,
                                  top_k=20))
        runs.append({o.rid: o.output_ids for o in eng.run_until_done(8)})
        del eng
    torch.cuda.empty_cache()
    if runs[0] != runs[1] or len(runs[0]) != 8:
        diff = [r for r in runs[0] if runs[0][r] != runs[1].get(r)]
        raise AssertionError(f"serve_fused: two fused runs differ on {diff}")
    return len(runs[0])


# --------------------------------------------------------------------------- #
# weight sync: trainer -> committed HF export -> running server
# --------------------------------------------------------------------------- #


# weight_sync: a sampled token's logprob from the engine (paged decode,
# bf16) against the same token scored by a packed forward (flash, bf16) on
# the same weights. Both round the logits to bf16 (one ulp is 2^-6 at the
# |logits| of 2-4 a random head gives) and differ by about one bf16 ulp of
# the hidden state, ~0.01; two independent random weight sets give logits
# of std ~0.8 each, so the same token's logprob moves by ~0.9 on average.
WEIGHT_SYNC_LP_TOL = 0.1


def score_tokens(torch, tfm, cfg, params, ids, n_prompt):
    """Temperature-1 log-probabilities of the generated tokens of ``ids``
    (after ``n_prompt`` prompt tokens) under ``params``, by one packed
    forward."""
    t = torch.tensor(ids, device="cuda")
    with torch.no_grad():
        logits = tfm.forward_packed(
            params, cfg, t, torch.ones_like(t, dtype=torch.int32),
            torch.arange(len(ids), dtype=torch.int32, device="cuda"),
            remat=False)
    lp = torch.log_softmax(logits.float(), dim=-1)
    pos = torch.arange(n_prompt - 1, len(ids) - 1, device="cuda")
    return lp[pos, t[n_prompt:]].cpu().numpy()


def weight_sync_phase(torch):
    """The third leg of the main path at the 1.5B profile's widths with the
    depth cut to 2 layers (0.56 B parameters, 2.2 GB of f32 on disk; the
    full 28 layers would write 7 GB per export). A trainer takes two SFT
    steps (the schedule's first step has lr 0, so the second is the one
    that moves the weights), exports with ``save_hf``, and a running
    server with requests in flight reloads the export through
    ``POST /update_weights_from_disk``."""
    import dataclasses
    import os
    import shutil
    import tempfile

    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.api.model import make_interface
    from areal_tpu_torch.base import recover
    from areal_tpu_torch.gen.engine import GenerationEngine, GenRequest
    from areal_tpu_torch.gen.server import serve
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.train.engine import OptimizerConfig, TrainEngine

    cfg = dataclasses.replace(qwen_1p5b_cfg(), n_layers=2)
    train_cfg = dataclasses.replace(cfg, remat_policy="full",
                                    loss_chunk_size=2048)
    trainer = TrainEngine(train_cfg, optimizer=OptimizerConfig(lr=1e-4),
                          device="cuda").init_random(0).setup_optimizer(10)
    probe = trainer.params["layers"][1]["mlp"]["w_up"].detach().clone()
    sample = rollout_sample(np.random.default_rng(3), n_prompts=2, group=2,
                            prompt_len=64, resp_lo=32, resp_hi=96,
                            vocab=cfg.vocab_size)
    sft = make_interface("sft")
    for _ in range(2):
        st = sft.train_step(trainer, sample, MicroBatchSpec(max_tokens_per_mb=1024))
        if st["guard/step_ok"] != 1.0 or not np.isfinite(st["loss"]):
            raise AssertionError(f"weight_sync: bad SFT step {st}")
    if torch.equal(trainer.params["layers"][1]["mlp"]["w_up"], probe):
        raise AssertionError("weight_sync: the SFT steps moved no weight")
    del probe
    trainer.version = 1

    root = tempfile.mkdtemp(prefix="areal_weight_sync_")
    srv = None
    try:
        path = os.path.join(root, "export")
        t0 = time.perf_counter()
        trainer.save_hf(path, "qwen2")
        export_s = time.perf_counter() - t0
        manifest = recover.read_manifest(path)
        if manifest != {"step": 2, "version": 1, "format": "hf"} or (
                sorted(os.listdir(root)) != ["export"]):
            raise AssertionError(f"weight_sync: export not committed: "
                                 f"{manifest} {os.listdir(root)}")
        nbytes = os.path.getsize(os.path.join(path, "model.safetensors"))

        # the server starts on OTHER weights (seed 1)
        old_params = tfm.init_params(cfg, seed=1, device="cuda",
                                     dtype=torch.bfloat16)
        eng = GenerationEngine(cfg, old_params, max_slots=8, max_seqlen=2048,
                               page_size=128, seed=0, device="cuda")
        srv = serve(eng, "127.0.0.1", 0, decode_steps=16)
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, cfg.vocab_size, size=256).tolist()
                   for _ in range(4)]
        # one 256-token prompt admitted alone before the update captures
        # the extend programs the checks after it admit through
        post(srv.port, "/generate", {
            "rid": "warm", "input_ids": rng.integers(
                0, cfg.vocab_size, size=256).tolist(),
            "sampling_params": {"max_new_tokens": 4, "greedy": True}})
        bodies = [{"rid": f"inflight{i}", "input_ids": p,
                   "sampling_params": {"max_new_tokens": 1000, "greedy": True}}
                  for i, p in enumerate(prompts)]
        # graphed decode finishes a 1000-token request faster than the
        # overlapped load takes: keep four requests in flight until the
        # update answers.
        feed = [rng.integers(0, cfg.vocab_size, size=100).tolist()
                for _ in range(4)]
        with ThreadPoolExecutor(64) as ex:
            futs = [(b, ex.submit(post, srv.port, "/generate", b))
                    for b in bodies]
            deadline = time.time() + 120
            while eng.stats["decode_steps"] < 32:
                if time.time() > deadline:
                    raise AssertionError("weight_sync: decode did not start")
                time.sleep(0.01)
            before = get(srv.port, "/metrics_json")
            keys_before = set(eng._jit_extend)
            t0 = time.perf_counter()
            upd = ex.submit(post, srv.port, "/update_weights_from_disk", {
                "model_path": path, "version": trainer.version,
                "allow_interrupt": True})
            while not upd.done() and len(futs) < 60:
                if sum(not f.done() for _, f in futs) < 4:
                    b = {"rid": f"feed{len(futs)}",
                         "input_ids": feed[len(futs) % 4],
                         "sampling_params": {"max_new_tokens": 1000,
                                             "greedy": True}}
                    futs.append((b, ex.submit(post, srv.port, "/generate",
                                              b)))
                time.sleep(0.005)
            status, ans = upd.result()
            reload_s = time.perf_counter() - t0
            bodies = [b for b, _ in futs]
            partials = [f.result() for _, f in futs]
        after = get(srv.port, "/metrics_json")
        if status != 200 or not ans.get("success") or (
                ans.get("num_paused_requests", 0) <= 0):
            raise AssertionError(f"weight_sync: update answered {status} {ans}")
        n_partial = 0
        for body, (st_code, a) in zip(bodies, partials):
            ok = st_code == 200 and a.get("rid") == body["rid"] and (
                0 < len(a["output_ids"]) <= 1000)
            if a.get("finish_reason") == "interrupted":
                n_partial += 1
                ok = ok and a.get("version") == 0 and len(a["output_ids"]) < 1000
            if not ok:
                raise AssertionError(f"weight_sync: bad partial {str(a)[:300]}")
        if n_partial != ans["num_paused_requests"]:
            raise AssertionError(f"weight_sync: {n_partial} partial answers "
                                 f"for {ans['num_paused_requests']} paused")
        if before["prefix_pages"] <= 0 or (
                after["version"] != 1 or after["paused"]
                or after["n_weight_updates"] != 1):
            raise AssertionError(f"weight_sync: metrics after the update: "
                                 f"{after}")
        # greedy decode after the reload == a fresh engine built from the
        # trainer's parameters directly (one request at a time on both, so
        # every batch has the same shape)
        fresh = GenerationEngine(cfg, trainer.params, max_slots=8,
                                 max_seqlen=2048, page_size=128, seed=0,
                                 device="cuda")
        n_checked = 0
        # both prompts' pages were cached before the update, which must
        # have dropped them (no page of the old weights seeds a request)
        hits_before = eng.stats["prefix_hit_tokens"]
        ext_before = (eng.stats["extend_captures"],
                      eng.stats["extend_replays"])
        for i, p in enumerate(prompts[:2]):
            _, got = post(srv.port, "/generate", {
                "rid": f"after{i}", "input_ids": p,
                "sampling_params": {"max_new_tokens": 32, "greedy": True}})
            fresh.submit(GenRequest(rid="f", input_ids=p, max_new_tokens=32,
                                    greedy=True))
            (want,) = fresh.run_until_done(16)
            if got["output_ids"] != want.output_ids or got["version"] != 1:
                raise AssertionError(
                    f"weight_sync: after the reload {got['output_ids']} != "
                    f"{want.output_ids} from the trainer's params")
            n_checked += len(want.output_ids)
        if eng.stats["prefix_hit_tokens"] != hits_before:
            raise AssertionError(f"weight_sync: a page cached before the "
                                 f"update seeded a request: {eng.stats}")
        # ... and their prefill replayed extend graphs captured before the
        # update: the new weights were copied into the tensors they read
        if not extend_keys([(0, 255)]) <= keys_before or (
                eng.stats["extend_captures"] != ext_before[0]
                or eng.stats["extend_replays"] != ext_before[1] + 4):
            raise AssertionError(
                f"weight_sync: admission after the update did not replay "
                f"the extend graphs captured before it: {keys_before} -> "
                f"{set(eng._jit_extend)}; {eng.stats}")
        admission_graphed("weight_sync", eng.stats, eng)
        # the graphs captured before the reload must decode with the new
        # weights: a temperature-1 request's logprobs (greedy ones are 0
        # at the temperature floor) against its tokens scored by a packed
        # forward on the exported weights, and on the old ones
        _, ans_t = post(srv.port, "/generate", {
            "rid": "after_t", "input_ids": prompts[2],
            "sampling_params": {"max_new_tokens": 32, "temperature": 1.0}})
        ids = prompts[2] + ans_t["output_ids"]
        got_lp = np.asarray(ans_t["output_logprobs"])
        err_new = np.abs(got_lp - score_tokens(
            torch, tfm, cfg, fresh.params, ids, len(prompts[2]))).max()
        diff_old = np.abs(got_lp - score_tokens(
            torch, tfm, cfg, old_params, ids, len(prompts[2]))).mean()
        if not err_new <= WEIGHT_SYNC_LP_TOL < diff_old or (
                eng.stats["graph_captures"] != len(eng._jit_chunk)):
            raise AssertionError(
                f"weight_sync: logprobs after the reload are {err_new} from "
                f"the export's and {diff_old} from the old weights' (limit "
                f"{WEIGHT_SYNC_LP_TOL}); {eng.stats}")
        status, bad = post(srv.port, "/update_weights_from_disk", {
            "model_path": os.path.join(root, "missing"), "version": 7})
        final = get(srv.port, "/metrics_json")
        if bad.get("success") is not False or final["version"] != 1 or (
                final["paused"]):
            raise AssertionError(f"weight_sync: a missing path answered "
                                 f"{bad}; metrics {final}")
    finally:
        if srv is not None:
            srv.stop()
        shutil.rmtree(root, ignore_errors=True)
    emit(phase="weight_sync", layers=cfg.n_layers,
         params=sum(t.numel() for t in tree_leaves(tfm, trainer.params)),
         export_bytes=nbytes, export_s=export_s, reload_s=reload_s,
         export_gb_per_s=nbytes / export_s / 1e9,
         reload_gb_per_s=nbytes / reload_s / 1e9,
         num_paused_requests=ans["num_paused_requests"],
         weight_update_s=final["weight_update_s"],
         weight_load_overlapped_s=final["weight_load_overlapped_s"],
         greedy_tokens_checked=n_checked, version=final["version"],
         logprob_err_vs_export=float(err_new),
         logprob_diff_vs_old=float(diff_old),
         graph_captures=eng.stats["graph_captures"],
         graph_replays=eng.stats["graph_replays"],
         extend_keys_before_update=sorted(keys_before),
         extend_replays=eng.stats["extend_replays"],
         extend_captures=eng.stats["extend_captures"])
    del trainer, eng, fresh, old_params
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# the async rollout loop: server + manager + worker + stream + PPO step +
# a weight update mid-rollout, at the 1.5B profile's widths
# --------------------------------------------------------------------------- #

ASYNC_ROLLOUT = dict(
    n_prompts=64, prompt_len=512, group=4, max_new_tokens=512,
    new_tokens_per_chunk=256,       # the reference's default chunk
    train_batch_size=8, max_head_offpolicyness=4,   # the reference's window
    max_concurrent_rollouts=64, max_concurrent_tasks=48,
    mb_tokens=8192, limit_s=600.0,
)
TRAIN_KEYS = ("packed_input_ids", "prompt_mask", "packed_logprobs", "rewards",
              "seq_no_eos_mask")
TRAJ_KEYS = {"packed_input_ids", "prompt_mask", "packed_logprobs", "rewards",
             "seq_no_eos_mask", "version_start", "version_end"}


def export_bytes(cfg, n_layers):
    """Bytes of an f32 HF export of ``cfg`` cut to ``n_layers``."""
    E, D, F = cfg.hidden_dim, cfg.head_dim, cfg.intermediate_dim
    q, kv = cfg.n_q_heads * D, cfg.n_kv_heads * D
    layer = E * (q + 2 * kv) + (q + 2 * kv) * cfg.use_attention_bias + (
        q * E + 3 * E * F + 2 * E)
    ends = cfg.vocab_size * E * (1 if cfg.tied_embedding else 2) + E
    return 4 * (ends + n_layers * layer)


def export_dir_and_depth(cfg, root, copies=2):
    """Where the phase's export goes, and the depth it runs at: the
    process's temporary directory, else ``root`` (the checkout); the full
    depth where ``copies`` f32 exports fit (two: staging + commit), else
    the most layers that do. Also the free bytes of each candidate (and of
    /dev/shm, for the record)."""
    import os
    import shutil
    import tempfile

    free = {}
    for d in (tempfile.gettempdir(), root, "/dev/shm"):
        try:
            free[d] = shutil.disk_usage(d).free
        except OSError:
            free[d] = 0
    for d in (tempfile.gettempdir(), root):
        if free[d] >= copies * export_bytes(cfg, cfg.n_layers):
            return d, cfg.n_layers, free
    d = max((tempfile.gettempdir(), root), key=free.get)
    n = cfg.n_layers
    while n > 1 and free[d] < copies * export_bytes(cfg, n):
        n -= 1
    return d, n, free


def action_mask(sample, members=None):
    """The positions of ``sample``'s packed tokens whose logprob scores a
    generated token (a logprob sits one position before its token), for
    the sequences in ``members`` (a bool per sequence; all by default)."""
    act = np.zeros(sample.total_len("packed_input_ids"), bool)
    off, j = 0, 0
    for seqs in sample.seqlens["packed_input_ids"]:
        for n in seqs:
            if members is None or members[j]:
                act[off:off + n - 1] = ~sample.data["prompt_mask"][
                    off + 1:off + n]
            off, j = off + n, j + 1
    return act


def logprob_err(sample, members=None):
    """Mean |behaviour logprob - the trainer's recompute| over the
    generated tokens of ``members``."""
    act = action_mask(sample, members)
    return float(np.abs(sample.data["packed_logprobs"][act]
                        - sample.data["prox_logp"][act]).mean())


def async_rollout_phase(torch):
    """AReaL's async loop closed once on one card: a bf16 server behind the
    gserver manager, one rollout worker driving the math agent through
    chunked generation, and the trainer worker (``AsyncPPOTrainerWorker``)
    taking one step of an f32-master trainer on the stream: its buffer,
    the PPO graph, ``training_samples``, its HF export and the
    ``model_version`` announce; the manager flushes the server to version
    1 while rollouts are in flight and the interrupted rollouts finish at
    version 1."""
    import asyncio
    import dataclasses
    import os
    import shutil
    import tempfile
    import threading

    from areal_tpu_torch.agents.math_single_step import MathSingleStepAgent
    from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
    from areal_tpu_torch.api.dataset import DatasetUtility
    from areal_tpu_torch.api.model import (
        GenerationHyperparameters, PPOHyperparameters)
    from areal_tpu_torch.base import constants, name_resolve, names, recover
    from areal_tpu_torch.base.metrics import MetricLogger
    from areal_tpu_torch.datasets.prompt import MathCodePromptDataset
    from areal_tpu_torch.envs.math_code_single_step import MathCodeSingleStepEnv
    from areal_tpu_torch.gen.engine import GenerationEngine
    from areal_tpu_torch.gen.server import serve
    from areal_tpu_torch.ops.cuda import flash_attention as cuda_flash
    from areal_tpu_torch.ops.cuda import paged_attention as cuda_paged
    from areal_tpu_torch.system.gserver_manager import (
        GserverManager, GserverManagerConfig, serve_manager)
    from areal_tpu_torch.system.push_pull_stream import JsonPuller, JsonPusher
    from areal_tpu_torch.system.rollout_worker import RolloutWorker
    from areal_tpu_torch.system.stream_dataset import PullerStreamDataset
    from areal_tpu_torch.system.trainer_worker import (
        AsyncPPOTrainerWorker, TrainerControl)
    from areal_tpu_torch.train import batching
    from areal_tpu_torch.train.engine import OptimizerConfig, TrainEngine

    c = ASYNC_ROLLOUT
    exp, trial = "chip_smoke", "async_rollout"
    root_dir = os.path.dirname(os.path.abspath(__file__))
    full = qwen_1p5b_cfg()
    export_parent, n_layers, free = export_dir_and_depth(full, root_dir)
    cfg = dataclasses.replace(full, n_layers=n_layers)
    train_cfg = dataclasses.replace(cfg, remat_policy="full",
                                    loss_chunk_size=2048)
    spec = MicroBatchSpec(max_tokens_per_mb=c["mb_tokens"])
    deadline = time.time() + c["limit_s"]

    def wait(what, cond, poll=0.02):
        while not cond():
            if time.time() > deadline:
                raise AssertionError(f"async_rollout: {what} did not happen "
                                     f"within {c['limit_s']} s")
            time.sleep(poll)

    torch.cuda.reset_peak_memory_stats()
    name_resolve.reset()
    work = tempfile.mkdtemp(prefix="areal_async_rollout_", dir=export_parent)
    # the trainer worker's roots (weight sync, logs) live in the work dir
    old_fileroot = os.environ.get("AREAL_FILEROOT")
    constants.set_fileroot(work)
    constants.set_experiment_trial_names(exp, trial)
    log_dir = constants.get_log_root()
    # one seed-0 init: f32 masters for the trainer, their bf16 cast served
    trainer = TrainEngine(train_cfg, optimizer=OptimizerConfig(lr=1e-5),
                          device="cuda").init_random(0).setup_optimizer(100)
    eng = GenerationEngine(cfg, trainer.params, max_slots=32, max_seqlen=2048,
                           page_size=128, seed=0, device="cuda")
    srv = manager = stream = pusher = loop = None
    try:
        srv = serve(eng, "127.0.0.1", 0, decode_steps=DECODE_STEPS)
        name_resolve.add(names.gen_server(exp, trial, 0),
                         f"http://127.0.0.1:{srv.port}", replace=True)
        manager = GserverManager(GserverManagerConfig(
            experiment_name=exp, trial_name=trial,
            train_batch_size=c["train_batch_size"],
            max_head_offpolicyness=c["max_head_offpolicyness"],
            max_concurrent_rollouts=c["max_concurrent_rollouts"]))
        manager.discover_servers()
        serve_manager(manager, "127.0.0.1", 0)
        # traffic: 64 math prompts of 512 random tokens, each with a boxed
        # solution
        rng = np.random.default_rng(0)
        data_path = os.path.join(work, "math.jsonl")
        with open(data_path, "w") as f:
            for i in range(c["n_prompts"]):
                f.write(json.dumps({
                    "query_id": f"q{i}",
                    "prompt_ids": rng.integers(
                        0, cfg.vocab_size, c["prompt_len"]).tolist(),
                    "task": "math",
                    "solutions": [f"\\boxed{{{int(rng.integers(100))}}}"],
                }) + "\n")
        dataset = MathCodePromptDataset(
            util=DatasetUtility(seed=0, dp_rank=0, world_size=1),
            path=data_path)
        puller = JsonPuller("127.0.0.1", 0, default_timeout_ms=100)
        stream = PullerStreamDataset(exp, trial, 0,
                                     offline_dataset_size=len(dataset),
                                     puller=puller)
        pusher = JsonPusher("127.0.0.1", puller.port)
        worker = RolloutWorker(
            experiment_name=exp, trial_name=trial, worker_index=0,
            n_workers=1, n_pullers=1,
            agent=MathSingleStepAgent(gconfig=GenerationHyperparameters(
                n=c["group"], max_new_tokens=c["max_new_tokens"],
                temperature=1.0, top_p=1.0)),
            env=MathCodeSingleStepEnv(dataset.load_metadata()),
            dataset=dataset, new_tokens_per_chunk=c["new_tokens_per_chunk"],
            max_concurrent_tasks=c["max_concurrent_tasks"], pusher=pusher,
            manager_url=f"http://127.0.0.1:{manager.port}",
        )
        loop = asyncio.new_event_loop()
        threading.Thread(target=loop.run_forever, daemon=True,
                         name="rollout-worker").start()
        stop = threading.Event()
        collected = []

        def take(n=64, timeout=0.05):
            if run.done():
                run.result()   # the worker failed: raise its error
            got = stream.get_batch(n, timeout=timeout)
            collected.extend(got)
            return got

        class Tap:
            """The trainer worker's stream: records what it hands over,
            and the gate's staleness denials when the 8th group does."""

            def __init__(self):
                self.taken, self.denied_at_batch, self.t_batch = [], None, None

            def get_batch(self, n, timeout=0.1):
                if time.time() > deadline:
                    raise AssertionError("async_rollout: 8 streamed groups "
                                         "did not arrive in time")
                got = take(n, timeout)
                self.taken.extend(got)
                if (self.denied_at_batch is None
                        and len(self.taken) >= c["train_batch_size"]):
                    self.denied_at_batch = manager.counters["denied_staled"]
                    self.t_batch = time.perf_counter()
                return got

            def clear(self):
                return stream.clear()

        tap = Tap()
        hp = PPOHyperparameters(disable_value=True, adv_norm=True,
                                use_decoupled_loss=True, ppo_n_minibatches=2)
        trainer_worker = AsyncPPOTrainerWorker(
            experiment_name=exp, trial_name=trial, actor_engine=trainer,
            stream=tap, hp=hp,
            control=TrainerControl(total_train_steps=1,
                                   weight_sync_freq_steps=1,
                                   ckpt_freq_steps=None, ckpt_freq_secs=None),
            train_batch_size=c["train_batch_size"], mb_spec=spec,
            hf_family="qwen2", metric_logger=MetricLogger(log_dir),
            max_head_offpolicyness=c["max_head_offpolicyness"],
        )

        # the main path's run: every launch counted from here on
        cuda_paged.reset_launches()
        cuda_flash.reset_launches()
        t_start = time.perf_counter()
        run = asyncio.run_coroutine_threadsafe(
            worker.run_async(should_stop=stop.is_set), loop)

        # 1-5. the trainer worker's own step: it pulls 8 groups through the
        # tap into its staleness-ordered buffer, runs the graph (actor_inf
        # -> actor_train), bumps training_samples and publishes its export
        # in the background while rollouts are in flight
        stats = trainer_worker.run_step()
        t_step = time.perf_counter()
        if stats is None or tap.denied_at_batch is None:
            raise AssertionError("async_rollout: the trainer worker took no "
                                 "batch")
        denied_before_step = tap.denied_at_batch
        t_first_batch = tap.t_batch - t_start
        bad = {k: v for k, v in stats.items() if not np.isfinite(v)}
        if bad or stats["guard/step_ok"] != 1.0:
            raise AssertionError(f"async_rollout: PPO step stats {stats}")
        samples = tap.taken[:c["train_batch_size"]]
        batch = SequenceSample.gather(samples, keys=set(TRAIN_KEYS))
        n_inf = len(batching.split_into_micro_batches(
            batch, spec.n_mbs, spec.max_tokens_per_mb, 1))
        n_train = sum(len(batching.split_into_micro_batches(
            mb, spec.n_mbs, spec.max_tokens_per_mb, 1))
            for mb in batch.split(hp.ppo_n_minibatches))
        tokens = batch.total_len("packed_input_ids")
        if stats["n_tokens"] != tokens:
            raise AssertionError(f"async_rollout: the worker trained on "
                                 f"{stats['n_tokens']} tokens, the tapped "
                                 f"batch holds {tokens}")

        # the announce lands once the background export is committed
        path = os.path.join(constants.get_param_sync_root(), "v1")
        mv_key = names.model_version(exp, trial, "actor")

        def announced():
            try:
                return name_resolve.get(mv_key) == f"1:{path}"
            except name_resolve.NameEntryNotFoundError:
                return False

        wait("the v1 announce", announced, poll=0.01)
        t0 = time.perf_counter()
        export_s = t0 - t_step
        running = get(srv.port, "/metrics_json")["running"]
        if running <= 0:
            raise AssertionError("async_rollout: no request in flight to "
                                 "interrupt at the weight update")
        trainer_worker._join_publish()   # raises if the export failed
        trainer_worker.flush_stats()
        # 6. the manager's poll loop flushes the server
        wait("the weight update", lambda: manager.version == 1, poll=0.05)
        reload_s = time.perf_counter() - t0

        # 7. collect until the interrupted rollouts finished at version 1,
        # and a group's worth of sequences was generated wholly at it
        def spans():
            take()
            ends = [s for s in collected
                    if int(np.max(s.data["version_end"])) == 1]
            across = [s for s in ends
                      if int(np.min(s.data["version_start"])) == 0]
            at_v1 = sum(int((s.data["version_start"] == 1).sum())
                        for s in collected)
            return (len(ends) >= c["train_batch_size"] and across
                    and at_v1 >= c["group"])

        wait("8 groups at version 1, one across the update, and "
             f"{c['group']} sequences generated at version 1", spans)
        window = time.perf_counter() - t_start
        # the rates count what was streamed inside the window only: the
        # drain below finishes every group still in flight
        n_window = len(collected)
        gen_window = sum(int((~s.data["prompt_mask"]).sum())
                         for s in collected)
        stop.set()
        run.result(timeout=max(deadline - time.time(), 1))
        asyncio.run_coroutine_threadsafe(
            worker.drain(timeout=max(deadline - time.time(), 1)),
            loop).result()
        take()
        torch.cuda.synchronize()
        launches = cuda_paged.launches
        fwd, bwd = cuda_flash.fwd_launches, cuda_flash.bwd_launches
        metrics = get(srv.port, "/metrics_json")
        mgr = get(manager.port, "/metrics_json")
        # the worker's own records: step, training_samples, announce,
        # committed export, one metrics line, the graph
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            lines = [json.loads(ln) for ln in f if ln.strip()]
        levels = [[m.name for m in lvl]
                  for lvl in trainer_worker.executor.graph.levels]
        worker_ok = (
            trainer_worker.step == 1
            and name_resolve.get(names.training_samples(exp, trial))
            == str(c["train_batch_size"])
            and name_resolve.get(mv_key) == f"1:{path}"
            and recover.is_committed(path)
            and len(lines) == 1
            and all(np.isfinite(lines[0].get(k, np.nan)) for k in (
                "ppo/actor_loss", "ppo/grad_norm", "ppo/n_tokens"))
            and levels == [["actor_inf"], ["actor_train"]])
        if not worker_ok:
            raise AssertionError(
                f"async_rollout: trainer worker: step {trainer_worker.step}, "
                f"levels {levels}, metrics {lines}, model_version "
                f"{name_resolve.get(mv_key)}, committed "
                f"{recover.is_committed(path)}")
        # rollout logprobs against the trainer's recompute. The step's lr
        # is 0 (the first step of the warmup), so the weights it left are
        # version 0's, bit for bit: the batch's v0 tokens are held against
        # them as in the hand-wired step of earlier versions of this phase
        actor = trainer_worker.actor_if
        batch.update_(actor.inference(trainer, batch, spec))
        lp_err = logprob_err(batch)
        if not lp_err <= WEIGHT_SYNC_LP_TOL:
            raise AssertionError(f"async_rollout: rollout logprobs are "
                                 f"{lp_err} from the trainer's (limit "
                                 f"{WEIGHT_SYNC_LP_TOL})")
        # the reloaded 28 layers: tokens the server generated at version 1
        # against the trainer's recompute on the weights it exported
        v1 = [s for s in collected if (s.data["version_start"] == 1).any()]
        v1 = v1[:c["train_batch_size"]]
        v1_batch = SequenceSample.gather(v1, keys={
            "packed_input_ids", "prompt_mask", "packed_logprobs"})
        v1_batch.update_(actor.inference(trainer, v1_batch, spec))
        v1_members = np.concatenate([s.data["version_start"] == 1 for s in v1])
        v1_tokens = int(action_mask(v1_batch, v1_members).sum())
        lp_err_v1 = logprob_err(v1_batch, v1_members)
        if not lp_err_v1 <= WEIGHT_SYNC_LP_TOL:
            raise AssertionError(f"async_rollout: logprobs of tokens "
                                 f"generated at version 1 are {lp_err_v1} "
                                 f"from the trainer's (limit "
                                 f"{WEIGHT_SYNC_LP_TOL})")
    finally:
        if loop is not None:
            loop.call_soon_threadsafe(loop.stop)
        for end in (stream and stream.close, pusher and pusher.close,
                    manager and manager.stop, srv and srv.stop):
            if end:
                end()
        shutil.rmtree(work, ignore_errors=True)
        name_resolve.reset()
        if old_fileroot is None:
            os.environ.pop("AREAL_FILEROOT", None)
        else:
            os.environ["AREAL_FILEROOT"] = old_fileroot

    # hard checks, over every trajectory streamed (the batch's included)
    samples = collected
    for s in samples:
        lens = s.seqlens["packed_input_ids"][0]
        if not s.keys >= TRAJ_KEYS or len(lens) != c["group"] or (
                s.data["packed_input_ids"].shape[0] != sum(lens)) or (
                s.data["packed_logprobs"].shape[0] != sum(lens)) or not (
                np.isfinite(s.data["packed_logprobs"]).all()):
            raise AssertionError(f"async_rollout: bad trajectory {s.ids}: "
                                 f"{sorted(s.keys)} {lens}")
    bound = (c["max_head_offpolicyness"] + 1) * c["train_batch_size"]
    if denied_before_step <= 0 or not 0 < mgr["counters"]["max_running"] <= bound:
        raise AssertionError(f"async_rollout: the gate: {mgr['counters']}")
    if mgr["version"] != 1 or metrics["version"] != 1 or (
            mgr["counters"]["interrupted_requests"] <= 0):
        raise AssertionError(f"async_rollout: weight update: manager {mgr}, "
                             f"server {metrics}")
    faults = dict(push_drops=pusher.drop_cnt, stream_drops=stream.dropped,
                  requeued=worker.requeued_cnt, dropped=worker.dropped_cnt,
                  server_failures=worker.prm.stats["server_failures"],
                  client_retries=worker.prm.client.retries,
                  update_failures=mgr["counters"].get(
                      "weight_update_failures", 0),
                  buffer_stale=trainer_worker.telemetry_gauges()[
                      "buffer_dropped_stale"],
                  buffer_capacity=trainer_worker.telemetry_gauges()[
                      "buffer_dropped_capacity"])
    if any(faults.values()) or worker.n_tasks() or mgr["running"]:
        raise AssertionError(f"async_rollout: faults {faults}, tasks "
                             f"{worker.n_tasks()}, running {mgr['running']}")
    stats_e = eng.stats
    steps = stats_e["decode_steps"]
    if launches != cfg.n_layers * steps or stats_e["graph_replays"] <= 0 or (
            stats_e["graph_replays"] * DECODE_STEPS
            + stats_e["graph_captures"] != steps):
        raise AssertionError(f"async_rollout: paged_decode launched "
                             f"{launches} times over {steps} steps: {stats_e}")
    admission_graphed("async_rollout", stats_e, eng)
    L = cfg.n_layers
    if fwd != L * (n_inf + 2 * n_train) or bwd != L * n_train:
        raise AssertionError(
            f"async_rollout: flash launches fwd {fwd} bwd {bwd}; expected "
            f"{L * (n_inf + 2 * n_train)} and {L * n_train}")
    across = sum(1 for s in samples
                 if int(np.min(s.data["version_start"])) == 0
                 and int(np.max(s.data["version_end"])) == 1)
    n_seqs = sum(len(s.seqlens["packed_input_ids"][0]) for s in samples)
    gen_tokens = sum(
        int((~s.data["prompt_mask"]).sum()) for s in samples)
    hit, pre = stats_e["prefix_hit_tokens"], stats_e["prefill_tokens"]
    row = dict(
        layers=L, depth_cut_reason=(
            None if L == full.n_layers else
            f"two f32 exports of {full.n_layers} layers "
            f"({2 * export_bytes(full, full.n_layers) / 1e9:.1f} GB) do not "
            f"fit in {export_parent}"),
        free_gb={d: v / 1e9 for d, v in free.items()},
        export_dir=export_parent, export_gb=export_bytes(cfg, L) / 1e9,
        trajectories=len(samples), sequences=n_seqs,
        window_s=window, first_batch_s=t_first_batch,
        trajectories_in_window=n_window, gen_tokens_in_window=gen_window,
        trajectories_per_s=n_window / window,
        gen_tok_per_s=gen_window / window, gen_tokens=gen_tokens,
        server_gen_tokens=metrics["gen_tokens"],
        decode_s=stats_e["decode_s"], prefill_s=stats_e["prefill_s"],
        prefill_waves=stats_e["prefill_waves"],
        extend_programs=len(eng._jit_extend),
        commit_programs=len(eng._jit_commit),
        admit_capture_s=stats_e["admit_capture_s"],
        graph_pool_gb=stats_e["graph_pool_bytes"] / 1e9,
        decode_steps=steps, prefill_tokens=pre, prefix_hit_tokens=hit,
        prefix_hit_share=hit / max(hit + pre, 1),
        chunks=worker.prm.stats["chunks"],
        chunks_per_sequence=worker.prm.stats["chunks"] / max(n_seqs, 1),
        chunk_reasons={k: v for k, v in worker.prm.stats.items()
                       if k.startswith("chunks_")},
        gate_denials_staled=mgr["counters"].get("denied_staled", 0),
        gate_denials_capacity=mgr["counters"].get("denied_capacity", 0),
        gate_denials_before_step=denied_before_step,
        max_running_groups=mgr["counters"]["max_running"],
        running_bound=bound, allocated=mgr["counters"]["allocated"],
        worker_denied=worker.denied_cnt,
        interrupted_requests=mgr["counters"]["interrupted_requests"],
        trajectories_across_update=across,
        weight_update_s=metrics["weight_update_s"],
        weight_load_overlapped_s=metrics["weight_load_overlapped_s"],
        manager_flush_s=manager.last_weight_update_s,
        export_s=export_s, reload_s=reload_s,
        ppo_tokens=tokens, inference_mbs=n_inf, train_mbs=n_train,
        step_s=stats["timeperf/e2e"],
        trained_tok_per_s=tokens / stats["timeperf/e2e"],
        step_tflops_per_s=stats["tflops_per_sec"],
        logprob_mean_abs_err=lp_err,
        logprob_mean_abs_err_v1=lp_err_v1, v1_tokens_checked=v1_tokens,
        stats={k: stats[k] for k in ("actor_loss", "grad_norm",
                                     "importance_weight", "approx_kl")},
        paged_decode_launches=launches, flash_fwd_launches=fwd,
        flash_bwd_launches=bwd, graph_captures=stats_e["graph_captures"],
        graph_replays=stats_e["graph_replays"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        faults=faults,
    )
    emit(phase="async_rollout", **row)
    del trainer_worker, tap, trainer, eng
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------------------- #
# the system's own entry point: python -m areal_tpu_torch.apps.main async-ppo
# --------------------------------------------------------------------------- #

ASYNC_PPO = dict(
    n_prompts=64, prompt_len=512, group=4, max_new_tokens=512,
    new_tokens_per_chunk=256, train_batch_size=8, max_head_offpolicyness=4,
    max_concurrent_tasks=48, max_slots=32, max_seqlen=2048, mb_tokens=8192,
    total_train_steps=2, ppo_n_minibatches=2, limit_s=600.0,
    # disk at the peak, in f32 exports of the model: three weight-sync
    # snapshots (v0 is pruned only once v2 is loaded) plus the recover
    # checkpoint (params and two AdamW moments), one staging copy spare
    export_copies=7,
)


def live_group_members(pgid):
    """Processes of process group ``pgid`` that are still running (a zombie
    has exited: it only waits to be reaped)."""
    import os

    alive = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if int(fields[2]) == pgid and fields[0] not in ("Z", "X"):
            alive.append(f"{pid} {fields[0]} {cmd[:120]}")
    return alive


def async_ppo_phase(torch, keep_logs=None):
    """The port's normal entry point as a user runs it: ``python -m
    areal_tpu_torch.apps.main async-ppo`` with dotted overrides, at the
    1.5B widths, with the generation server and the trainer on the card
    as two CUDA processes (the manager and the rollout worker on the
    host). Two trainer steps, a weight publish after each, a committed
    recover checkpoint at step 2; then every record the run leaves is
    checked, and the checkpoint is loaded into a fresh trainer on the card
    and held against the v2 export."""
    import dataclasses
    import os
    import shutil
    import signal
    import tempfile

    import areal_tpu_torch
    from areal_tpu_torch.base import recover
    from areal_tpu_torch.models import hf as hf_conv
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.train.engine import OptimizerConfig, TrainEngine

    c = ASYNC_PPO
    exp, trial = "chip_smoke", "async_ppo"
    root_dir = os.path.dirname(os.path.abspath(__file__))
    full = qwen_1p5b_cfg()
    parent, n_layers, free = export_dir_and_depth(full, root_dir,
                                                  c["export_copies"])
    cfg = dataclasses.replace(full, n_layers=n_layers)
    work = tempfile.mkdtemp(prefix="areal_async_ppo_", dir=parent)
    fileroot = os.path.join(work, "root")
    rng = np.random.default_rng(0)
    data_path = os.path.join(work, "math.jsonl")
    with open(data_path, "w") as f:
        for i in range(c["n_prompts"]):
            f.write(json.dumps({
                "query_id": f"q{i}",
                "prompt_ids": rng.integers(
                    0, cfg.vocab_size, c["prompt_len"]).tolist(),
                "task": "math",
                "solutions": [f"\\boxed{{{int(rng.integers(100))}}}"],
            }) + "\n")
    arch = {f: getattr(cfg, f) for f in (
        "n_layers", "n_q_heads", "n_kv_heads", "head_dim", "hidden_dim",
        "intermediate_dim", "vocab_size", "use_attention_bias", "dtype")}
    overrides = [
        f"experiment_name={exp}", f"trial_name={trial}",
        f"fileroot={fileroot}", "seed=1", "hf_family=qwen2",
        "dataset.name=math_code_prompt", f"dataset.path={data_path}",
        f"actor.arch={json.dumps(arch)}",
        'actor.overrides={"remat_policy": "full", "loss_chunk_size": 2048}',
        "actor.optimizer.lr=1e-05", "use_ref_model=false",
        "gen.device=", "trainer_device=", "gen.n_servers=1",
        f"gen.max_slots={c['max_slots']}", f"gen.max_seqlen={c['max_seqlen']}",
        f"gen.decode_steps_per_chunk={DECODE_STEPS}",
        "rollout.n_workers=1",
        f"rollout.max_concurrent_tasks={c['max_concurrent_tasks']}",
        f"rollout.new_tokens_per_chunk={c['new_tokens_per_chunk']}",
        f"manager.max_head_offpolicyness={c['max_head_offpolicyness']}",
        "gconfig=" + json.dumps({"n": c["group"],
                                 "max_new_tokens": c["max_new_tokens"],
                                 "temperature": 1.0}),
        f"train_batch_size={c['train_batch_size']}",
        f"max_tokens_per_mb={c['mb_tokens']}",
        "ppo=" + json.dumps({"disable_value": True, "adv_norm": True,
                             "use_decoupled_loss": True,
                             "ppo_n_minibatches": c["ppo_n_minibatches"]}),
        "control=" + json.dumps({
            "total_train_steps": c["total_train_steps"],
            "weight_sync_freq_steps": 1, "ckpt_freq_steps": 2,
            "ckpt_freq_secs": None}),
    ]
    pkg_parent = os.path.dirname(os.path.dirname(
        os.path.abspath(areal_tpu_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [pkg_parent] + [p for p in [env.get("PYTHONPATH")] if p])
    log_path = os.path.join(work, "async_ppo.log")
    torch.cuda.empty_cache()
    t0 = time.time()
    rc = None
    try:
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "areal_tpu_torch.apps.main",
                 "async-ppo", *overrides],
                cwd=work, env=env, stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True,
            )
            try:
                rc = proc.wait(timeout=c["limit_s"])
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        wall = time.time() - t0
        # every process of the run is gone (they share its process group); the
        # multiprocessing resource tracker may take a moment after the
        # launcher
        stray = live_group_members(proc.pid)
        t_gone = time.time() + 15
        while stray and time.time() < t_gone:
            time.sleep(0.2)
            stray = live_group_members(proc.pid)
        if stray:
            os.killpg(proc.pid, signal.SIGKILL)
        if keep_logs:
            os.makedirs(keep_logs, exist_ok=True)
            shutil.copy(log_path, os.path.join(keep_logs, "async_ppo.log"))
        with open(log_path) as f:
            tail = f.read()[-6000:]
        if rc != 0 or stray:
            raise AssertionError(
                f"async_ppo: the entry point exited {rc} after {wall:.1f} s "
                f"(limit {c['limit_s']} s), processes left: {stray}; log "
                f"tail:\n{tail}")
        save_root = os.path.join(fileroot, "checkpoints", exp, trial)
        log_root = os.path.join(fileroot, "logs", exp, trial)
        with open(os.path.join(log_root, "metrics.jsonl")) as f:
            lines = [json.loads(ln) for ln in f if ln.strip()]
        keys = ("ppo/actor_loss", "ppo/grad_norm", "ppo/n_tokens")
        if len(lines) != c["total_train_steps"] or not all(
                np.isfinite(ln.get(k, np.nan)) for ln in lines for k in keys):
            raise AssertionError(f"async_ppo: metrics.jsonl {lines}")
        sync_root = os.path.join(save_root, "weight_sync")
        versions = sorted(os.listdir(sync_root))
        if versions != ["v1", "v2"]:
            raise AssertionError(f"async_ppo: weight-sync root {versions}")
        with open(os.path.join(log_root, "gen_server_0.json")) as f:
            srv = json.load(f)
        steps = srv["engine_decode_steps"]
        if srv["version"] != 2 or steps <= 0 or (
                srv["graph_replays"] * DECODE_STEPS + srv["graph_captures"]
                != steps) or (srv["kernel_launches"]["paged_decode"]
                              != cfg.n_layers * steps):
            raise AssertionError(f"async_ppo: server dump {srv}")
        admission_graphed("async_ppo", {
            k: srv[f"engine_{k}"] for k in (
                "extend_replays", "extend_captures", "prefill_waves",
                "commit_replays", "commit_captures", "commit_waves")})
        ckpt = os.path.join(save_root, "recover", "trainer", "actor")
        manifest = recover.read_manifest(ckpt)
        info = recover.load(os.path.join(save_root, "recover"))
        opt_steps = c["total_train_steps"] * c["ppo_n_minibatches"]
        if manifest is None or manifest["version"] != 2 or (
                manifest["step"] != opt_steps) or info is None or (
                info.recover_start.global_step != 2) or (
                info.samples_consumed != 2 * c["train_batch_size"]):
            raise AssertionError(f"async_ppo: recover checkpoint {manifest}, "
                                 f"info {info}")
        # the checkpoint in a fresh trainer on the card: its params equal
        # the v2 export, bit for bit
        train_cfg = dataclasses.replace(cfg, remat_policy="full",
                                        loss_chunk_size=2048)
        t1 = time.perf_counter()
        fresh = TrainEngine(train_cfg, optimizer=OptimizerConfig(lr=1e-5),
                            device="cuda").init_random(1)
        fresh.setup_optimizer(c["total_train_steps"])
        fresh.load_checkpoint(ckpt)
        load_s = time.perf_counter() - t1
        got = tfm.params_to_numpy(fresh.params)
        _, want = hf_conv.load_hf_checkpoint(os.path.join(sync_root, "v2"))
        flat_g = dict(recover.tree_leaves_with_path(got))
        flat_w = dict(recover.tree_leaves_with_path(want))
        diff = [k for k in flat_w if not np.array_equal(flat_w[k], flat_g[k])]
        if set(flat_g) != set(flat_w) or diff or fresh.version != 2:
            raise AssertionError(f"async_ppo: checkpoint vs v2 export differ "
                                 f"on {diff[:5]} (version {fresh.version})")
        ckpt_gb = sum(os.path.getsize(os.path.join(ckpt, f))
                      for f in os.listdir(ckpt)) / 1e9
        v1_commit = os.path.getmtime(
            os.path.join(sync_root, "v1", recover.CKPT_MANIFEST))
        del fresh, got, want, flat_g, flat_w
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    step_s = [ln["ppo/timeperf/e2e"] for ln in lines]
    n_tok = [ln["ppo/n_tokens"] for ln in lines]
    t_run = lines[-1]["time"] - t0
    row = dict(
        layers=cfg.n_layers, depth_cut_reason=(
            None if cfg.n_layers == full.n_layers else
            f"{c['export_copies']} f32 exports of {full.n_layers} layers "
            f"({c['export_copies'] * export_bytes(full, full.n_layers) / 1e9:.1f}"
            f" GB) do not fit in {parent}"),
        free_gb={d: v / 1e9 for d, v in free.items()},
        wall_s=wall, rc=rc,
        trajectories_trained=info.samples_consumed,
        trajectories_per_s=info.samples_consumed / t_run,
        trajectories_per_s_steady=c["train_batch_size"] / (
            lines[1]["time"] - lines[0]["time"]),
        step_s=step_s, n_tokens=n_tok,
        trained_tok_per_s=[n / s for n, s in zip(n_tok, step_s)],
        stats=[{k: ln[f"ppo/{k}"] for k in (
            "actor_loss", "grad_norm", "importance_weight", "approx_kl")}
            for ln in lines],
        export_s=v1_commit - lines[0]["time"],
        weight_updates=srv["n_weight_updates"],
        reload_s=srv["weight_load_overlapped_s"] / max(
            srv["n_weight_updates"], 1),
        weight_update_s=srv["weight_update_s"] / max(
            srv["n_weight_updates"], 1),
        ckpt_gb=ckpt_gb, ckpt_load_s=load_s,
        decode_steps=steps, graph_replays=srv["graph_replays"],
        graph_captures=srv["graph_captures"],
        server_gen_tokens=srv["gen_tokens"],
        server_decode_s=srv["engine_decode_s"],
        server_prefill_s=srv["engine_prefill_s"],
        server_prefill_waves=srv["engine_prefill_waves"],
        server_admit_capture_s=srv["engine_admit_capture_s"],
        server_graph_pool_gb=srv["engine_graph_pool_bytes"] / 1e9,
        paged_decode_launches=srv["kernel_launches"]["paged_decode"],
        flash_fwd_launches=sum(ln["ppo/kernel/flash_fwd_launches"]
                               for ln in lines),
        flash_bwd_launches=sum(ln["ppo/kernel/flash_bwd_launches"]
                               for ln in lines),
        trainer_peak_mem_gb=max(ln.get("ppo/hbm_peak_bytes_in_use", 0)
                                for ln in lines) / 1e9,
        server_peak_mem_gb=srv.get("hbm_peak_bytes_in_use", 0) / 1e9,
    )
    emit(phase="async_ppo", **row)
    return row


# --------------------------------------------------------------------------- #
# training: parity (tiny f32 model, card vs CPU) and the 1.5B GRPO round
# --------------------------------------------------------------------------- #

# train_parity tolerances. Loss and grad norm: rtol 1e-4 (f32 on both
# sides with TF32 off; summation order differs between cuBLAS and the CPU
# and between the flash kernels and the plain version). Weights after two
# steps: atol of 1% of lr per step, because Adam divides by sqrt(v), so
# summation-order noise in near-zero gradients grows up to ~lr in the update.
TRAIN_PARITY_LR = 1e-3
TRAIN_PARITY_TOL = dict(loss_rtol=1e-4, weight_atol=0.01 * TRAIN_PARITY_LR * 2)


def rollout_sample(rng, *, n_prompts, group, prompt_len, resp_lo, resp_hi,
                   vocab, group_budget=None):
    """A GRPO rollout batch made from ``rng``: ``n_prompts`` items, each one
    prompt shared by ``group`` sequences, with prompt masks, token-aligned
    behaviour logprobs and a 0/1 reward per sequence. ``group_budget``
    caps an item's tokens: an item (a GRPO group) is never split across
    micro-batches, so its response lengths, drawn in [resp_lo, resp_hi],
    shrink in proportion until the group fits."""
    from areal_tpu_torch.api.data import SequenceSample

    seqlens, ids, pm, lps = [], [], [], []
    for _ in range(n_prompts):
        prompt = rng.integers(0, vocab, size=prompt_len)
        resp = rng.integers(resp_lo, resp_hi + 1, size=group)
        if group_budget is not None:
            room = group_budget - group * prompt_len
            if resp.sum() > room:
                resp = np.maximum(resp * room // resp.sum(), 1)
        inner = []
        for glen in resp.tolist():
            n = prompt_len + glen
            inner.append(n)
            ids.append(np.concatenate([prompt,
                                       rng.integers(0, vocab, size=glen)]))
            pm.append(np.r_[np.ones(prompt_len, bool), np.zeros(glen, bool)])
            lp = np.zeros(n, np.float32)
            lp[prompt_len - 1:n - 1] = -rng.exponential(1.0, size=glen)
            lps.append(lp)
        seqlens.append(inner)
    n_seqs = n_prompts * group
    scalar = [[1] * group for _ in range(n_prompts)]
    return SequenceSample(
        keys={"packed_input_ids", "prompt_mask", "packed_logprobs", "rewards"},
        ids=list(range(n_prompts)),
        seqlens={"packed_input_ids": seqlens, "prompt_mask": seqlens,
                 "packed_logprobs": seqlens, "rewards": scalar},
        data={"packed_input_ids": np.concatenate(ids).astype(np.int64),
              "prompt_mask": np.concatenate(pm),
              "packed_logprobs": np.concatenate(lps),
              "rewards": rng.integers(0, 2, size=n_seqs).astype(np.float32)},
    )


def tree_leaves(tfm, tree):
    out = []
    tfm.tree_map(out.append, tree)
    return out


def train_parity_phase(torch):
    """A tiny f32 model trained two SFT steps on the card and on the CPU
    from the same numpy params and batch."""
    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.api.model import make_interface
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.models.config import ModelConfig
    from areal_tpu_torch.train.engine import OptimizerConfig, TrainEngine

    cfg = ModelConfig(n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=64,
                      hidden_dim=128, intermediate_dim=256, vocab_size=512,
                      use_attention_bias=True, dtype="float32",
                      loss_chunk_size=100)
    host = tfm.params_to_numpy(tfm.init_params(cfg, seed=5, device="cpu"))
    sample = rollout_sample(np.random.default_rng(5), n_prompts=4, group=2,
                            prompt_len=40, resp_lo=20, resp_hi=90, vocab=512)
    spec = MicroBatchSpec(max_tokens_per_mb=256)
    sft = make_interface("sft")
    stats, weights = {}, {}
    for dev in ("cuda", "cpu"):
        eng = TrainEngine(cfg, optimizer=OptimizerConfig(lr=TRAIN_PARITY_LR),
                          device=dev).load_params(host).setup_optimizer(100)
        stats[dev] = [sft.train_step(eng, sample, spec) for _ in range(2)]
        weights[dev] = tfm.params_to_numpy(eng.params)
    worst = {}
    for k in ("loss", "grad_norm"):
        for step, (a, b) in enumerate(zip(stats["cuda"], stats["cpu"])):
            rel = abs(a[k] - b[k]) / abs(b[k])
            worst[k] = max(worst.get(k, 0.0), rel)
            if not rel <= TRAIN_PARITY_TOL["loss_rtol"]:
                raise AssertionError(f"train_parity step {step} {k}: cuda "
                                     f"{a[k]} vs cpu {b[k]}")
    w_err = 0.0
    for a, b in zip(tree_leaves(tfm, weights["cuda"]),
                    tree_leaves(tfm, weights["cpu"])):
        w_err = max(w_err, float(np.abs(a - b).max()))
    if not w_err <= TRAIN_PARITY_TOL["weight_atol"]:
        raise AssertionError(f"train_parity weights differ by {w_err}")
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        tree_leaves(tfm, weights["cpu"]), tree_leaves(tfm, host)))
    if not moved > 10 * w_err:
        raise AssertionError(f"train_parity: weights moved only {moved}")
    emit(phase="train_parity", steps=2, n_mbs=stats["cuda"][0]["n_mbs"],
         **{f"{k}_{dev}": [s[k] for s in stats[dev]]
            for k in ("loss", "grad_norm") for dev in ("cuda", "cpu")},
         loss_rel_err=worst["loss"], grad_norm_rel_err=worst["grad_norm"],
         weight_max_abs_err=w_err, weight_max_move=moved,
         tol=TRAIN_PARITY_TOL)


def train_phase(torch, profile=False):
    """Critic-free GRPO rounds of the PPO actor at the 1.5B profile's full
    width (random f32 master weights from seed 0, bf16 compute, full remat,
    chunked loss): inference (proximal logprobs), then train_step (two
    minibatches = two optimizer steps). A first round takes the one-time
    costs (Adam moments, cuBLAS workspaces, allocator growth); the second,
    on the same batch, is the measured and counted run. Both go through the
    flash kernels."""
    import dataclasses

    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.api.model import PPOHyperparameters, make_interface
    from areal_tpu_torch.ops.cuda import flash_attention as cuda_flash
    from areal_tpu_torch.train import batching
    from areal_tpu_torch.train.engine import OptimizerConfig, TrainEngine

    cfg = dataclasses.replace(qwen_1p5b_cfg(), remat_policy="full",
                              loss_chunk_size=2048)
    spec = MicroBatchSpec(max_tokens_per_mb=8192)
    hp = PPOHyperparameters(disable_value=True, group_adv_norm=True,
                            use_decoupled_loss=True, ppo_n_minibatches=2)

    def batch():
        return rollout_sample(np.random.default_rng(0), n_prompts=2, group=8,
                              prompt_len=512, resp_lo=256, resp_hi=1024,
                              vocab=cfg.vocab_size,
                              group_budget=spec.max_tokens_per_mb)

    sample = batch()
    tokens = int(sum(sum(inner) for inner in
                     sample.seqlens["packed_input_ids"]))
    # micro-batch counts the launch checks expect, from the same splitter
    n_inf = len(batching.split_into_micro_batches(
        sample, spec.n_mbs, spec.max_tokens_per_mb, 1))
    n_train = sum(
        len(batching.split_into_micro_batches(
            mb, spec.n_mbs, spec.max_tokens_per_mb, 1))
        for mb in sample.split(hp.ppo_n_minibatches))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = TrainEngine(cfg, optimizer=OptimizerConfig(lr=1e-5),
                      device="cuda").init_random(0).setup_optimizer(100)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    actor = make_interface("ppo_actor", hp=hp)

    def grpo_round(sample):
        t0 = time.perf_counter()
        sample.update_(actor.inference(eng, sample, spec))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stats = actor.train_step(eng, sample, spec)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        bad = {k: v for k, v in stats.items() if not np.isfinite(v)}
        if bad or not np.isfinite(sample.data["prox_logp"]).all() or not (
                np.isfinite(sample.data["advantages"]).all()):
            raise AssertionError(f"train: non-finite stats or outputs {bad}")
        if stats["guard/step_ok"] != 1.0:
            raise AssertionError(f"train: the guard skipped a step: {stats}")
        return stats, t1 - t0, t2 - t1

    _, first_inf_s, first_train_s = grpo_round(sample)
    probe = eng.params["layers"][0]["attn"]["wq"].detach().clone()
    version0, step0 = eng.version, eng._step
    prof = None
    if profile:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    # the main path's run: every launch counted from here on
    cuda_flash.reset_launches()
    stats, inf_s, train_s = grpo_round(batch())
    if prof is not None:
        prof.__exit__(None, None, None)
    fwd, bwd = cuda_flash.fwd_launches, cuda_flash.bwd_launches

    # the reference bumps version once per train_step (one per PPO round),
    # and takes one optimizer step per minibatch
    if eng.version != version0 + 1 or eng._step != step0 + 2:
        raise AssertionError(f"train: version {eng.version} steps {eng._step}")
    if torch.equal(eng.params["layers"][0]["attn"]["wq"], probe):
        raise AssertionError("train: weights did not move in two steps")
    L = cfg.n_layers
    if fwd != L * (n_inf + 2 * n_train) or bwd != L * n_train:
        raise AssertionError(
            f"train: flash launches fwd {fwd} bwd {bwd}; expected "
            f"{L * (n_inf + 2 * n_train)} and {L * n_train} for {n_inf} "
            f"inference and {n_train} train micro-batches of {L} layers"
        )
    row = dict(
        tokens=tokens, sequences=16, inference_mbs=n_inf, train_mbs=n_train,
        init_s=init_s, first_round_inference_s=first_inf_s,
        first_round_train_step_s=first_train_s,
        inference_s=inf_s, train_step_s=train_s,
        s_per_optimizer_step=train_s / 2,
        trained_tok_per_s=tokens / train_s,
        inference_tok_per_s=tokens / inf_s,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        flash_fwd_launches=fwd, flash_bwd_launches=bwd,
        stats={k: stats[k] for k in ("actor_loss", "grad_norm",
                                     "importance_weight", "approx_kl", "lr")},
    )
    if prof is not None:
        row["profile"] = device_profile(
            prof, inf_s + train_s, {"flash_fwd": "flash_fwd_v4",
                                    "flash_dq": "flash_dq_v4",
                                    "flash_dkdv": "flash_dkdv_v4",
                                    "flash_delta": "flash_delta"})
    emit(phase="train", **row)
    del eng, actor, probe
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------------------- #
# sync PPO: generation on the trainer's params, and the in-process entry points
# --------------------------------------------------------------------------- #

SYNC_PPO = dict(n_prompts=8, prompt_len=512, n=4, max_new=256, mb_tokens=8192,
                entry_layers=2)


class PromptSet:
    """Prompt samples for the sync-PPO worker, graded against a boxed
    solution by the math reward."""

    def __init__(self, prompts):
        self.prompts = prompts
        self.metadata = {f"q{i}": {"solutions": ["\\boxed{7}"]}
                         for i in range(len(prompts))}

    def __len__(self):
        return len(self.prompts)

    def __getitem__(self, i):
        from areal_tpu_torch.api.data import SequenceSample

        ids = np.asarray(self.prompts[i], np.int64)
        return SequenceSample(keys={"packed_prompts"}, ids=[f"q{i}"],
                              seqlens={"packed_prompts": [[len(ids)]]},
                              data={"packed_prompts": ids})


def sync_gen_parity(torch):
    """A tiny f32 model's SyncGenerator greedy tokens on the card (prefill
    through the flash kernel, decode from a CUDA graph) and on the CPU
    (plain, eager) must be equal, token for token."""
    from areal_tpu_torch.api.model import GenerationHyperparameters
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.models.config import ModelConfig
    from areal_tpu_torch.train.engine import TrainEngine
    from areal_tpu_torch.train.generation import SyncGenerator

    cfg = ModelConfig(n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=64,
                      hidden_dim=128, intermediate_dim=256, vocab_size=512,
                      use_attention_bias=True, dtype="float32")
    host = tfm.params_to_numpy(tfm.init_params(cfg, seed=7, device="cpu"))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, n).tolist() for n in (1, 9, 40, 70)]
    ghp = GenerationHyperparameters(n=2, max_new_tokens=24, greedy=True,
                                    min_new_tokens=2, stop_token_ids=[3, 77])
    out, stats = {}, {}
    for dev in ("cuda", "cpu"):
        gen = SyncGenerator(TrainEngine(cfg, device=dev).load_params(host))
        out[dev] = [o for seed in (0, 1)
                    for g in gen.generate(prompts, ghp, seed=seed) for o in g]
        stats[dev] = dict(gen.stats)
    lp_err = 0.0
    for a, b in zip(out["cuda"], out["cpu"]):
        if not np.array_equal(a.tokens, b.tokens) or a.no_eos != b.no_eos:
            raise AssertionError(f"sync_ppo parity: cuda {a.tokens} != cpu "
                                 f"{b.tokens}")
        lp_err = max(lp_err, float(np.abs(a.gen_logprobs
                                          - b.gen_logprobs).max()))
    st = stats["cuda"]
    if not (st["graph_captures"] == 1 and st["graph_replays"]
            + st["graph_captures"] == st["decode_steps"] == 2 * 23):
        raise AssertionError(f"sync_ppo parity: card graphs {st}")
    return dict(sequences=len(out["cpu"]), token_exact=True,
                gen_logprob_max_abs_err=lp_err,
                stopped=sum(not o.no_eos for o in out["cpu"]))


def sync_gen_sampling(torch, device="cuda"):
    """The graphed sampler's randomness, at a tiny f32 model whose every
    position gives the same logits (all embedding rows equal, so every
    hidden state is the same): 64 rows x 128 tokens at temperature 1, no
    stop. One seed twice gives the same tokens and another seed others;
    the token counts hold to softmax(logits) (chi-square, df 15, limit 45,
    p ~ 1e-4, as ``fused_chi_square``); and a row's consecutive tokens are
    equal as often as independent draws are (sum p^2 of the pairs, within
    6 sd): a replay that drew the last step's numbers again would repeat
    its token nearly always."""
    from areal_tpu_torch.api.model import GenerationHyperparameters
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.models.config import ModelConfig
    from areal_tpu_torch.train.engine import TrainEngine
    from areal_tpu_torch.train.generation import SyncGenerator

    V, rows, new = 16, 64, 128
    cfg = ModelConfig(n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=64,
                      hidden_dim=128, intermediate_dim=256, vocab_size=V,
                      dtype="float32")
    host = tfm.params_to_numpy(tfm.init_params(cfg, seed=11, device="cpu"))
    host["embed"]["weight"][:] = host["embed"]["weight"][:1]
    host["head"]["weight"] *= 5.0       # logits ~ N(0, 1.1): p far from flat
    cpu = tfm.params_from_numpy(host, device="cpu")
    with torch.no_grad():
        logits, _ = tfm.prefill(cpu, cfg, tfm.KVCache.empty(cfg, 1, 64,
                                                              device="cpu"),
                                torch.zeros(1, 64, dtype=torch.int64),
                                torch.ones(1, dtype=torch.int32))
    p = torch.softmax(logits[0].double(), -1).numpy()
    gen = SyncGenerator(TrainEngine(cfg, device=device).load_params(host))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, V, 5).tolist() for _ in range(8)]
    ghp = GenerationHyperparameters(n=rows // 8, max_new_tokens=new,
                                    temperature=1.0)
    runs = {}
    for name, seed in (("a", 5), ("again", 5), ("b", 6)):
        outs = [o for g in gen.generate(prompts, ghp, seed=seed) for o in g]
        if any(len(o.gen_logprobs) != new for o in outs):
            raise AssertionError("sync_ppo sampling: a row stopped early")
        runs[name] = (np.stack([o.tokens[5:] for o in outs]),
                      np.stack([o.gen_logprobs for o in outs]))
    tok, lp = runs["a"]
    if not (np.array_equal(tok, runs["again"][0])
            and np.array_equal(lp, runs["again"][1])):
        raise AssertionError("sync_ppo sampling: one seed, two draws")
    if np.array_equal(tok, runs["b"][0]):
        raise AssertionError("sync_ppo sampling: two seeds, one draw")
    lp_err = float(np.abs(lp - np.log(p[tok])).max())
    if not lp_err < 1e-3:
        raise AssertionError(f"sync_ppo sampling: gen_logprobs off "
                             f"log softmax by {lp_err}")
    n = tok.size
    counts = np.bincount(tok.ravel(), minlength=V)
    chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
    q = float((p ** 2).sum())
    pairs = tok[:, 1:] == tok[:, :-1]
    z = float((pairs.sum() - pairs.size * q)
              / np.sqrt(pairs.size * q * (1 - q)))
    if not (chi2 < 45.0 and abs(z) < 6.0):
        raise AssertionError(f"sync_ppo sampling: chi-square {chi2}, "
                             f"repeats z {z} (share {pairs.mean()}, "
                             f"independent draws {q})")
    st = gen.stats
    if device == "cuda" and not (
            st["graph_captures"] == 1
            and st["graph_replays"] + st["graph_captures"]
            == st["decode_steps"] == 3 * (new - 1)):
        raise AssertionError(f"sync_ppo sampling: card graphs {st}")
    return dict(draws=n, chi_square=chi2, repeat_share=float(pairs.mean()),
                independent_repeat_share=q, repeat_z=z,
                gen_logprob_max_abs_err=lp_err, same_seed_equal=True)


def prefill_flash_check(torch, params, cfg, expanded, n_rows):
    """SyncGenerator's prefill (``pad_batch`` layout) on the card, every
    layer's flash output held against the plain version (segment by
    segment, ``flash_plain_sliced``) on the q/k/v that layer gave the
    kernel, under FLASH_TOL. These launches are checks: they are not the
    main path's."""
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.ops import attention as attn_ops
    from areal_tpu_torch.train.generation import pad_batch

    ids, plens, _ = pad_batch(expanded, n_rows)
    B, Sp = ids.shape
    seen = []
    real = attn_ops.packed_attention

    def spy(q, k, v, seg, **kw):
        out = real(q, k, v, seg, **kw)
        seen.append((q, k, v, seg, kw, out))
        return out

    attn_ops.packed_attention = spy
    try:
        with torch.no_grad():
            tfm.prefill(params, cfg,
                        tfm.KVCache.empty(cfg, B, Sp, device="cuda"),
                        torch.from_numpy(ids).to("cuda"),
                        torch.from_numpy(plens).to("cuda"))
    finally:
        attn_ops.packed_attention = real
    if len(seen) != cfg.n_layers:
        raise AssertionError(f"prefill: {len(seen)} attention calls")
    worst = (0.0, 0.0)
    for li, (q, k, v, seg, kw, out) in enumerate(seen):
        want, _ = flash_plain_sliced(torch, q, k, v, seg, seg.cpu().numpy(),
                                     kw["softmax_scale"] or q.shape[-1] ** -0.5,
                                     kw, 4096)
        err, over = flash_compare(torch, out, want, "bfloat16")
        if not (np.isfinite(over) and over <= 1.0):
            raise AssertionError(
                f"prefill {B} x {Sp} layer {li}: |flash - plain| reaches "
                f"{over} x its limit {FLASH_TOL['bfloat16']}; max abs err "
                f"{err}")
        worst = max(worst, (over, err))
    return dict(rows=B, sp=Sp, padding_rows=B - len(expanded),
                plens_min=int(plens.min()), layers=len(seen),
                max_abs_err=worst[1], err_over_tol=worst[0])


def sync_ppo_phase(torch, profile=False):
    """Sync PPO at the 1.5B profile's widths, in this process: (a) the
    SyncGenerator on the trainer's f32 masters (cast to bf16 once per
    call), 8 prompts of 512 tokens x 4 samples, 256 new tokens, twice with
    two seeds; (b) two ``SyncPPOTrainerWorker.run_step``s (PPO with a ref
    engine and the math reward) through the same generator; (c) the
    ``sft``, ``rw``, ``sync-ppo`` and ``profile`` entry points through
    ``main.main`` at 2 layers of the same widths, on the card.
    ``profile`` traces a third generation call (after the counted two)
    with ``torch.profiler`` and reports device time by kernel."""
    import contextlib
    import gc
    import io
    import os
    import shutil
    import tempfile

    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.api.model import (GenerationHyperparameters,
                                           PPOHyperparameters)
    from areal_tpu_torch.apps import launcher
    from areal_tpu_torch.apps import main as entry
    from areal_tpu_torch.base import constants
    from areal_tpu_torch.experiments.config import ModelSpec
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.ops.cuda import flash_attention as cuda_flash
    from areal_tpu_torch.system.sync_trainer import SyncPPOTrainerWorker
    from areal_tpu_torch.system.trainer_worker import TrainerControl
    from areal_tpu_torch.train.generation import SyncGenerator

    P = SYNC_PPO
    parity = sync_gen_parity(torch)
    parity["sampling"] = sync_gen_sampling(torch)
    overrides = {"remat_policy": "full", "loss_chunk_size": 2048}
    spec = ModelSpec(arch=dict(QWEN_1P5B_ARCH), overrides=overrides)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = launcher._load_engine(spec, total_steps=100)   # "" = the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg, L = eng.cfg, eng.cfg.n_layers
    if eng.device.type != "cuda":
        raise AssertionError(f"sync_ppo: the engine is on {eng.device}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, P["prompt_len"]).tolist()
               for _ in range(P["n_prompts"])]
    ghp = GenerationHyperparameters(n=P["n"], max_new_tokens=P["max_new"],
                                    temperature=1.0)
    B, steps = P["n_prompts"] * P["n"], P["max_new"] - 1

    # (a) generation, counted from here on
    gen = SyncGenerator(eng)
    cuda_flash.reset_launches()
    calls = []
    for seed in (1, 2):
        fwd0 = cuda_flash.fwd_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        groups = gen.generate(prompts, ghp, seed=seed)
        calls.append(dict(groups=groups, wall_s=time.perf_counter() - t0,
                          flash_fwd=cuda_flash.fwd_launches - fwd0,
                          stats=dict(gen.stats), **gen.last_call))
    gen_fwd = cuda_flash.fwd_launches
    for i, c in enumerate(calls):
        outs = [o for g in c["groups"] for o in g]
        if len(c["groups"]) != P["n_prompts"] or len(outs) != B or any(
                len(g) != P["n"] for g in c["groups"]):
            raise AssertionError(f"sync_ppo: groups {len(c['groups'])}")
        for j, o in enumerate(outs):
            n = len(o.gen_logprobs)
            if not (1 <= n <= P["max_new"]
                    and len(o.tokens) == P["prompt_len"] + n
                    and o.tokens[:P["prompt_len"]].tolist()
                    == prompts[j // P["n"]]
                    and np.isfinite(o.gen_logprobs).all()
                    and (o.gen_logprobs <= 0).all()):
                raise AssertionError(f"sync_ppo: call {i} sequence {j}")
        st = c["stats"]
        want = dict(graph_captures=1, decode_steps=(i + 1) * steps,
                    graph_replays=(i + 1) * steps - 1)
        if any(st[k] != v for k, v in want.items()) or c["flash_fwd"] != L:
            raise AssertionError(f"sync_ppo: call {i} stats {st}, flash "
                                 f"forward launches {c['flash_fwd']} (want "
                                 f"{want} and {L})")
    if gen.n_compiles() != 1 or all(
            np.array_equal(a.tokens, b.tokens) for a, b in zip(
                calls[0]["groups"][0], calls[1]["groups"][0])):
        raise AssertionError("sync_ppo: one key, two seeds expected")
    errs = []
    for o in (o for g in calls[1]["groups"] for o in g):
        lp = score_tokens(torch, tfm, cfg, gen._params, o.tokens.tolist(),
                          P["prompt_len"])
        errs.append(np.abs(lp - o.gen_logprobs))
    # gen_logprobs (bf16 decode over the dense cache) against a packed
    # forward (flash, bf16) on the same cast weights: WEIGHT_SYNC_LP_TOL's
    # reasoning holds
    errs = np.concatenate(errs)
    if not errs.mean() <= WEIGHT_SYNC_LP_TOL:
        raise AssertionError(f"sync_ppo: gen vs scored logprobs "
                             f"{errs.mean()} > {WEIGHT_SYNC_LP_TOL}")
    # prefill's flash calls against the plain version: this layout, and
    # short prompts with a padding row (7 prompts over rows of 4)
    prefill_rows = [
        prefill_flash_check(torch, gen._params, cfg,
                            [p for p in prompts for _ in range(P["n"])],
                            eng.n_rows),
        prefill_flash_check(torch, gen._params, cfg,
                            [rng.integers(0, cfg.vocab_size, n).tolist()
                             for n in (1, 37, 130, 300, 511, 64, 200)], 4),
    ]
    if prefill_rows[1]["padding_rows"] != 1:
        raise AssertionError(f"sync_ppo: prefill layouts {prefill_rows}")
    c = calls[1]
    generated = sum(len(o.gen_logprobs) for g in c["groups"] for o in g)
    gen_row = dict(
        rows=B, prompt_len=P["prompt_len"], max_new=P["max_new"],
        generated_tokens=generated, prefill_s=c["prefill_s"],
        decode_s=c["decode_s"], event_s=c["prefill_s"] + c["decode_s"],
        gen_tok_per_s=generated / (c["prefill_s"] + c["decode_s"]),
        decode_ms_per_step=1e3 * c["decode_s"] / steps, wall_s=c["wall_s"],
        first_call_wall_s=calls[0]["wall_s"],
        capture_s=gen.stats["graph_capture_s"],
        graph_pool_gb=gen.stats["graph_pool_bytes"] / 1e9,
        decode_steps=gen.stats["decode_steps"],
        graph_replays=gen.stats["graph_replays"],
        graph_captures=gen.stats["graph_captures"],
        flash_fwd_per_call=[c["flash_fwd"] for c in calls],
        lp_mean_abs_err=float(errs.mean()), lp_max_abs_err=float(errs.max()),
        lp_tol=WEIGHT_SYNC_LP_TOL, prefill_flash=prefill_rows,
    )

    if profile:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with prof:
            gen.generate(prompts, ghp, seed=3)
            torch.cuda.synchronize()
        gen_row["profile"] = device_profile(
            prof, time.perf_counter() - t0, {"flash_fwd": "flash_fwd_v4"},
            top=20)

    # (b) two sync-PPO steps through the same generator (no new capture)
    replays0 = gen.stats["graph_replays"]
    ref = launcher._load_engine(spec, with_optimizer=False)
    root = tempfile.mkdtemp(prefix="areal_sync_ppo_")
    old_root = os.environ.get("AREAL_FILEROOT")
    constants.set_fileroot(root)
    constants.set_experiment_trial_names("chip-sync-ppo", "t0")
    worker = SyncPPOTrainerWorker(
        "chip-sync-ppo", "t0", actor_engine=eng, dataset=PromptSet(prompts),
        hp=PPOHyperparameters(use_decoupled_loss=False,
                              recompute_logprob=False),
        ghp=ghp, control=TrainerControl(total_train_steps=2, save_freq_steps=2),
        batch_size=P["n_prompts"],
        mb_spec=MicroBatchSpec(max_tokens_per_mb=P["mb_tokens"]),
        ref_engine=ref, seed=1,
    )
    worker.generator = gen
    tokens = []
    run = worker.executor.run

    def counted(batch):
        tokens.append(batch.total_len("packed_input_ids"))
        return run(batch)

    worker.executor.run = counted
    fwd0, bwd0 = cuda_flash.fwd_launches, cuda_flash.bwd_launches
    step_rows = []
    for _ in range(2):
        st = worker.run_step()
        torch.cuda.synchronize()
        bad = {k: v for k, v in st.items()
               if np.isscalar(v) and not np.isfinite(v)}
        if bad or not -1.0 <= st["reward_mean"] <= 1.0 or (
                st["n_seqs_consumed"] != B):
            raise AssertionError(f"sync_ppo: step stats {st}")
        step_rows.append({k: st[k] for k in (
            "actor_loss", "reward_mean", "grad_norm", "timeperf/gen",
            "timeperf/e2e", "n_seqs_consumed")})
        step_rows[-1]["trained_tok_per_s"] = tokens[-1] / (
            st["timeperf/e2e"] - st["timeperf/gen"])
    save = os.path.join(constants.get_save_root(), "step2")
    committed = all(os.path.exists(os.path.join(save, f))
                    for f in ("COMMIT.json", "model.safetensors",
                              "config.json"))
    if not committed or worker.step != 2:
        raise AssertionError(f"sync_ppo: step2 export at {save}: "
                             f"{os.listdir(save) if os.path.isdir(save) else None}")
    if gen.stats["graph_captures"] != 1 or gen.stats["graph_replays"] != (
            replays0 + 2 * steps):
        raise AssertionError(f"sync_ppo: the steps recaptured: {gen.stats}")
    train_fwd = cuda_flash.fwd_launches - fwd0
    train_bwd = cuda_flash.bwd_launches - bwd0
    # per step: one prefill, the ref engine's inference micro-batches, and
    # each train micro-batch's forward twice (full remat) and backward once
    ref_fwd = train_fwd - 2 * L - 2 * train_bwd
    if train_bwd <= 0 or train_bwd % L or ref_fwd < 2 * L or ref_fwd % L:
        raise AssertionError(f"sync_ppo: step flash launches fwd {train_fwd} "
                             f"bwd {train_bwd}")
    train_row = dict(steps=step_rows, tokens_per_step=tokens,
                     flash_fwd_launches=train_fwd,
                     flash_bwd_launches=train_bwd, init_s=init_s,
                     peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    shutil.rmtree(root, ignore_errors=True)
    del worker, eng, ref, gen, calls
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the in-process entry points, on the card at 2 layers
    arch = json.dumps(dict(QWEN_1P5B_ARCH, n_layers=P["entry_layers"]))
    over = json.dumps(overrides)
    root = tempfile.mkdtemp(prefix="areal_entry_")
    with open(os.path.join(root, "sft.jsonl"), "w") as f:
        for i in range(16):
            f.write(json.dumps({"qid": f"s{i}",
                                "prompt_ids": rng.integers(0, cfg.vocab_size, 256).tolist(),
                                "answer_ids": rng.integers(0, cfg.vocab_size, 256).tolist()}) + "\n")
    with open(os.path.join(root, "rw.jsonl"), "w") as f:
        for i in range(8):
            p = rng.integers(0, cfg.vocab_size, 128).tolist()
            ans = [[p + rng.integers(0, cfg.vocab_size, 128).tolist()
                    for _ in range(2)] for _ in range(2)]
            f.write(json.dumps({"qid": f"r{i}", "prompt_ids": p,
                                "pos_answer_ids": ans[0],
                                "neg_answer_ids": ans[1]}) + "\n")
    with open(os.path.join(root, "math.jsonl"), "w") as f:
        for i in range(8):
            f.write(json.dumps({"query_id": f"m{i}", "task": "math",
                                "prompt_ids": rng.integers(0, cfg.vocab_size, 256).tolist(),
                                "solutions": ["\\boxed{7}"]}) + "\n")
    common = [f"fileroot={root}", "trial_name=t0",
              f"max_tokens_per_mb={P['mb_tokens']}"]
    runs = {
        "sft": ["sft", "experiment_name=chip-sft", "dataset.name=prompt_answer",
                f"dataset.path={root}/sft.jsonl", "batch_size=8",
                "control.total_train_steps=3", "control.save_freq_steps=3",
                f"model.arch={arch}", f"model.overrides={over}", *common],
        "rw": ["rw", "experiment_name=chip-rw", "dataset.name=rw_paired",
               f"dataset.path={root}/rw.jsonl", "batch_size=4",
               "control.total_train_steps=2", f"model.arch={arch}",
               f"model.overrides={over}", *common],
        "sync-ppo": ["sync-ppo", "experiment_name=chip-sppo",
                     f"dataset.path={root}/math.jsonl", "batch_size=4",
                     "control.total_train_steps=2",
                     "control.save_freq_steps=2", "use_ref_model=true",
                     'gconfig={"n": 4, "max_new_tokens": 64}',
                     f"actor.arch={arch}", f"actor.overrides={over}", *common],
        "profile": ["profile", "--seqlens", "1024x8", "--n-steps", "3",
                    f"arch={arch}", f"overrides={over}"],
    }
    entry_rows = {}
    for name, argv in runs.items():
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = entry.main(argv)
        row = dict(rc=rc, wall_s=time.perf_counter() - t0)
        gc.collect()
        torch.cuda.empty_cache()
        if rc != 0:
            raise AssertionError(f"sync_ppo: {name} returned {rc}")
        if name == "profile":
            out = json.loads(buf.getvalue().strip().splitlines()[-1])
            if not (np.isfinite(out["mfu"]) and 0 < out["mfu"] <= 1):
                raise AssertionError(f"sync_ppo: profile {out}")
            row.update({k: out[k] for k in ("step_time_s", "tokens_per_s",
                                            "tflops_per_s", "mfu",
                                            "n_params")})
        else:
            exp = argv[1].partition("=")[2]
            key, n = {"sft": ("sft/loss", 3), "rw": ("reward/rw_loss", 2),
                      "sync-ppo": ("sync_ppo/actor_loss", 2)}[name]
            path = os.path.join(root, "logs", exp, "t0", "metrics.jsonl")
            vals = [json.loads(ln)[key] for ln in open(path)]
            if len(vals) != n or not np.isfinite(vals).all():
                raise AssertionError(f"sync_ppo: {name} metrics {vals}")
            row[key] = vals
        entry_rows[name] = row
    saves = {n: os.path.exists(os.path.join(root, "checkpoints", e, "t0", s,
                                            "COMMIT.json"))
             for n, e, s in (("sft", "chip-sft", "step3"),
                             ("sync-ppo", "chip-sppo", "step2"))}
    if not all(saves.values()):
        raise AssertionError(f"sync_ppo: entry-point saves {saves}")
    shutil.rmtree(root, ignore_errors=True)
    if old_root is None:
        os.environ.pop("AREAL_FILEROOT", None)
    else:
        os.environ["AREAL_FILEROOT"] = old_root
    row = dict(parity=parity, generation=gen_row, train=train_row,
               entry_points=entry_rows,
               flash_fwd_launches=gen_fwd + train_fwd,
               flash_bwd_launches=train_bwd)
    emit(phase="sync_ppo", **row)
    return row


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--sweep", action="store_true",
                    help="also time the paged-decode kernel against pages "
                         "per slot")
    ap.add_argument("--profile", action="store_true",
                    help="trace the serve, train and sync_ppo phases with "
                         "torch.profiler and report device time by kernel")
    ap.add_argument("--kernels", default=",".join(SOURCES),
                    help="the kernels the build and kernels phases cover "
                         "(a subset gives no result line)")
    ap.add_argument("--package", default=None,
                    help="import areal_tpu_torch from this directory (e.g. "
                         "an unpacked earlier commit) instead of the "
                         "script's; with the extra phases decode_time and "
                         "flash_time, two versions of the paged-decode or "
                         "flash kernels are timed alike")
    ap.add_argument("--keep-logs", default=None,
                    help="copy the async_ppo run's log (every process of "
                         "the entry point) into this directory")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    args.kernels = tuple(args.kernels.split(","))
    if args.package:
        sys.path.insert(0, args.package)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from areal_tpu_torch.ops.cuda import build
        from areal_tpu_torch.ops.cuda import flash_attention as cuda_flash
        from areal_tpu_torch.ops.cuda import fused_sample as cuda_fused
        from areal_tpu_torch.ops.cuda import paged_attention as cuda_paged
    except ImportError as e:
        print(f"chip_smoke: the areal_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit(phase="start", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), card=card)

    if "build" in phases:
        t0 = time.perf_counter()
        build.load_all(args.kernels)
        emit(phase="build", seconds=time.perf_counter() - t0, sources={
            n: dict(nvcc_seconds=build.build_log[n]["seconds"],
                    ptxas=[ln.strip() for ln in
                           build.build_log[n]["ptxas"].splitlines()
                           if "registers" in ln or "spill" in ln
                           or "Function properties" in ln])
            for n in args.kernels
        })
    kern, flash, fused = {}, {}, {}
    if "kernels" in phases:
        if "fused_sample" in args.kernels:
            fused = fused_kernels_phase(torch)
        if "paged_decode" in args.kernels:
            kern = kernels_phase(torch)
        if "flash_attention" in args.kernels:
            flash = flash_kernels_phase(torch)
    if "decode_time" in phases:
        decode_time_phase(torch)
    if "flash_time" in phases:
        flash_time_phase(torch)
    if args.sweep:
        sweep_phase(torch)
    if "parity" in phases:
        parity_phase(torch)
    served = {}
    if any(p in phases for p in ("serve", "serve_fused", "serve_int8",
                                 "serve_pipelined")):
        from areal_tpu_torch.models import transformer as tfm

        cfg = qwen_1p5b_cfg()
        params = tfm.init_params(cfg, seed=0, device="cuda",
                                 dtype=torch.bfloat16)
        if "serve" in phases:
            served["bfloat16"] = serve_phase(
                torch, "serve", params, cfg, kv_dtype=None, n_prompts=4,
                group=8, profile=args.profile, stream=True,
            )
        if "serve_fused" in phases:
            n_same = fused_determinism(torch, params, cfg)
            served["fused"] = serve_phase(
                torch, "serve_fused", params, cfg, kv_dtype=None, n_prompts=4,
                group=8, profile=args.profile, fused=True,
            )
            emit(phase="serve_fused_summary", deterministic_requests=n_same,
                 decode_tok_per_s=served["fused"]["decode_tok_per_s"],
                 unfused_decode_tok_per_s=served.get("bfloat16", {}).get(
                     "decode_tok_per_s"))
        if "serve_int8" in phases:
            served["int8"] = serve_phase(
                torch, "serve_int8", params, cfg, kv_dtype="int8",
                n_prompts=1, group=8, profile=args.profile,
            )
        if "serve_pipelined" in phases:
            if "bfloat16" not in served:
                raise AssertionError("serve_pipelined holds its greedy "
                                     "tokens to serve's: run both")
            row = serve_phase(
                torch, "serve_pipelined", params, cfg, kv_dtype=None,
                n_prompts=4, group=8, profile=args.profile, pipelined=True,
            )
            want = served["bfloat16"]["greedy_tokens"]
            diff = [r for r in want if row["greedy_tokens"].get(r) != want[r]]
            if diff or len(want) != len(row["greedy_tokens"]):
                raise AssertionError(f"serve_pipelined: greedy tokens differ "
                                     f"from serve's on {diff}")
            emit(phase="serve_pipelined_summary",
                 greedy_requests_equal=len(want),
                 decode_tok_per_s=row["decode_tok_per_s"],
                 unpipelined_decode_tok_per_s=served["bfloat16"][
                     "decode_tok_per_s"],
                 chunk_flag_blocked=row["chunk_flag_blocked"],
                 chunk_flag_fetches=row["chunk_flag_fetches"])
        del params
        torch.cuda.empty_cache()
    if "weight_sync" in phases:
        weight_sync_phase(torch)
    if "async_rollout" in phases:
        async_rollout_phase(torch)
    if "async_ppo" in phases:
        async_ppo_phase(torch, keep_logs=args.keep_logs)
    if "train_parity" in phases:
        train_parity_phase(torch)
    trained = train_phase(torch, args.profile) if "train" in phases else {}
    synced = (sync_ppo_phase(torch, args.profile) if "sync_ppo" in phases
              else {})
    kernels = []
    for variant, case in (("bfloat16", "slice_bf16"), ("int8", "slice_int8")):
        k = kern.get(case, {})
        kernels.append({
            "name": f"paged_decode[{variant}]",
            "route": "cuda",
            "source": cuda_paged.SOURCE,
            "replaces": cuda_paged.REPLACES,
            "launches": served.get(variant, {}).get("paged_decode_launches", 0),
            "max_abs_err": k.get("max_abs_err"),
            "ms": k.get("kernel_ms"),
            "plain_ms": k.get("plain_ms"),
            "bound_ms": k.get("bound_ms"),
            "bound_by": k.get("bound_by"),
            "library_ms": k.get("library_ms"),
        })
    fcase = flash.get("slice_bf16", {})
    for name, part, replaces in (("flash_fwd", "fwd", cuda_flash.REPLACES_FWD),
                                 ("flash_bwd", "bwd", cuda_flash.REPLACES_BWD)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": cuda_flash.SOURCE,
            "replaces": replaces,
            "launches": (trained.get(f"flash_{part}_launches", 0)
                         + synced.get(f"flash_{part}_launches", 0)),
            "max_abs_err": fcase.get(f"{part}_max_abs_err"),
            "ms": fcase.get(f"{part}_ms"),
            "plain_ms": fcase.get(f"plain_{part}_ms"),
            "bound_ms": fcase.get(f"{part}_bound_ms"),
            "bound_by": fcase.get(f"{part}_bound_by"),
            "library_ms": fcase.get(f"library_{part}_ms"),
        })
    fs = fused.get("slice_bf16", {})
    kernels.append({
        "name": "fused_sample",
        "route": "cuda",
        "source": cuda_fused.SOURCE,
        "replaces": cuda_fused.REPLACES,
        "launches": served.get("fused", {}).get("fused_sample_launches", 0),
        "max_abs_err": fs.get("max_abs_err"),
        "ms": fs.get("kernel_ms"),
        "plain_ms": fs.get("plain_ms"),
        "bound_ms": fs.get("bound_ms"),
        "bound_by": fs.get("bound_by"),
        "library_ms": fs.get("library_ms"),
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    if sorted(phases) != sorted(PHASES) or sorted(args.kernels) != sorted(SOURCES):
        print(f"chip_smoke: ran only {phases}; no result", file=sys.stderr)
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
