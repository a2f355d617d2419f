#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``areal_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one JSON line:

1. ``build``: builds every CUDA kernel of the serving path from
   ``areal_tpu_torch/csrc`` with nvcc (one process per source).
2. ``kernels``: calls each kernel's wrapper on the card and holds it
   against its plain PyTorch version on the same inputs, at the serving
   path's shape (B 64, Hq 12, Hkv 2, D 128, page 128, table width 16,
   L 28, lens over [0, 2047]) in bf16 and int8, and at small shapes in
   f32 and bf16 with soft cap, sliding window, GQA groups of 1 and 8, a
   narrowed table and D 48. Times the kernel, the plain version and one
   PyTorch library call (SDPA over K/V already gathered dense) with CUDA
   events, beside the least time the card could take.
3. ``parity``: a tiny float32 model served by the engine on the card and
   on the CPU must give the same greedy tokens.
4. ``serve``: the engine at the full width of the R1-Distill-Qwen-1.5B
   profile (28 layers, random weights from a seed, bf16) behind the
   port's HTTP server answers 32 concurrent /generate requests (4 prompts
   of 1024 tokens, 8 requests each, greedy / temperature 1 / top-p 0.9);
   every answer is checked, the prefix cache must have been hit, and the
   paged-decode launch count must equal layers x decode steps.
5. ``serve_int8``: the same with an int8 KV pool and 8 requests.

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

PHASES = ("build", "kernels", "parity", "serve", "serve_int8")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, per type
# Tolerances, elementwise: |kernel - plain| <= atol + rtol * |plain|, as
# (atol, rtol) by the queries' dtype. f32: both sides are f32 end to end
# and differ only in summation order. bf16 queries (bf16 or int8 pool):
# both sides round the output to bf16, so they may differ by one bf16 ulp
# of the larger of the two (rtol 2^-7; atol covers the step where the two
# straddle a power of two); the plain version also rounds P to bf16
# before PV, as the reference does, where the kernel keeps P in f32 (atol
# 2e-3 for outputs near zero). Output scale at the slice shape: q and K ~
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


# --------------------------------------------------------------------------- #
# kernels
# --------------------------------------------------------------------------- #


def make_decode_inputs(torch, *, B, Hq, Hkv, D, page, W, L, dtype, quant,
                       lens, seed, table_pad=0, soft_cap=None, window=None):
    """Random decode operands on the card: pages in permuted order, each
    slot owning W pages; ``table_pad`` extra columns make the table a
    narrowed view with a wider row stride, as the engine passes it."""
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


def kernels_phase(torch):
    from areal_tpu_torch.ops.cuda import paged_attention as cuda_paged
    from areal_tpu_torch.ops.paged_attention import decode_plain

    def kw(x):
        return dict(softmax_scale=None, soft_cap=x["soft_cap"],
                    sliding_window=x["sliding_window"], scales=x["scales"])

    def args(x):
        return (x["q"], x["k_self"], x["v_self"], x["pages"], x["layer"],
                x["table"], x["lens"])

    B = 64
    slice_lens = np.linspace(0, 2047, B).astype(np.int64)  # lens[0] == 0
    slice_shape = dict(B=B, Hq=12, Hkv=2, D=128, page=128, W=16, L=28,
                       lens=slice_lens)
    small = dict(B=8, Hq=4, Hkv=2, D=64, page=16, W=8, L=2,
                 lens=[0, 1, 15, 16, 17, 64, 100, 127])
    cases = [
        ("slice_bf16", dict(slice_shape, dtype="bfloat16", quant=False), True),
        ("slice_int8", dict(slice_shape, dtype="bfloat16", quant=True), True),
        ("f32", dict(small, dtype="float32", quant=False), False),
        ("f32_soft_cap", dict(small, dtype="float32", quant=False,
                              soft_cap=5.0), False),
        ("f32_window", dict(small, dtype="float32", quant=False,
                            window=20), False),
        ("f32_rep1", dict(small, Hq=2, dtype="float32", quant=False), False),
        ("f32_rep8", dict(small, Hq=16, dtype="float32", quant=False), False),
        ("f32_narrow_table", dict(small, dtype="float32", quant=False,
                                  table_pad=5), False),
        ("f32_int8_d48", dict(small, D=48, dtype="float32", quant=True),
         False),
        ("bf16_cap_window", dict(small, dtype="bfloat16", quant=False,
                                 soft_cap=30.0, window=40), False),
        ("bf16_int8_window", dict(small, dtype="bfloat16", quant=True,
                                  window=33), False),
    ]
    results = {}
    for i, (name, spec, timed) in enumerate(cases):
        x = make_decode_inputs(torch, seed=100 + i, **spec)
        got = cuda_paged.decode(*args(x), **kw(x))
        want = decode_plain(*args(x), **kw(x))
        torch.cuda.synchronize()
        atol, rtol = TOL[spec["dtype"]]
        diff = (got.float() - want.float()).abs()
        over = (diff / (atol + rtol * want.float().abs())).max().item()
        err = diff.max().item()
        if not (np.isfinite(over) and over <= 1.0):
            raise AssertionError(
                f"paged_decode {name}: |kernel - plain| reaches {over} x "
                f"(atol {atol} + rtol {rtol} |plain|); max abs err {err}"
            )
        row = {"max_abs_err": err, "atol": atol, "rtol": rtol,
               "err_over_tol": over,
               "plain_rms": want.float().pow(2).mean().sqrt().item()}
        if timed:
            row["kernel_ms"] = cuda_ms(lambda: cuda_paged.decode(*args(x), **kw(x)), 50)
            row["plain_ms"] = cuda_ms(
                lambda: decode_plain(*args(x), **kw(x)), 10
            )
            row["library_ms"] = cuda_ms(sdpa_call(torch, x), 20)
            row["bound_ms"], row["bound_by"] = decode_bound(torch, x)
            pages = x["pages"]
            row["kv_bytes"] = int(x["lens"].long().sum()) * pages.shape[3] \
                * pages.shape[5] * 2 * pages.element_size()
        results[name] = row
        del x
    torch.cuda.empty_cache()
    emit(phase="kernels", kernel="paged_decode", cases=results)
    return results


def sweep_phase(torch):
    """Paged-decode time against pages per slot at the serving widths:
    one slot alone (the kernel's critical path) and all 64 slots equal."""
    from areal_tpu_torch.ops.cuda import paged_attention as cuda_paged

    rows = []
    for pages in (1, 2, 4, 8, 16):
        for label, lens in (("one_slot", [128 * pages - 1] + [0] * 63),
                            ("all_slots", [128 * pages - 1] * 64)):
            x = make_decode_inputs(torch, B=64, Hq=12, Hkv=2, D=128,
                                   page=128, W=16, L=28, dtype="bfloat16",
                                   quant=False, lens=lens, seed=7)
            args = (x["q"], x["k_self"], x["v_self"], x["pages"], x["layer"],
                    x["table"], x["lens"])
            rows.append({"pages_per_slot": pages, "slots": label,
                         "kernel_ms": cuda_ms(lambda: cuda_paged.decode(*args),
                                              30)})
            del x
    torch.cuda.empty_cache()
    emit(phase="sweep", kernel="paged_decode", rows=rows)


# --------------------------------------------------------------------------- #
# parity: the engine on the card vs on the CPU (tiny float32 model)
# --------------------------------------------------------------------------- #


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
    outs = {}
    for dev in ("cuda", "cpu"):
        eng = GenerationEngine(cfg, params, max_slots=4, max_seqlen=128,
                               page_size=16, device=dev)
        for i, p in enumerate(prompts):
            eng.submit(GenRequest(rid=str(i), input_ids=p, max_new_tokens=24,
                                  greedy=True))
        outs[dev] = {o.rid: o.output_ids for o in eng.run_until_done(8)}
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError(f"greedy cuda != cpu: {outs}")
    emit(phase="parity", requests=len(prompts), tokens_each=24,
         token_exact=True)


# --------------------------------------------------------------------------- #
# serving at the 1.5B profile's width, over HTTP
# --------------------------------------------------------------------------- #


def qwen_1p5b_cfg():
    """R1-Distill-Qwen-1.5B widths (the repo's generation bench profile)."""
    from areal_tpu_torch.models.config import ModelConfig

    return ModelConfig(
        n_layers=28, n_q_heads=12, n_kv_heads=2, head_dim=128,
        hidden_dim=1536, intermediate_dim=8960, vocab_size=151936,
        use_attention_bias=True, dtype="bfloat16",
    )


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


def device_profile(prof, wall_s):
    """Device time by kernel from a ``torch.profiler`` window: total, the
    paged-decode kernel's share, the busy share of the wall time, and the
    top kernels."""
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0)
        if t > 0:
            rows.append((ev.key, t / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    decode = sum(r[1] for r in rows if "paged_decode_kernel" in r[0])
    return dict(
        device_ms=total, busy_share=total / 1e3 / wall_s,
        paged_decode_ms=decode, paged_decode_share=decode / max(total, 1e-9),
        top=[[k[:80], ms, n] for k, ms, n in rows[:10]],
    )


def serve_phase(torch, name, params, cfg, *, kv_dtype, n_prompts,
                group, plen=1024, max_new=128, profile=False):
    from areal_tpu_torch.gen.engine import GenerationEngine
    from areal_tpu_torch.gen.server import serve
    from areal_tpu_torch.ops.cuda import paged_attention as cuda_paged

    eng = GenerationEngine(cfg, params, max_slots=32, max_seqlen=2048,
                           page_size=128, seed=0, kv_dtype=kv_dtype,
                           device="cuda")
    srv = serve(eng, "127.0.0.1", 0, decode_steps=16)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=plen).tolist()
               for _ in range(n_prompts)]
    modes = ["greedy"] * (group // 2) + ["temp"] * (group // 4) + (
        ["top_p"] * (group - group // 2 - group // 4))
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
            bodies.append({"rid": f"g{g}m{m}", "input_ids": p,
                           "sampling_params": sp})
    try:
        # the main path's run: every launch counted from here on
        cuda_paged.reset_launches()
        steps0 = eng.stats["decode_steps"]
        prof = None
        if profile:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]
            )
            prof.__enter__()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(bodies)) as ex:
            answers = list(ex.map(lambda b: post(srv.port, "/generate", b),
                                  bodies))
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
        launches = cuda_paged.launches
        steps = eng.stats["decode_steps"] - steps0
        metrics = get(srv.port, "/metrics_json")
    finally:
        srv.stop()
    by_rid = {}
    for body, (status, ans) in zip(bodies, answers):
        ids, lps = ans.get("output_ids"), ans.get("output_logprobs")
        ok = (
            status == 200 and ans.get("rid") == body["rid"]
            and isinstance(ids, list) and isinstance(lps, list)
            and len(ids) == len(lps)
            and (len(ids) == max_new or ans.get("finish_reason") == "stop")
            and all(0 <= t < cfg.vocab_size for t in ids)
            and bool(np.all(np.isfinite(lps)))
        )
        if not ok:
            raise AssertionError(f"{name}: bad answer to {body['rid']}: "
                                 f"{status} {str(ans)[:300]}")
        by_rid[body["rid"]] = ids
    if metrics["engine_prefix_hits"] <= 0:
        raise AssertionError(f"{name}: no prefix hits: {metrics}")
    if steps <= 0 or launches != cfg.n_layers * steps:
        raise AssertionError(
            f"{name}: paged_decode launched {launches} times over {steps} "
            f"decode steps of {cfg.n_layers} layers"
        )
    # informational: borrowers prefill their tail in another batch shape
    # than the group's first member, so bf16 may differ slightly
    agree = []
    for g in range(n_prompts):
        first = by_rid[f"g{g}m0"]
        for m in range(1, group // 2):
            other = by_rid[f"g{g}m{m}"]
            agree.append(float(np.mean(np.asarray(first) == np.asarray(other))))
    gen_tokens = sum(len(v) for v in by_rid.values())
    stats = eng.stats
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
        greedy_group_agreement=agree,
        kv_pool_bytes=metrics["kv_pool_bytes"],
    )
    if prof is not None:
        row["profile"] = device_profile(prof, wall)
    emit(phase=name, **row)
    del eng
    torch.cuda.empty_cache()
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
                    help="trace the serve phases with torch.profiler and "
                         "report device time by kernel")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from areal_tpu_torch.ops.cuda import build
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
        build.load_all(["paged_decode"])
        log = build.build_log["paged_decode"]
        emit(phase="build", seconds=time.perf_counter() - t0,
             nvcc_seconds=log["seconds"],
             ptxas=[ln for ln in log["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln])
    kern = kernels_phase(torch) if "kernels" in phases else {}
    if args.sweep:
        sweep_phase(torch)
    if "parity" in phases:
        parity_phase(torch)
    served = {}
    if "serve" in phases or "serve_int8" in phases:
        from areal_tpu_torch.models import transformer as tfm

        cfg = qwen_1p5b_cfg()
        params = tfm.init_params(cfg, seed=0, device="cuda",
                                 dtype=torch.bfloat16)
        if "serve" in phases:
            served["bfloat16"] = serve_phase(
                torch, "serve", params, cfg, kv_dtype=None, n_prompts=4,
                group=8, profile=args.profile,
            )
        if "serve_int8" in phases:
            served["int8"] = serve_phase(
                torch, "serve_int8", params, cfg, kv_dtype="int8",
                n_prompts=1, group=8, profile=args.profile,
            )
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    if sorted(phases) != sorted(PHASES):
        print(f"chip_smoke: ran only {phases}; no result", file=sys.stderr)
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
