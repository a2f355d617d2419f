"""Standalone local serving stack: engine + gen server + gateway (the
counterpart of ``areal_tpu/gateway/__main__.py``).

``python -m areal_tpu_torch.gateway`` brings up ONE generation engine (an
HF checkpoint when ``--model-path`` is given, a tiny random-weight model
otherwise), the gen HTTP server around it, and the OpenAI-compatible
gateway in a single process. For local development and smoke tests;
production runs through the launcher (``apps/launcher.py`` gateway
worker), which fronts the whole fleet. The engine runs on the card unless
``--device cpu`` asks for the CPU.

    python -m areal_tpu_torch.gateway [--port 8000] [--model-path /ckpt]
        [--tokenizer-path /tok] [--slots 8] [--rate-tps 0] [--device cpu]
"""

import argparse
import asyncio
import sys

from areal_tpu_torch.base import constants, logging, network
from areal_tpu_torch.gateway.api import (
    ByteFallbackCodec,
    GatewayConfig,
    GatewayServer,
    HFTokenizerCodec,
    serve_gateway,
)
from areal_tpu_torch.gateway.qos import TenantSpec
from areal_tpu_torch.gateway.scheduler import ContinuousBatchScheduler

logger = logging.getLogger("areal_tpu_torch.gateway.main")


def _build_engine(args):
    from areal_tpu_torch.base.device import resolve_device
    from areal_tpu_torch.gen.engine import GenerationEngine
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.models.config import ModelConfig

    device = resolve_device(args.device or None)
    if args.model_path:
        from areal_tpu_torch.models import hf as hf_conv

        cfg, host_params = hf_conv.load_hf_checkpoint(args.model_path)
        params = tfm.params_from_numpy(host_params, device=device,
                                       dtype=cfg.dtype)
    else:
        logger.warning(
            "no --model-path: serving a tiny RANDOM-weight model "
            "(smoke-test mode; output tokens are meaningless)"
        )
        cfg = ModelConfig(
            n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=8,
            hidden_dim=32, intermediate_dim=64, vocab_size=128,
            dtype="float32",
        )
        params = tfm.init_params(cfg, seed=0, device=device)
    return GenerationEngine(
        cfg, params, max_slots=args.slots, max_seqlen=args.max_seqlen,
        device=device,
    )


async def _amain(args) -> int:
    from areal_tpu_torch.gen.server import serve as serve_gen

    engine = _build_engine(args)
    gen_srv = serve_gen(engine, "127.0.0.1", 0)
    gen_url = f"http://127.0.0.1:{gen_srv.port}"

    scheduler = ContinuousBatchScheduler(
        [gen_url],
        default_tenant=TenantSpec(
            name="anonymous",
            rate_tokens_per_s=args.rate_tps,
            default_deadline_s=args.deadline_s,
        ),
    )
    await scheduler.start()
    codec = (
        HFTokenizerCodec(args.tokenizer_path or args.model_path)
        if (args.tokenizer_path or args.model_path)
        else ByteFallbackCodec(engine.cfg.vocab_size)
    )
    gw = GatewayServer(
        scheduler, codec,
        GatewayConfig(max_tokens_cap=engine.G),
    )
    port = args.port or constants.gateway_port() or network.find_free_port()
    gw_runner = await serve_gateway(gw, "0.0.0.0", port)
    brownout_task = None
    if args.brownout:
        from areal_tpu_torch.gateway.brownout import (
            BrownoutConfig,
            wire_brownout,
        )

        controller = wire_brownout(
            BrownoutConfig(), scheduler, gw.config, scheduler._client
        )
        brownout_task = asyncio.get_running_loop().create_task(
            controller.run()
        )
    print(f"gateway listening on http://127.0.0.1:{port}/v1 "
          f"(backend {gen_url})", flush=True)
    try:
        while True:
            await asyncio.sleep(3600)
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    finally:
        if brownout_task is not None:
            brownout_task.cancel()
        await scheduler.stop()
        await gw_runner.cleanup()
        gen_srv.stop()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="areal_tpu_torch.gateway", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--port", type=int, default=0,
                   help="gateway port (default AREAL_GATEWAY_PORT or free)")
    p.add_argument("--model-path", default="", help="HF checkpoint dir")
    p.add_argument("--tokenizer-path", default="",
                   help="tokenizer dir (default: model path)")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--max-seqlen", type=int, default=2048)
    p.add_argument("--rate-tps", type=float, default=0.0,
                   help="per-tenant token-bucket rate (0 = unlimited)")
    p.add_argument("--deadline-s", type=float, default=0.0,
                   help="default per-request deadline in seconds (0 = none)")
    p.add_argument("--brownout", action="store_true",
                   help="enable the brownout degradation ladder")
    p.add_argument("--device", default="",
                   help="the engine's device: empty = the card (raises "
                        "where there is none), 'cpu' = the CPU")
    args = p.parse_args(argv)
    try:
        return asyncio.run(_amain(args))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
