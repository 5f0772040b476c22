"""Serving launcher of the port: ``python -m repro_torch.launch.serve``.

Only the continuous-batching mode of ``repro.launch.serve`` is ported:

    python -m repro_torch.launch.serve --arch llama3.2-1b --scheme lq4w \\
        --kv-bits 4 --continuous 8 --fused-attention

serves N requests with staggered arrivals (one every two decode steps)
over the paged pool at the architecture's published widths, with random
weights from ``--seed``, on the card.  ``--device cpu`` runs the same path
on the CPU through the kernels' plain versions; ``--smoke`` swaps in the
reduced same-family configuration (the one the JAX launcher serves), which
keeps a CPU run short.  ``--scheme lq8`` (or any ``lq{b}``) and
``lq2_lut``/``lq4_lut`` quantize activations at run time, the paper's
forward; ``--a-bits N`` sets their bits on any scheme.  Flags of the JAX
launcher that are not ported fail with the ROADMAP.md item that covers
them.  The last lines give each kernel's launch count and, as the JAX
launcher does, the decode step's compilations: on the card its captured
CUDA graphs (1 == no per-step recapture), on the CPU 0.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import configs
from .. import device as _device
from .. import kernels as _kernels
from ..models import transformer
from ..serve.engine import EngineConfig, PagedConfig
from ..serve.server import RequestParams, Server

ARRIVAL_EVERY = 2        # decode steps between request arrivals

# flags of repro.launch.serve the port does not take yet -> ROADMAP item
NOT_PORTED = {
    "--plan": "Queue 1 item 3 (PlanPolicy / super_segments)",
    "--spec-plan": "Queue 1 item 5 (speculative decoding)",
    "--spec-k": "Queue 1 item 5 (speculative decoding)",
    "--fleet": "Queue 1 item 7 (fleet)",
    "--budget-mb": "Queue 1 item 7 (fleet)",
    "--fleet-requests": "Queue 1 item 7 (fleet)",
    "--stats-out": "Queue 1 item 7 (fleet)",
    "--batch": "Queue 1 item 4 (Engine.generate, the contiguous path)",
    "--temperature": "Queue 1 item 4 (temperature sampling)",
    "--arrival-every": "Queue 1 item 4 (the launcher's arrival knob)",
}
OBS = "Queue 1 item 8 (observability)"


def _not_ported(unknown: list[str]) -> str:
    lines = []
    for arg in unknown:
        if not arg.startswith("--"):
            continue
        flag = arg.split("=", 1)[0]
        lines.append(f"  {flag}: not ported yet, ROADMAP.md "
                     f"{NOT_PORTED.get(flag, OBS)}")
    return "\n".join(lines) or f"  unexpected arguments {unknown}"


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True, choices=list(configs.names()))
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced same-family configuration")
    ap.add_argument("--scheme", default=None,
                    help="quant scheme, e.g. lq4w, lq8, lq2_lut")
    ap.add_argument("--a-bits", type=int, default=None,
                    help="runtime activation bits; overrides the scheme's")
    ap.add_argument("--kv-bits", type=int, default=None)
    ap.add_argument("--kv-group", type=int, default=16)
    ap.add_argument("--continuous", type=int, required=True, metavar="N",
                    help="serve N staggered requests via the paged "
                         "continuous-batching layer")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--n-pages", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=64,
                    help="tokens generated per request after the first")
    ap.add_argument("--fused-attention", action="store_true",
                    help="paged decode attention through the CUDA kernel "
                         "(its plain version on the CPU)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args, unknown = ap.parse_known_args(argv)
    if unknown:
        ap.error("\n" + _not_ported(unknown))
    return args


def main(argv=None) -> dict:
    args = parse(argv)
    dev = _device.resolve(args.device)
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    want = args.prompt_len + args.steps + 8
    mc = -(-want // args.page_size) * args.page_size
    ecfg = EngineConfig(max_len=mc, kv_bits=args.kv_bits,
                        kv_group=args.kv_group, weight_scheme=args.scheme,
                        a_bits=args.a_bits,
                        fused_attention=args.fused_attention)
    pcfg = PagedConfig(max_slots=args.max_slots, page_size=args.page_size,
                       n_pages=args.n_pages, max_context=mc)
    params = transformer.init_params(cfg, args.seed, dev)
    server = Server(cfg, params, ecfg, pcfg, device=dev)
    del params
    rng = np.random.default_rng(args.seed)
    server.submit(rng.integers(0, cfg.vocab_size, args.prompt_len).tolist(),
                  RequestParams(max_new_tokens=2))
    server.drain()                  # builds the kernels, off the clock
    kernels = _kernels.wrappers()
    for fn in kernels.values():
        fn.launches = 0
    _sync(dev)
    t0 = time.perf_counter()
    rids = []
    occ = []
    for _ in range(args.continuous):
        prompt = rng.integers(0, cfg.vocab_size, args.prompt_len).tolist()
        rids.append(server.submit(prompt, RequestParams(
            max_new_tokens=args.steps + 1)))
        for _ in range(ARRIVAL_EVERY):
            server.step()
            occ.append(server.pool.occupancy())
    while server.has_work:
        server.step()
        occ.append(server.pool.occupancy())
    _sync(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(server.output(r)) for r in rids)
    s = server.stats()
    print(f"arch={cfg.name} scheme={args.scheme} a_bits={args.a_bits} "
          f"kv_bits={args.kv_bits} "
          f"device={dev} attention={s['attention_mode']}")
    print(f"continuous: {len(rids)} requests, {toks} tokens in {dt:.2f}s "
          f"-> {toks / dt:.1f} tok/s")
    print(f"pool: {server.pool.n_pages} pages x "
          f"{server.pool.page_nbytes():,} B, peak occupancy {max(occ):.2f}, "
          f"mean {sum(occ) / len(occ):.2f}")
    launches = {name: fn.launches for name, fn in kernels.items()}
    print("kernel launches: " + ", ".join(f"{n} {c}"
                                          for n, c in launches.items()))
    note = ("1 == no per-step recapture" if dev.type == "cuda"
            else "on the CPU the step runs eagerly: nothing is captured")
    print(f"decode compilations: {s['decode_compilations']} ({note})")
    print("sample:", server.output(rids[0])[:16])
    return {"tokens": toks, "seconds": dt, "stats": s, "launches": launches,
            "outputs": [server.output(r) for r in rids]}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


if __name__ == "__main__":
    main(sys.argv[1:])
