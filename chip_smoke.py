"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printed as one JSON line:

  device   the card (nvidia-smi name and power limit), torch and CUDA
  build    nvcc builds of both kernels from src/repro_torch/kernels/csrc
  kernels  each CUDA kernel against its plain PyTorch version on the card,
           at the main path's shapes, within a stated tolerance
  serve    llama3.2-1b at its published widths (random weights from a
           seed) through the port's Server: lq4w weights, 4-bit paged KV,
           fused attention, bf16; launch counts must match the path
  profile  torch.profiler over steady decode steps: device busy time per
           step against the host-clock step (the device's idle share)
  parity   the same requests through the port on the card (kernels) and on
           the CPU (plain versions), f32, 2 layers at full width: greedy
           tokens identical, logits within a stated tolerance
  timing   CUDA-event times of each kernel, its plain version and a library
           call computing the same function, beside the card's bound

then a ``{"kernels": [...]}`` summary line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failed check raises and the script
exits non-zero; without a CUDA card it exits non-zero before any result.
It imports nothing of the JAX package.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak, same source
SEED = 0

# the main path's geometry (README: serve --scheme lq4w --kv-bits 4
# --continuous N --fused-attention)
SLOTS, PAGE, KV_GROUP, KV_BITS, SCHEME = 4, 16, 16, 4, "lq4w"
PROMPT, NEW_TOKENS, N_REQUESTS = 128, 32, 8
MAX_CONTEXT = -(-(PROMPT + NEW_TOKENS + 8) // PAGE) * PAGE      # 176


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time in ms the card could take: bytes over its memory rate or
    operations over its bf16 peak, whichever is larger."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def cuda_time(fn, iters: int, warmup: int = 5) -> float:
    """Mean ms of ``fn()`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# ---------------------------------------------------------------------------
# phase: device, build
# ---------------------------------------------------------------------------

def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_device() -> str:
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "capability": list(torch.cuda.get_device_capability(0))})
    return smi


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build_all()
    dt = time.perf_counter() - t0
    spills = {n: len(re.findall(r"[1-9][0-9]* bytes spill stores",
                                p.with_suffix(".log").read_text()))
              if p.with_suffix(".log").exists() else None
              for n, p in paths.items()}
    emit({"phase": "build", "seconds": dt,
          "libraries": {n: p.name for n, p in paths.items()},
          "kernels_with_spills": spills})


# ---------------------------------------------------------------------------
# phase: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_quant_matmul(dev) -> dict:
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases, worst = 0, {"abs": 0.0, "rel": 0.0, "ratio": 0.0}
    shapes = [(2048, 2024, 128)]                 # ragged N (not a tile)
    main = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]
    for bits in (1, 2, 3, 4, 8):
        for dtype in (torch.float32, torch.bfloat16):
            for m in (1, 4, MAX_CONTEXT):
                todo = shapes + ([(k, n, 128) for k, n in main]
                                 if bits == 4 else [])
                for k, n, gs in todo:
                    w = torch.randn((k, n), generator=gen, device=dev) \
                        * k ** -0.5
                    x = torch.randn((m, k), generator=gen,
                                    device=dev).to(dtype)
                    packed, scale, zmin = ref.quantize_weight(w, bits, gs)
                    got = qm.quant_matmul(x, packed, scale, zmin, bits=bits,
                                          group_size=gs)
                    want = qm.plain(x, packed, scale, zmin, bits=bits,
                                    group_size=gs)
                    torch.cuda.synchronize()
                    wd = ref.dequantize_weight(packed, scale, zmin, bits, gs)
                    tol = qm.error_bound(x, wd, want)
                    err = (got.float() - want.float()).abs()
                    ratio = float((err / tol.clamp_min(1e-30)).max())
                    if not bool((err <= tol).all()):
                        raise AssertionError(
                            f"quant_matmul bits={bits} {dtype} M={m} K={k} "
                            f"N={n}: max err {float(err.max())}, "
                            f"{ratio:.2f}x the bound")
                    worst["abs"] = max(worst["abs"], float(err.max()))
                    worst["rel"] = max(worst["rel"], float(
                        (err / want.float().abs().clamp_min(1e-6)).max()))
                    worst["ratio"] = max(worst["ratio"], ratio)
                    cases += 1
    return {"cases": cases, "max_abs_err": worst["abs"],
            "max_rel_err": worst["rel"], "max_err_over_bound": worst["ratio"]}


def paged_case(dev, bits, dtype, lq, gen):
    """A decode step's paged-attention inputs at the main path's shapes:
    4 slots, 8 kv heads x 4 groups, head_dim 64, page 16, 11 table entries
    per slot, slots at ragged positions; scratch page 0 is filled with
    large garbage and table entries past each slot's live pages point at
    it, as the pool hands them over."""
    from repro_torch.core import kvwire
    b, kvh, g, d, pps = SLOTS, 8, 4, 64, MAX_CONTEXT // PAGE
    n_pages = b * pps + 1
    kf = torch.randn((n_pages, PAGE, kvh, d), generator=gen, device=dev)
    vf = torch.randn((n_pages, PAGE, kvh, d), generator=gen, device=dev)
    kf[0], vf[0] = 1e4, -1e4
    q = torch.randn((b, lq, kvh, g, d), generator=gen, device=dev).to(dtype)
    pos = torch.tensor([159, 160 - lq, 150, 37], dtype=torch.int32,
                       device=dev)
    table = torch.zeros((b, pps), dtype=torch.int32, device=dev)
    for i in range(b):
        live = (int(pos[i]) + lq - 1) // PAGE + 1
        table[i, :live] = 1 + i * pps + torch.arange(live, device=dev)
    if bits is None:
        return q, kf.to(dtype), vf.to(dtype), table, pos
    return (q, kvwire.quantize_kv(kf, bits, KV_GROUP),
            kvwire.quantize_kv(vf, bits, KV_GROUP), table, pos)


def check_paged_attention(dev) -> dict:
    from repro_torch.kernels import paged_attention as pa
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    cases, worst = 0, {"abs": 0.0, "rel": 0.0, "ratio": 0.0}
    for bits in (None, 8, 4, 2, 1):
        for dtype in (torch.float32, torch.bfloat16):
            for lq in (1, 3):
                q, kp, vp, table, pos = paged_case(dev, bits, dtype, lq, gen)
                got = pa.paged_attention(q, kp, vp, table, pos)
                want = pa.plain(q, kp, vp, table.long(), pos.long())
                torch.cuda.synchronize()
                tol = pa.error_bound(q, kp, vp, table, pos, want)
                err = (got.float() - want.float()).abs()
                ratio = float((err / tol).max())
                if not bool((err <= tol).all()):
                    raise AssertionError(
                        f"paged_attention bits={bits} {dtype} Lq={lq}: max "
                        f"err {float(err.max())}, {ratio:.2f}x the bound")
                worst["abs"] = max(worst["abs"], float(err.max()))
                worst["rel"] = max(worst["rel"], float(
                    (err / want.float().abs().clamp_min(1e-6)).max()))
                worst["ratio"] = max(worst["ratio"], ratio)
                cases += 1
    q, kp, vp, table, pos = paged_case(dev, 4, torch.bfloat16, 1, gen)
    auto = pa.paged_attention(q, kp, vp, table, pos)
    for dq in ("affine", "lut"):          # both selectors run the kernel
        if not torch.equal(auto, pa.paged_attention(q, kp, vp, table, pos,
                                                    dequant=dq)):
            raise AssertionError(f"dequant={dq} differs from auto")
    q, kp, vp, table, pos = paged_case(dev, 8, torch.bfloat16, 1, gen)
    try:
        pa.paged_attention(q, kp, vp, table, pos, dequant="lut")
    except ValueError:
        pass
    else:
        raise AssertionError("dequant='lut' at 8 bits did not raise")
    return {"cases": cases, "max_abs_err": worst["abs"],
            "max_rel_err": worst["rel"], "max_err_over_bound": worst["ratio"]}


def phase_kernels(dev) -> dict:
    checks = {"quant_matmul": check_quant_matmul(dev),
              "paged_attention": check_paged_attention(dev)}
    emit({"phase": "kernels", "checks": checks,
          "tolerance": "elementwise bounds from f32 summation order and "
                       "bf16 output rounding (error_bound in "
                       "kernels/quant_matmul.py and "
                       "kernels/paged_attention.py)", "tf32": False})
    return checks


# ---------------------------------------------------------------------------
# phase: serve at full width
# ---------------------------------------------------------------------------

def _engine_class():
    from repro_torch.serve.engine import PagedEngine

    class TimedEngine(PagedEngine):
        """PagedEngine that times each prefill and decode step on the host
        clock (the step ends in a copy of its tokens to the host) and
        checks that its logits are finite; ``record`` keeps the logits of
        the live slots for the parity phase."""

        def __init__(self, *a, record=False, **kw):
            super().__init__(*a, **kw)
            self.prefill_ms, self.decode_ms = [], []
            self.logits = [] if record else None

        def _check(self, logits, rows, kind):
            if not bool(torch.isfinite(logits[rows]).all()):
                raise AssertionError("non-finite logits")
            if self.logits is not None:
                self.logits.append((kind, logits[rows].float().cpu()))

        def prefill_logits(self, pool, tokens, page_ids):
            t0 = time.perf_counter()
            out = super().prefill_logits(pool, tokens, page_ids)
            self._check(out, slice(None), "prefill")
            self.prefill_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def decode_logits(self, pool, tokens, page_table, pos):
            t0 = time.perf_counter()
            out = super().decode_logits(pool, tokens, page_table, pos)
            live = torch.as_tensor(np.asarray(page_table)[:, 0] != 0)
            self._check(out, live.to(out.device), "decode")
            self.decode_ms.append((time.perf_counter() - t0) * 1e3)
            return out

    return TimedEngine


def _prompts(cfg, n, length, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, length).tolist()
            for _ in range(n)]


def serve(cfg, params, *, dev, prompts, new_tokens, record=False,
          arrival_every=2):
    """Serve ``prompts`` through the port's Server with staggered arrivals;
    returns (server, engine, outputs, wall seconds)."""
    from repro_torch.serve.engine import EngineConfig, PagedConfig
    from repro_torch.serve.server import RequestParams, Server
    ecfg = EngineConfig(max_len=MAX_CONTEXT, kv_bits=KV_BITS,
                        kv_group=KV_GROUP, weight_scheme=SCHEME,
                        fused_attention=True)
    pcfg = PagedConfig(max_slots=SLOTS, page_size=PAGE, n_pages=64,
                       max_context=MAX_CONTEXT)
    engine = _engine_class()(cfg, params, ecfg, pcfg, device=dev,
                             record=record)
    server = Server(cfg, None, ecfg, pcfg, engine=engine)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = []
    for p in prompts:
        rids.append(server.submit(p, RequestParams(
            max_new_tokens=new_tokens)))
        for _ in range(arrival_every):
            server.step()
    server.drain(max_steps=10_000)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return server, engine, [server.output(r) for r in rids], wall


def phase_serve(dev) -> dict:
    from repro_torch import configs
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.models import transformer
    cfg = configs.get("llama3.2-1b")
    params = transformer.init_params(cfg, SEED, dev)
    n_params = sum(a.numel() for a in transformer.leaves(params))
    # warm-up request: CUDA context, allocator, cuBLAS handles
    serve(cfg, params, dev=dev, prompts=_prompts(cfg, 1, 16, SEED + 7),
          new_tokens=2)
    torch.cuda.reset_peak_memory_stats()
    prompts = _prompts(cfg, N_REQUESTS, PROMPT, SEED)
    qm.quant_matmul.launches = 0
    pa.paged_attention.launches = 0
    server, engine, outs, wall = serve(cfg, params, dev=dev, prompts=prompts,
                                       new_tokens=NEW_TOKENS)
    launches = {"quant_matmul": qm.quant_matmul.launches,
                "paged_attention": pa.paged_attention.launches}
    del params
    st = server.stats()
    steps, prefills = st["steps"], st["prefills"]
    want_qm = 7 * cfg.n_layers * (prefills + steps)
    want_pa = cfg.n_layers * steps
    tokens = sum(len(o) for o in outs)
    if launches["quant_matmul"] != want_qm \
            or launches["paged_attention"] != want_pa:
        raise AssertionError(f"launches {launches}, want quant_matmul "
                             f"{want_qm} paged_attention {want_pa}")
    if tokens != N_REQUESTS * NEW_TOKENS or st["attention_mode"] != \
            "fused-cuda" or any(not 0 <= t < cfg.vocab_size
                                for o in outs for t in o):
        raise AssertionError(f"serve output wrong: {tokens} tokens, "
                             f"mode {st['attention_mode']}")
    row = {"phase": "serve", "model": cfg.name, "params": n_params,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "scheme": SCHEME, "kv_bits": KV_BITS, "kv_group": KV_GROUP,
           "dtype": cfg.dtype, "attention_mode": st["attention_mode"],
           "requests": N_REQUESTS, "prompt_len": PROMPT,
           "new_tokens": NEW_TOKENS, "max_slots": SLOTS,
           "tokens": tokens, "wall_s": wall, "tok_per_s": tokens / wall,
           "decode_steps": steps, "prefills": prefills,
           "decode_step_ms_p50": statistics.median(engine.decode_ms),
           "prefill_ms_p50": statistics.median(engine.prefill_ms),
           "pool_bytes": st["pool_bytes"], "preemptions": st["preemptions"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": launches, "sample": outs[0][:8]}
    emit(row)
    return {"row": row, "engine": engine, "cfg": cfg}


# ---------------------------------------------------------------------------
# phase: device busy share of steady decode
# ---------------------------------------------------------------------------

PROFILE_STEPS = 16


def _device_busy(prof, steps: int) -> dict:
    """Union of the device intervals (kernels, copies, sets) a profiler
    window recorded, with the kernels that took the most device time."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy_us, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy_us, lo = busy_us + hi - lo, a
        hi = max(hi, b)
    busy_us += hi - lo
    by_name = sorted(((e.key, e.self_device_time_total / 1e3 / steps,
                       e.count / steps) for e in prof.key_averages()
                      if e.self_device_time_total > 0),
                     key=lambda r: -r[1])
    return {"device_busy_ms_per_step": busy_us / 1e3 / steps,
            "device_ops_per_step": len(spans) / steps,
            "top_device_ms_per_step": [
                {"name": k[:60], "ms": ms, "per_step": c}
                for k, ms, c in by_name[:6]]}


def phase_profile(serve_out) -> dict:
    """``torch.profiler`` over PROFILE_STEPS decode steps of the serve
    phase's engine with every slot busy: the device's busy time per step
    against the host-clock step, so the device idle share is measured, not
    inferred.  The window traces CUDA activity only, to disturb the host
    little; the host step time inside it is printed beside the serve
    phase's to show what tracing costs."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.server import RequestParams, Server
    engine, cfg = serve_out["engine"], serve_out["cfg"]
    server = Server(cfg, None, engine.ecfg, engine.pcfg, engine=engine)
    for p in _prompts(cfg, SLOTS, PROMPT, SEED + 8):
        server.submit(p, RequestParams(max_new_tokens=PROFILE_STEPS + 8))
    for _ in range(3):                       # admit and prefill every slot
        server.step()
    if len(server.scheduler.active_requests()) != SLOTS:
        raise AssertionError("profile window needs every slot busy")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            server.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    busy = _device_busy(prof, PROFILE_STEPS)
    row = {"phase": "profile", "steps": PROFILE_STEPS, "slots": SLOTS,
           "host_step_ms": wall_ms, "serve_phase_step_ms_p50":
           serve_out["row"]["decode_step_ms_p50"], **busy,
           "device_idle_share":
           1.0 - busy["device_busy_ms_per_step"] / wall_ms}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# phase: card (kernels) against CPU (plain versions), f32
# ---------------------------------------------------------------------------

# Logit tolerance of the parity phase.  The two runs sum in other orders
# (f32, relative differences ~1e-6 in K/V before they are quantized).  A
# K/V element that lies that close to a 4-bit rounding boundary lands one
# code apart on the two sides; one code is 1/15 of a 16-wide region's
# range, which moves one score by ~0.03 and a logit by ~1e-3 at these
# widths.  A few such ties per run are expected, so the tolerance sits an
# order above one tie's effect; anything from a wrong kernel (a missed
# page, a wrong mask, a wrong code) moves logits by O(1).
PARITY_LOGIT_TOL = 1e-2


def phase_parity(dev) -> dict:
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer
    cfg = dataclasses.replace(configs.get("llama3.2-1b"), n_layers=2,
                              dtype="float32")
    params = transformer.init_params(cfg, SEED + 3, "cpu")
    prompts = _prompts(cfg, SLOTS, 64, SEED + 3)
    runs = {}
    for d in (dev, torch.device("cpu")):
        server, engine, outs, _ = serve(
            cfg, transformer.params_to(params, d), dev=d, prompts=prompts,
            new_tokens=8, record=True)
        runs[d.type] = (outs, engine.logits, server.stats())
    (g_out, g_log, _), (c_out, c_log, _) = runs["cuda"], runs["cpu"]
    diffs = [float((a - b).abs().max()) for (_, a), (_, b)
             in zip(g_log, c_log)]
    row = {"phase": "parity", "layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": "float32", "requests": len(prompts),
           "logit_calls": len(diffs), "max_abs_logit_diff": max(diffs),
           "median_abs_logit_diff": statistics.median(diffs),
           "per_call": [[k, d] for (k, _), d in zip(g_log, diffs)],
           "max_abs_logit": max(float(a.abs().max()) for _, a in c_log),
           "tolerance": PARITY_LOGIT_TOL,
           "tokens_identical": g_out == c_out}
    emit(row)
    if len(g_log) != len(c_log) or g_out != c_out:
        raise AssertionError("greedy tokens differ between card and CPU")
    if max(diffs) > PARITY_LOGIT_TOL:
        raise AssertionError(f"logits differ by {max(diffs)}")
    return row


# ---------------------------------------------------------------------------
# phase: timing
# ---------------------------------------------------------------------------

def time_quant_matmul(engine, cfg) -> dict:
    """One decode step's worth of projections (7 per layer, every layer's
    own weights, so the weights stream from memory as on the path) at M =
    max_slots, bf16 x; per-layer times are that over the layer count."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_matmul as qm
    dev = engine.device
    names = [("mixer", "wq"), ("mixer", "wk"), ("mixer", "wv"),
             ("mixer", "wo"), ("ffn", "wi_gate"), ("ffn", "wi_up"),
             ("ffn", "wo")]
    qws = [[lay[a][b]["w"] for a, b in names]
           for lay in engine.params["layers"]]
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    xs = {qw.k: torch.randn((SLOTS, qw.k), generator=gen,
                            device=dev).to(torch.bfloat16)
          for qw in qws[0]}
    wd = [[ops.dequantize_weight(qw, torch.bfloat16) for qw in row]
          for row in qws]

    def kernel():
        for row in qws:
            for qw in row:
                qm.quant_matmul(xs[qw.k], qw.packed, qw.scale, qw.zmin,
                                bits=qw.bits, group_size=qw.group_size)

    def plain():
        for row in qws:
            for qw in row:
                qm.plain(xs[qw.k], qw.packed, qw.scale, qw.zmin,
                         bits=qw.bits, group_size=qw.group_size)

    def library():
        for row in wd:
            for w in row:
                torch.matmul(xs[w.shape[0]], w)

    labels = ("q", "k", "v", "o", "gate", "up", "down")
    per_proj = {lab: {"K": qw.k, "N": qw.n, "ms": cuda_time(
        lambda qw=qw: qm.quant_matmul(
            xs[qw.k], qw.packed, qw.scale, qw.zmin, bits=qw.bits,
            group_size=qw.group_size), 200)}
        for lab, qw in zip(labels, qws[0])}
    n_layers = len(qws)
    nbytes = flops = 0
    for qw in qws[0]:
        nbytes += (qw.nbytes() + SLOTS * qw.k * 2 + SLOTS * qw.n * 2)
        flops += 2 * SLOTS * qw.k * qw.n
    b_ms, b_by = bound(nbytes, flops)
    return {"ms": cuda_time(kernel, 20) / n_layers,
            "plain_ms": cuda_time(plain, 3, warmup=1) / n_layers,
            "library_ms": cuda_time(library, 20) / n_layers,
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"one layer's 7 projections at M={SLOTS}, bf16 x, "
                     f"{SCHEME} (K,N) as in per_projection; timed over all "
                     f"{n_layers} layers' own weights",
            "per_projection_hot_l2": per_proj}


def time_paged_attention(dev) -> dict:
    """One layer's paged attention at decode: 4 slots near 160 tokens,
    bf16 q, 4-bit pages, distinct pages per slot."""
    from repro_torch.core import kvwire
    from repro_torch.kernels import paged_attention as pa
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    q, kp, vp, table, pos = paged_case(dev, KV_BITS, torch.bfloat16, 1, gen)
    pos = torch.tensor([159, 158, 152, 160], dtype=torch.int32, device=dev)
    b, lq, kvh, g, d = q.shape
    for i in range(b):
        live = (int(pos[i]) + lq - 1) // PAGE + 1
        table[i] = 0
        table[i, :live] = 1 + i * (MAX_CONTEXT // PAGE) \
            + torch.arange(live, device=dev)
    tbl = table.long()
    kk = kvwire.dequantize_kv(kvwire.gather_pages(kp, tbl), d,
                              torch.bfloat16)
    vv = kvwire.dequantize_kv(kvwire.gather_pages(vp, tbl), d,
                              torch.bfloat16)
    s = kk.shape[1]
    qs = q.reshape(b, lq, kvh * g, d).transpose(1, 2)            # (B,H,1,D)
    ks, vs = kk.transpose(1, 2), vv.transpose(1, 2)              # (B,KV,S,D)
    mask = (torch.arange(s, device=dev)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ntok = [int(p) + lq for p in pos]
    per_tok = kvh * 2 * (d * KV_BITS // 8 + 8 * (d // KV_GROUP))
    nbytes = sum(ntok) * per_tok + 2 * q.numel() * q.element_size() \
        + table.numel() * 4 + pos.numel() * 4
    flops = sum(4 * n * kvh * g * d for n in ntok)
    b_ms, b_by = bound(nbytes, flops)
    return {"ms": cuda_time(lambda: pa.paged_attention(q, kp, vp, table,
                                                       pos), 500),
            "plain_ms": cuda_time(lambda: pa.plain(q, kp, vp, tbl,
                                                   pos.long()), 50),
            "library_ms": cuda_time(lambda: sdpa(qs, ks, vs, attn_mask=mask,
                                                 enable_gqa=True), 500),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"q {tuple(q.shape)} bf16, {KV_BITS}-bit pages, page "
                     f"{PAGE}, tokens per slot {ntok}",
            "library": "scaled_dot_product_attention on the gathered, "
                       "dequantized bf16 cache"}


def phase_timing(serve_out, dev) -> dict:
    t = {"quant_matmul": time_quant_matmul(serve_out["engine"],
                                           serve_out["cfg"]),
         "paged_attention": time_paged_attention(dev)}
    emit({"phase": "timing", **t})
    return t


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a "
              "card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False    # f32 checks in f32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    checks = phase_kernels(dev)
    serve_out = phase_serve(dev)
    phase_profile(serve_out)
    phase_parity(dev)
    timing = phase_timing(serve_out, dev)
    launches = serve_out["row"]["launches"]
    csrc = "src/repro_torch/kernels/csrc"
    replaces = {"quant_matmul": "src/repro/kernels/quant_matmul.py:121",
                "paged_attention": "src/repro/kernels/paged_attention.py:341"}
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": f"{csrc}/{name}.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": checks[name]["max_abs_err"],
         "max_rel_err": checks[name]["max_rel_err"],
         "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound_ms"],
         "bound_by": timing[name]["bound_by"],
         "library_ms": timing[name]["library_ms"],
         "shape": timing[name]["shape"]}
        for name in ("quant_matmul", "paged_attention")]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
