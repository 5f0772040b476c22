"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printed as one JSON line:

  device   the card (nvidia-smi name and power limit), torch and CUDA
  build    nvcc builds of the four kernels from src/repro_torch/kernels/csrc,
           with each kernel instantiation's registers, spills and stack
  kernels  each CUDA kernel against its plain PyTorch version on the card,
           at the main paths' shapes: quant_matmul, paged_attention and
           lut_matmul within computed error bounds, act_quant byte for byte;
           quant_matmul, paged_attention (also at 4096 keys a slot, with
           splits that hold no live key and with two row tiles) and
           lut_matmul also give the same bytes twice and from a CUDA graph
           replay
  serve    llama3.2-1b at its published widths (random weights from a
           seed) through the port's Server, 4-bit paged KV, fused
           attention, bf16, under three schemes: lq4w (weight-only,
           quant_matmul), lq2_lut (act_quant then lut_matmul) and lq8
           (act_quant then quant_matmul); each pool's decode step and
           prefill bucket run as captured CUDA graphs (decode_compilations
           must be 1), then the same requests run with every step issued
           eagerly on the same engine (tokens must be identical); launch
           counts must match each path in both runs
  profile  torch.profiler over steady decode steps of each scheme, by
           graph replay and eagerly: device busy time per step against the
           host-clock step (idle share, also against untraced steps), the
           device operations seen beside the decode graph's nodes; and over
           prefills of one 176-token bucket; the port's kernel nodes in
           each graph must be exactly the path's launches a call
  parity   the same requests through the port on the card (kernels) and on
           the CPU (plain versions), f32, 2 layers at full width: lq4w
           (greedy tokens identical, logits within a stated tolerance),
           then lq8 and lq2_lut, whose act_quant codes are compared call by
           call (see phase_parity_act)
  timing   CUDA-event times of each kernel (device time from CUDA-graph
           replays, with the eager loop that the wrapper's host work paces
           beside it), its plain version and a library call computing the
           same function, beside the card's bound; paged_attention at the
           serve shape and at 4096 keys a slot; quant_matmul (lq4w, lq8)
           and lut_matmul (2 and 4 bits) also at M = 176, the prefill
           bucket's route; a one-element add's graph node beside
           act_quant's per-call time

then a ``{"kernels": [...]}`` summary line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failed check raises and the script
exits non-zero; without a CUDA card it exits non-zero before any result.
It imports nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
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
F32_FLOPS = 67e12                # f32 outside the tensor cores, same source
SEED = 0

# the main paths' geometry (README: serve --scheme lq4w|lq2_lut|lq8
# --kv-bits 4 --continuous N --fused-attention)
SLOTS, PAGE, KV_GROUP, KV_BITS = 4, 16, 16, 4
SCHEMES = ("lq4w", "lq2_lut", "lq8")
PROMPT, NEW_TOKENS, N_REQUESTS = 128, 32, 8
MAX_CONTEXT = -(-(PROMPT + NEW_TOKENS + 8) // PAGE) * PAGE      # 176


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float,
          peak: float = BF16_FLOPS) -> tuple[float, str]:
    """Least time in ms the card could take: bytes over its memory rate or
    operations over ``peak`` (the bf16 tensor-core rate by default),
    whichever is larger."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
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


def graph_time(fn, reps: int = 10, iters: int = 50) -> float:
    """Mean device ms of ``fn()`` without its host launch cost: ``reps``
    calls captured in one CUDA graph, replayed ``iters`` times between
    CUDA events.  For kernels shorter than their wrapper's host time,
    which an eager loop would measure instead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (iters * reps)


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


def ptxas_report(log: str) -> dict:
    """``{kernel<template args>: [registers, spill-store bytes, stack
    bytes]}`` of each kernel instantiation in a library's ``ptxas -v``
    log."""
    out = {}
    for chunk in log.split("Compiling entry function")[1:]:
        fn = re.search(r"'(\w+)'", chunk).group(1)
        name = re.search(r"\d+([a-z_]+_kernel)", fn)
        args = re.findall(r"L[ib](\d+)E", fn)      # int and bool args
        if "bfloat16" in fn:
            args.append("bf16")
        elif re.search(r"kernelI(?:L[ib]\d+E)*f[EL]", fn):
            args.append("f32")
        label = f"{name.group(1) if name else fn}<{','.join(args)}>"

        def num(pattern):
            hit = re.search(pattern, chunk)
            return int(hit.group(1)) if hit else None
        out[label] = [num(r"Used (\d+) registers"),
                      num(r"(\d+) bytes spill stores"),
                      num(r"(\d+) bytes stack frame")]
    return out


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build_all()
    dt = time.perf_counter() - t0
    logs = {n: p.with_suffix(".log").read_text()
            if p.with_suffix(".log").exists() else ""
            for n, p in paths.items()}
    emit({"phase": "build", "seconds": dt,
          "libraries": {n: p.name for n, p in paths.items()},
          "kernels_with_spills": {
              n: len(re.findall(r"[1-9][0-9]* bytes spill stores", log))
              for n, log in logs.items()},
          "max_registers": {
              n: max(map(int, re.findall(r"Used (\d+) registers", log)),
                     default=None) for n, log in logs.items()},
          "per_kernel": {n: ptxas_report(log) for n, log in logs.items()},
          "per_kernel_key": "[registers, spill-store bytes, stack bytes]"})


# ---------------------------------------------------------------------------
# phase: kernels against their plain versions
# ---------------------------------------------------------------------------

def same_bytes_thrice(call, where: str):
    """``call()``'s result, after checking that a second call and a CUDA
    graph replay of it give the same bytes."""
    got = call()
    again = call()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = call()
    replayed.zero_()
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{where}: two calls differ")
    if not torch.equal(got, replayed):
        raise AssertionError(f"{where}: graph replay differs from the "
                             f"eager call")
    return got


def check_quant_matmul(dev) -> dict:
    """The kernel within ``quant_matmul.error_bound`` of the plain version
    at the decode rows (M 1, 4, 7, 16: the split-K kernel, 7 a ragged tile)
    and the prefill bucket (the one-pass kernel), the 4-bit main-path
    shapes and a ragged N; every case is also called twice and replayed
    from a CUDA graph, and must give the same bytes each time."""
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases, worst = 0, {"abs": 0.0, "rel": 0.0, "ratio": 0.0}
    shapes = [(2048, 2024, 128)]                 # ragged N (not a tile)
    main = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]
    for bits in (1, 2, 3, 4, 8):
        for dtype in (torch.float32, torch.bfloat16):
            for m in (1, 4, 7, 16, MAX_CONTEXT):
                todo = shapes + ([(k, n, 128) for k, n in main]
                                 if bits == 4 else [])
                for k, n, gs in todo:
                    w = torch.randn((k, n), generator=gen, device=dev) \
                        * k ** -0.5
                    x = torch.randn((m, k), generator=gen,
                                    device=dev).to(dtype)
                    packed, scale, zmin = ref.quantize_weight(w, bits, gs)

                    def call():
                        return qm.quant_matmul(x, packed, scale, zmin,
                                               bits=bits, group_size=gs)
                    where = (f"quant_matmul bits={bits} {dtype} M={m} K={k}"
                             f" N={n}")
                    got = same_bytes_thrice(call, where)
                    want = qm.plain(x, packed, scale, zmin, bits=bits,
                                    group_size=gs)
                    wd = ref.dequantize_weight(packed, scale, zmin, bits, gs)
                    tol = qm.error_bound(x, wd, want)
                    err = (got.float() - want.float()).abs()
                    ratio = float((err / tol.clamp_min(1e-30)).max())
                    if not bool((err <= tol).all()):
                        raise AssertionError(
                            f"{where}: max err {float(err.max())}, "
                            f"{ratio:.2f}x the bound")
                    worst["abs"] = max(worst["abs"], float(err.max()))
                    worst["rel"] = max(worst["rel"], float(
                        (err / want.float().abs().clamp_min(1e-6)).max()))
                    worst["ratio"] = max(worst["ratio"], ratio)
                    cases += 1
    return {"cases": cases, "max_abs_err": worst["abs"],
            "max_rel_err": worst["rel"], "max_err_over_bound": worst["ratio"],
            "deterministic": True, "graph_replay_equal": True}


LONG_CONTEXT = 4096              # keys per slot of the long-context case


def paged_case(dev, bits, dtype, lq, gen, *, pos=None, pps=None):
    """A decode step's paged-attention inputs at the main path's shapes:
    4 slots, 8 kv heads x 4 groups, head_dim 64, page 16, ``pps`` table
    entries per slot (11 by default, the serve phase's 176-token bucket),
    slots at ragged positions ``pos``; scratch page 0 is filled with large
    garbage and table entries past each slot's live pages point at it, as
    the pool hands them over."""
    from repro_torch.core import kvwire
    pps = pps or MAX_CONTEXT // PAGE
    pos = pos or [159, 160 - lq, 150, 37]
    b, kvh, g, d = len(pos), 8, 4, 64
    n_pages = b * pps + 1
    kf = torch.randn((n_pages, PAGE, kvh, d), generator=gen, device=dev)
    vf = torch.randn((n_pages, PAGE, kvh, d), generator=gen, device=dev)
    kf[0], vf[0] = 1e4, -1e4
    q = torch.randn((b, lq, kvh, g, d), generator=gen, device=dev).to(dtype)
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    table = torch.zeros((b, pps), dtype=torch.int32, device=dev)
    for i in range(b):
        live = (int(pos[i]) + lq - 1) // PAGE + 1
        table[i, :live] = 1 + i * pps + torch.arange(live, device=dev)
    if bits is None:
        return q, kf.to(dtype), vf.to(dtype), table, pos
    return (q, kvwire.quantize_kv(kf, bits, KV_GROUP),
            kvwire.quantize_kv(vf, bits, KV_GROUP), table, pos)


def paged_cases(lq):
    """The checked cases beyond the serve shape's: ``(name, bits, dtype,
    keyword arguments of paged_case, forced splits)``.  Long context: 4
    slots near 4096 keys; empty splits: a 64-entry table whose slots sit at
    positions 0 and 37, so that most splits hold only scratch or masked
    pages (under plan()'s splits and under one split per entry)."""
    long = [LONG_CONTEXT - lq, LONG_CONTEXT - 9 - lq, 4000, 3901]
    return [("long_context", 4, torch.bfloat16,
             {"pos": long, "pps": LONG_CONTEXT // PAGE}, None),
            ("empty_splits", 4, torch.bfloat16,
             {"pos": [0, 37], "pps": 64}, None),
            ("empty_splits_one_entry_each", 4, torch.bfloat16,
             {"pos": [0, 37], "pps": 64}, 64)]


@contextlib.contextmanager
def forced_splits(splits):
    """Run the paged-attention kernels under ``splits`` splits (None: the
    plan's): ``launch_args`` looks ``plan`` up at each call."""
    from repro_torch.kernels import paged_attention as pa
    plan = pa.plan
    if splits is not None:
        pa.plan = lambda *shape: splits
    try:
        yield
    finally:
        pa.plan = plan


def check_paged_attention(dev) -> dict:
    """The kernels within ``paged_attention.error_bound`` of the plain
    version: bits None/8/4/2/1 x f32/bf16 q x Lq 1/3 at the serve shape,
    then the long-context and empty-split cases at 4 bits, bf16, Lq 1/3,
    and a speculative verify of Lq 9 (36 query rows a kv head: two row
    tiles).  Every case is called twice and replayed from a CUDA graph
    (same bytes), and every dequant selector the case takes gives the same
    bytes; dequant='lut' at 8 bits must raise."""
    from repro_torch.kernels import paged_attention as pa
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    cases, worst = [], {"abs": 0.0, "rel": 0.0, "ratio": 0.0}
    todo = [(f"bits={bits} {dtype} Lq={lq}", bits, dtype, lq, {}, None)
            for bits in (None, 8, 4, 2, 1)
            for dtype in (torch.float32, torch.bfloat16) for lq in (1, 3)]
    todo += [(f"{name} Lq={lq}", bits, dtype, lq, kw, splits)
             for lq in (1, 3)
             for name, bits, dtype, kw, splits in paged_cases(lq)]
    todo.append(("row_tiles Lq=9", 4, torch.bfloat16, 9, {}, None))
    for where, bits, dtype, lq, kw, splits in todo:
        q, kp, vp, table, pos = paged_case(dev, bits, dtype, lq, gen, **kw)

        def call(dq="auto"):
            with forced_splits(splits):
                return pa.paged_attention(q, kp, vp, table, pos, dequant=dq)
        got = same_bytes_thrice(call, f"paged_attention {where}")
        for dq in ("affine",) if bits == 8 else ("affine", "lut"):
            if not torch.equal(got, call(dq)):
                raise AssertionError(f"paged_attention {where}: "
                                     f"dequant={dq} differs from auto")
        want = pa.plain(q, kp, vp, table.long(), pos.long())
        tol = pa.error_bound(q, kp, vp, table, pos, want)
        err = (got.float() - want.float()).abs()
        ratio = float((err / tol).max())
        if not bool((err <= tol).all()) or bool(got.isnan().any()):
            raise AssertionError(
                f"paged_attention {where}: max err {float(err.max())}, "
                f"{ratio:.2f}x the bound")
        worst["abs"] = max(worst["abs"], float(err.max()))
        worst["rel"] = max(worst["rel"], float(
            (err / want.float().abs().clamp_min(1e-6)).max()))
        worst["ratio"] = max(worst["ratio"], ratio)
        b, _, kvh, g, _ = q.shape
        cases.append({"case": where, "splits": splits or pa.plan(
            b, kvh, lq * g, table.shape[1], PAGE), "err_over_bound": ratio})
    q, kp, vp, table, pos = paged_case(dev, 8, torch.bfloat16, 1, gen)
    try:
        pa.paged_attention(q, kp, vp, table, pos, dequant="lut")
    except ValueError:
        pass
    else:
        raise AssertionError("dequant='lut' at 8 bits did not raise")
    return {"cases": len(cases), "max_abs_err": worst["abs"],
            "max_rel_err": worst["rel"], "max_err_over_bound": worst["ratio"],
            "deterministic": True, "graph_replay_equal": True,
            "selectors_equal": True, "per_case": cases}


# one llama3.2-1b layer's 7 projections (q k v o gate up down): where each
# weight sits in a layer's params, and its (K, N)
PROJECTION_NAMES = (("mixer", "wq"), ("mixer", "wk"), ("mixer", "wv"),
                    ("mixer", "wo"), ("ffn", "wi_gate"), ("ffn", "wi_up"),
                    ("ffn", "wo"))
PROJECTIONS = ((2048, 2048), (2048, 512), (2048, 512), (2048, 2048),
               (2048, 8192), (2048, 8192), (8192, 2048))
LABELS = ("q", "k", "v", "o", "gate", "up", "down")


def check_act_quant(dev) -> dict:
    """The kernel's codes, scale and zmin equal the plain version's byte
    for byte; every case has one region of range 0."""
    from repro_torch.kernels import act_quant as aq
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    cases = 0
    for bits in (1, 2, 3, 4, 8):
        for dtype in (torch.float32, torch.bfloat16):
            for m in (1, SLOTS, MAX_CONTEXT):
                for k in (2048, 8192):
                    x = torch.randn((m, k), generator=gen, device=dev)
                    x[0, 128:256] = 0.25
                    x = x.to(dtype)
                    got = aq.act_quant(x, bits=bits, group_size=128)
                    want = aq.plain(x, bits=bits, group_size=128)
                    torch.cuda.synchronize()
                    for name, g, w in zip(("codes", "scale", "zmin"),
                                          got, want):
                        if g.shape != w.shape or not torch.equal(g, w):
                            raise AssertionError(
                                f"act_quant bits={bits} {dtype} M={m} K={k}:"
                                f" {name} differ from the plain version")
                    cases += 1
    return {"cases": cases, "max_abs_err": 0.0, "max_rel_err": 0.0,
            "max_err_over_bound": 0.0}


def check_lut_matmul(dev) -> dict:
    """The kernel within ``lut_matmul.error_bound`` of the plain version
    at bits 1-4, the decode rows (M 1, 4, 7, 16: the split-K kernel, 7 a
    ragged tile) and the prefill bucket (the one-pass kernel), over the 7
    projection shapes and a ragged N, codes from the plain act_quant of a
    random x; every case is also called twice and replayed from a CUDA
    graph, and must give the same bytes each time."""
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import lut_matmul as lm
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    cases, worst = 0, {"abs": 0.0, "rel": 0.0, "ratio": 0.0}
    for bits in (1, 2, 3, 4):
        for m in (1, 4, 7, 16, MAX_CONTEXT):
            for k, n in PROJECTIONS + ((2048, 2024),):
                x = torch.randn((m, k), generator=gen, device=dev)
                w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
                a = aq.plain(x, bits=bits, group_size=128)
                where = f"lut_matmul bits={bits} M={m} K={k} N={n}"
                got = same_bytes_thrice(
                    lambda: lm.lut_matmul(*a, w, bits=bits, group_size=128),
                    where)
                want = lm.plain(*a, w, bits=bits, group_size=128)
                tol = lm.error_bound(*a, w, want, bits=bits, group_size=128)
                err = (got - want).abs()
                ratio = float((err / tol).max())
                if not bool((err <= tol).all()):
                    raise AssertionError(
                        f"{where}: max err {float(err.max())}, {ratio:.2f}x "
                        f"the bound")
                worst["abs"] = max(worst["abs"], float(err.max()))
                worst["rel"] = max(worst["rel"], float(
                    (err / want.abs().clamp_min(1e-6)).max()))
                worst["ratio"] = max(worst["ratio"], ratio)
                cases += 1
    return {"cases": cases, "max_abs_err": worst["abs"],
            "max_rel_err": worst["rel"], "max_err_over_bound": worst["ratio"],
            "deterministic": True, "graph_replay_equal": True}


def phase_kernels(dev) -> dict:
    checks = {"quant_matmul": check_quant_matmul(dev),
              "paged_attention": check_paged_attention(dev),
              "act_quant": check_act_quant(dev),
              "lut_matmul": check_lut_matmul(dev)}
    emit({"phase": "kernels", "checks": checks,
          "tolerance": "elementwise bounds from f32 summation order and "
                       "bf16 output rounding (error_bound in "
                       "kernels/quant_matmul.py, kernels/paged_attention.py "
                       "and kernels/lut_matmul.py); act_quant byte for byte",
          "tf32": False})
    return checks


# ---------------------------------------------------------------------------
# phase: serve at full width
# ---------------------------------------------------------------------------

def _engine_class():
    from repro_torch.serve.engine import PagedEngine

    class TimedEngine(PagedEngine):
        """PagedEngine that times each prefill and decode step on the host
        clock (a step ends in a copy of its tokens to the host) and checks
        that its logits are finite.  ``eager`` (set by this script, not an
        engine option) runs each step's body operation by operation
        (``_run_eager``) instead of replaying its graph; ``record`` keeps
        the logits of the live rows and the tokens each call emits for the
        parity phases, and ``forced`` (the emitted tokens of another run)
        makes each call emit those instead of its own greedy tokens."""

        def __init__(self, *a, record=False, forced=None, **kw):
            super().__init__(*a, **kw)
            self.prefill_ms, self.decode_ms = [], []
            self.logits = [] if record else None
            self.emitted = [] if record else None
            self.forced = forced
            self.eager = False

        def _emit(self, out):
            if self.forced is not None:
                out = self.forced[len(self.emitted)]
            if self.emitted is not None:
                self.emitted.append(out)
            return out

        def prefill_request(self, pool, tokens, page_ids):
            t0 = time.perf_counter()
            out = super().prefill_request(pool, tokens, page_ids)
            self.prefill_ms.append((time.perf_counter() - t0) * 1e3)
            return self._emit(out)

        def decode_step_batch(self, pool, tokens, page_table, pos):
            t0 = time.perf_counter()
            out = super().decode_step_batch(pool, tokens, page_table, pos)
            self.decode_ms.append((time.perf_counter() - t0) * 1e3)
            return self._emit(out)

        def _run(self, kind, pool):
            if self.eager:
                self._run_eager(kind, pool)
            else:
                super()._run(kind, pool)

        def _check(self, logits, rows, kind):
            if not bool(torch.isfinite(logits[rows]).all()):
                raise AssertionError("non-finite logits")
            if self.logits is not None:
                # a copy: on the CPU, float() and cpu() would hand back
                # the engine's output buffer, which the next step rewrites
                self.logits.append((kind, logits[rows].to(
                    "cpu", torch.float32, copy=True)))

        def _prefill(self, pool, tokens, page_ids):
            # the bucket's rows past the prompt are padding, whose outputs
            # no one reads (the logits are the prompt's last row's)
            self.kind = "prefill"
            self.live = torch.arange(self.pcfg.max_context) < len(tokens)
            out = super()._prefill(pool, tokens, page_ids)
            self._check(out[0], slice(None), "prefill")
            return out

        def _decode(self, pool, tokens, page_table, pos):
            # slots without a request attend over the scratch page
            self.kind = "decode"
            self.live = torch.as_tensor(np.asarray(page_table)[:, 0] != 0)
            out = super()._decode(pool, tokens, page_table, pos)
            self._check(out[0], self.live.to(out[0].device), "decode")
            return out

    return TimedEngine


def _prompts(cfg, n, length, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, length).tolist()
            for _ in range(n)]


def make_engine(cfg, params, scheme, dev, **kw):
    from repro_torch.serve.engine import EngineConfig, PagedConfig
    ecfg = EngineConfig(max_len=MAX_CONTEXT, kv_bits=KV_BITS,
                        kv_group=KV_GROUP, weight_scheme=scheme,
                        fused_attention=True)
    pcfg = PagedConfig(max_slots=SLOTS, page_size=PAGE, n_pages=64,
                       max_context=MAX_CONTEXT)
    return _engine_class()(cfg, params, ecfg, pcfg, device=dev, **kw)


def serve(engine, *, prompts, new_tokens, arrival_every=2):
    """Serve ``prompts`` through the port's Server over ``engine`` with
    staggered arrivals; returns (server, outputs, wall seconds)."""
    from repro_torch.serve.server import RequestParams, Server
    dev = engine.device
    server = Server(engine.cfg, None, engine.ecfg, engine.pcfg,
                    engine=engine)
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
    return server, [server.output(r) for r in rids], wall


def expected_launches(scheme: str, n_layers: int, prefills: int,
                      steps: int) -> dict:
    """Launches of each kernel on a scheme's path: 7 projections per layer
    in every prefill and decode step, one attention per layer and decode
    step (prefill attends in plain PyTorch)."""
    proj = 7 * n_layers * (prefills + steps)
    lut = scheme.endswith("_lut")
    act = lut or not scheme.endswith("w")
    return {"quant_matmul": 0 if lut else proj,
            "paged_attention": n_layers * steps,
            "act_quant": proj if act else 0,
            "lut_matmul": proj if lut else 0}


def _timed_serve(engine, scheme, prompts, *, eager) -> dict:
    """Serve ``prompts`` through ``engine``, by graph replay or, with
    ``eager``, each step's body issued operation by operation; the launch
    counts of the run must match the scheme's path exactly."""
    from repro_torch.kernels import wrappers as kernel_wrappers
    engine.eager = eager
    engine.prefill_ms.clear()
    engine.decode_ms.clear()
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    try:
        server, outs, wall = serve(engine, prompts=prompts,
                                   new_tokens=NEW_TOKENS)
    finally:
        engine.eager = False
    launches = {name: fn.launches for name, fn in wrappers.items()}
    st = server.stats()
    want = expected_launches(scheme, engine.cfg.n_layers, st["prefills"],
                             st["steps"])
    if launches != want:
        raise AssertionError(f"{scheme} ({'eager' if eager else 'graphed'})"
                             f": launches {launches}, want {want}")
    return {"outs": outs, "wall": wall, "stats": st, "launches": launches,
            "decode_ms": list(engine.decode_ms),
            "prefill_ms": list(engine.prefill_ms)}


def phase_serve(dev, cfg, params, scheme) -> dict:
    """The scheme's serve run through the captured steps (one graph per
    pool for the decode step and one for the prefill bucket), then the
    same requests on the same engine with each step issued eagerly: the
    tokens must be identical, and each pool must have captured its decode
    step once."""
    from repro_torch.models import transformer
    n_params = sum(a.numel() for a in transformer.leaves(params))
    engine = make_engine(cfg, params, scheme, dev)
    # warm-up request: CUDA context, allocator, cuBLAS handles, the kernel
    # builds (and a first pool's captures)
    serve(engine, prompts=_prompts(cfg, 1, 16, SEED + 7), new_tokens=2)
    torch.cuda.reset_peak_memory_stats()
    prompts = _prompts(cfg, N_REQUESTS, PROMPT, SEED)
    run = _timed_serve(engine, scheme, prompts, eager=False)
    peak = torch.cuda.max_memory_allocated()
    eager = _timed_serve(engine, scheme, prompts, eager=True)
    outs, st = run["outs"], run["stats"]
    tokens = sum(len(o) for o in outs)
    if tokens != N_REQUESTS * NEW_TOKENS or st["attention_mode"] != \
            "fused-cuda" or any(not 0 <= t < cfg.vocab_size
                                for o in outs for t in o):
        raise AssertionError(f"serve output wrong: {tokens} tokens, "
                             f"mode {st['attention_mode']}")
    step_p50 = statistics.median(run["decode_ms"])
    eager_p50 = statistics.median(eager["decode_ms"])
    row = {"phase": "serve", "model": cfg.name, "params": n_params,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "scheme": scheme, "kv_bits": KV_BITS, "kv_group": KV_GROUP,
           "dtype": cfg.dtype, "attention_mode": st["attention_mode"],
           "requests": N_REQUESTS, "prompt_len": PROMPT,
           "new_tokens": NEW_TOKENS, "max_slots": SLOTS,
           "tokens": tokens, "wall_s": run["wall"],
           "tok_per_s": tokens / run["wall"],
           "decode_steps": st["steps"], "prefills": st["prefills"],
           "decode_step_ms_p50": step_p50,
           "prefill_ms_p50": statistics.median(run["prefill_ms"]),
           "decode_compilations": st["decode_compilations"],
           "eager_decode_step_ms_p50": eager_p50,
           "eager_prefill_ms_p50": statistics.median(eager["prefill_ms"]),
           "eager_wall_s": eager["wall"],
           "graphed_over_eager_step": step_p50 / eager_p50,
           "tokens_identical_eager": eager["outs"] == outs,
           "pool_bytes": st["pool_bytes"], "preemptions": st["preemptions"],
           "max_memory_allocated": peak,
           "launches": run["launches"], "sample": outs[0][:8]}
    emit(row)
    if not row["tokens_identical_eager"]:
        raise AssertionError(f"{scheme}: the graphed steps' tokens differ "
                             f"from the eager steps'")
    if st["decode_compilations"] != 1:
        raise AssertionError(f"{scheme}: decode compilations "
                             f"{st['decode_compilations']}, want 1")
    return {"row": row, "engine": engine, "cfg": cfg}


# ---------------------------------------------------------------------------
# phase: device busy share of steady decode
# ---------------------------------------------------------------------------

PROFILE_STEPS = 16
PREFILL_CALLS = 4


# the port's device kernels (csrc/), as the profiler names them
PORT_KERNELS = ("quant_matmul_kernel", "quant_matmul_splitk_kernel",
                "lut_matmul_kernel", "lut_matmul_splitk_kernel",
                "splitk_reduce_kernel", "paged_split_kernel",
                "paged_combine_kernel", "act_quant_kernel")


def port_kernel(name: str) -> str | None:
    """Which of PORT_KERNELS a device function's name (mangled, or
    demangled as the profiler gives it) is, if any."""
    for k in PORT_KERNELS:
        if f"{len(k)}{k}" in name or re.search(rf"::{k}\b", name):
            return k
    return None


def expected_device_kernels(launches: dict, split_k: bool) -> dict:
    """The port's device kernels, by name, that ``launches`` wrapper calls
    issue: a matmul on the split-K route (M <= DECODE_M: every decode
    step) launches its kernel and the shared fixed-order reduction, on
    the one-pass route (the prefill bucket) one kernel; paged_attention
    its split kernel and the combine; act_quant one kernel."""
    mm = "_splitk_kernel" if split_k else "_kernel"
    matmuls = launches["quant_matmul"] + launches["lut_matmul"]
    want = {"quant_matmul" + mm: launches["quant_matmul"],
            "lut_matmul" + mm: launches["lut_matmul"],
            "splitk_reduce_kernel": matmuls if split_k else 0,
            "paged_split_kernel": launches["paged_attention"],
            "paged_combine_kernel": launches["paged_attention"],
            "act_quant_kernel": launches["act_quant"]}
    return {k: v for k, v in want.items() if v}


def _device_busy(prof, steps: int) -> dict:
    """Union of the device intervals (kernels, copies, sets) a profiler
    window recorded, with the kernels that took the most device time and
    the launches of each of the port's kernels a step."""
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
    paged = sum(e.self_device_time_total for e in prof.key_averages()
                if "paged_" in e.key)
    port = {}
    for e in prof.key_averages():
        k = port_kernel(e.key)
        if k and e.self_device_time_total > 0:
            port[k] = port.get(k, 0) + e.count / steps
    return {"device_busy_ms_per_step": busy_us / 1e3 / steps,
            "device_ops_per_step": len(spans) / steps,
            "paged_attention_ms_per_step": paged / 1e3 / steps,
            "port_kernels_per_step": port,
            "top_device_ms_per_step": [
                {"name": k[:60], "ms": ms, "per_step": c}
                for k, ms, c in by_name[:8]]}


def _profiled(fn, calls: int) -> dict:
    """``torch.profiler`` (CUDA activity only, to disturb the host little)
    over ``calls`` calls of ``fn``: host-clock ms a call, the device's busy
    time and operations a call (``_device_busy``) and its idle share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    busy = _device_busy(prof, calls)
    return {"host_step_ms": wall_ms, **busy, "device_idle_share":
            1.0 - busy["device_busy_ms_per_step"] / wall_ms}


def graph_nodes(engine, kind: str, pool) -> tuple[int, dict]:
    """The nodes (kernels, copies, sets) of the graph the engine captured
    for step ``kind`` of ``pool``, and its kernel nodes of the port's
    kernels by name: what every replay launches, read from the
    ``cudaGraph_t`` that the graph keeps through libcuda."""
    import ctypes
    cuda = ctypes.CDLL("libcuda.so.1")

    def check(status, what):
        if status != 0:
            raise RuntimeError(f"{what} failed with CUresult {status}")

    graph = ctypes.c_void_p(engine._graphs[pool][kind].graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(cuda.cuGraphGetNodes(graph, None, ctypes.byref(count)),
          "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    check(cuda.cuGraphGetNodes(graph, nodes, ctypes.byref(count)),
          "cuGraphGetNodes")
    port = {}
    for node in nodes:
        node_type = ctypes.c_int(-1)
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(node_type)),
              "cuGraphNodeGetType")
        if node_type.value != 0:             # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func, 7 ints, kernelParams, extra,
        # kern (pointer 7), ctx; the array leaves room to spare
        params = (ctypes.c_void_p * 16)()
        check(cuda.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                                 params),
              "cuGraphKernelNodeGetParams")
        func = ctypes.c_void_p(params[0])
        if not func.value:
            check(cuda.cuKernelGetFunction(ctypes.byref(func),
                                           ctypes.c_void_p(params[7])),
                  "cuKernelGetFunction")
        name = ctypes.c_char_p()
        check(cuda.cuFuncGetName(ctypes.byref(name), func), "cuFuncGetName")
        k = port_kernel(name.value.decode())
        if k:
            port[k] = port.get(k, 0) + 1
    return count.value, port


def phase_profile(serve_out) -> dict:
    """The serve phase's engine with every slot busy: PROFILE_STEPS // 2
    decode steps on the host clock alone, then ``torch.profiler`` over
    PROFILE_STEPS steps by graph replay and PROFILE_STEPS steps issued
    eagerly.  Each window gives the device's busy time per step against
    its host-clock step, so the device idle share is measured, not
    inferred; tracing slows the graphed step, so the idle share is also
    given against the untraced steps.  Beside the device operations the
    graphed window saw a step stands the count expected, the nodes of the
    decode graph (``graph_nodes``); the step also copies its inputs in and
    its tokens out, and this script checks its logits, outside the graph.
    Then PREFILL_CALLS prefills of a PROMPT-token request through the
    pool's prefill graph (the MAX_CONTEXT bucket), with their busy time,
    idle share and top kernels.  The kernel nodes of the port's kernels
    in each graph must be exactly those the scheme's path launches a call
    (``expected_device_kernels``); the profiler's counts of them stand
    beside."""
    from repro_torch.serve.server import RequestParams, Server
    engine, cfg = serve_out["engine"], serve_out["cfg"]
    server = Server(cfg, None, engine.ecfg, engine.pcfg, engine=engine)
    for p in _prompts(cfg, SLOTS, PROMPT, SEED + 8):
        server.submit(p, RequestParams(max_new_tokens=MAX_CONTEXT - PROMPT))
    for _ in range(3):        # admit and prefill every slot (and capture)
        server.step()
    if len(server.scheduler.active_requests()) != SLOTS:
        raise AssertionError("profile window needs every slot busy")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS // 2):
        server.step()
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3 / (PROFILE_STEPS // 2)
    graphed = _profiled(server.step, PROFILE_STEPS)
    engine.eager = True
    try:
        eager = _profiled(server.step, PROFILE_STEPS)
    finally:
        engine.eager = False
    if len(server.scheduler.active_requests()) != SLOTS:
        raise AssertionError("a request finished inside the windows")
    pool, rid = server.pool, -1
    if not pool.alloc(rid, -(-PROMPT // PAGE)):
        raise AssertionError("no pages for the prefill window")
    prompt = _prompts(cfg, 1, PROMPT, SEED + 11)[0]
    try:
        prefill = _profiled(lambda: engine.prefill_request(
            pool, prompt, pool.pages_of(rid)), PREFILL_CALLS)
    finally:
        pool.free(rid)
    nodes, in_graph = {}, {}
    for k in ("decode", "prefill"):
        nodes[k], in_graph[k] = graph_nodes(engine, k, pool)
    scheme, layers = engine.ecfg.weight_scheme, cfg.n_layers
    want = {"decode": expected_device_kernels(
                expected_launches(scheme, layers, 0, 1), split_k=True),
            "prefill": expected_device_kernels(
                expected_launches(scheme, layers, 1, 0), split_k=False)}
    row = {"phase": "profile", "scheme": scheme,
           "steps": PROFILE_STEPS, "slots": SLOTS,
           "serve_phase_step_ms_p50": serve_out["row"]["decode_step_ms_p50"],
           "untraced_host_step_ms": untraced_ms, **graphed,
           "device_idle_share_untraced":
           1.0 - graphed["device_busy_ms_per_step"] / untraced_ms,
           "device_ops_expected_per_step": nodes["decode"],
           "graph_nodes": nodes,
           "port_kernels_in_graph": in_graph,
           "port_kernels_expected_per_step": want["decode"],
           "eager": {k: eager[k] for k in (
               "host_step_ms", "device_busy_ms_per_step",
               "device_ops_per_step", "device_idle_share",
               "paged_attention_ms_per_step", "port_kernels_per_step")},
           "prefill": {"prompt": PROMPT, "bucket": MAX_CONTEXT,
                       "calls": PREFILL_CALLS,
                       "note": "per_step keys are per prefill", **prefill,
                       "port_kernels_expected_per_step": want["prefill"]}}
    emit(row)
    # the wrappers' counts on the graphed path are what the captures
    # launched, added at each replay; a replay launches every kernel node
    # of its graph, so a graph that lost a kernel, or whose capture sent
    # one elsewhere, fails here.  The profiler's counts stand beside them
    # as the replays' measured launches, but are no gate: it can drop a
    # few events in a window (a fractional count a step).
    for kind in ("decode", "prefill"):
        if in_graph[kind] != want[kind]:
            raise AssertionError(
                f"{scheme} {kind} graph: kernel nodes {in_graph[kind]} of "
                f"the port's kernels, want {want[kind]}")
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


def _parity_setup():
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer
    cfg = dataclasses.replace(configs.get("llama3.2-1b"), n_layers=2,
                              dtype="float32")
    params = transformer.init_params(cfg, SEED + 3, "cpu")
    return cfg, params, _prompts(cfg, SLOTS, 64, SEED + 3)


def _logit_diffs(g_log, c_log) -> list[float]:
    if len(g_log) != len(c_log):
        raise AssertionError(f"{len(g_log)} logit calls on the card, "
                             f"{len(c_log)} on the CPU")
    return [float((a - b).abs().max()) for (_, a), (_, b)
            in zip(g_log, c_log)]


def phase_parity(dev, cfg, params, prompts) -> dict:
    """The weight-only parity run: lq4w, free running, the card's captured
    steps against the CPU's eager ones, greedy tokens identical and logits
    within PARITY_LOGIT_TOL."""
    from repro_torch.models import transformer
    runs = []
    for d in (dev, torch.device("cpu")):
        engine = make_engine(cfg, transformer.params_to(params, d), "lq4w",
                             d, record=True)
        _, outs, _ = serve(engine, prompts=prompts, new_tokens=8)
        runs.append((outs, engine.logits))
    (g_out, g_log), (c_out, c_log) = runs
    diffs = _logit_diffs(g_log, c_log)
    row = {"phase": "parity", "scheme": "lq4w", "layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": "float32",
           "requests": len(prompts), "logit_calls": len(diffs),
           "max_abs_logit_diff": max(diffs),
           "median_abs_logit_diff": statistics.median(diffs),
           "per_call": [[k, d] for (k, _), d in zip(g_log, diffs)],
           "max_abs_logit": max(float(a.abs().max()) for _, a in c_log),
           "tolerance": PARITY_LOGIT_TOL,
           "tokens_identical": g_out == c_out}
    emit(row)
    if g_out != c_out:
        raise AssertionError("greedy tokens differ between card and CPU")
    if max(diffs) > PARITY_LOGIT_TOL:
        raise AssertionError(f"logits differ by {max(diffs)}")
    return row


class ActQuantTap:
    """Wraps ``ops.act_quant`` (what ``quant_dense`` calls) for one run.

    ``record``: keeps every call's input and outputs on the host, in call
    order.  ``share``: each call's own outputs are compared with the
    reference record at the same place, then the call returns the
    reference's outputs, so the forward goes on from the reference's
    codes and every difference that reaches a later call is f32 noise,
    not a flipped code's wake.

    Per compared call, over the rows of live requests (``engine.live``:
    the prompt's rows of a prefill bucket, the busy slots of a decode
    step): codes that differ, their largest difference, and the flips that the two sides'
    measured input noise predicts, E = sum_i min(1, |u_i - u'_i|) over
    u = (x - zmin) / scale: a code flips when a rounding boundary lies
    between u and u', which for a fractional part spread evenly happens
    with probability |u - u'|.  The other rows reach no output, and their
    differing codes are counted apart by the kind of call: a prefill
    bucket's padding rows (pad tokens past the prompt; prefill attends in
    plain PyTorch over the bucket, and only the prompt's last row's
    logits are read) and a decode step's idle slots (their page-table
    rows point at the scratch page, which idle slots and padding write
    in an order that differs between the devices)."""

    def __init__(self, mode, engine, reference=None):
        self.mode, self.engine, self.reference = mode, engine, reference
        self.records, self.stats = [], []

    def __enter__(self):
        from repro_torch.kernels import ops
        self._ops, self._inner = ops, ops.act_quant
        ops.act_quant = self
        return self

    def __exit__(self, *exc):
        self._ops.act_quant = self._inner

    def __call__(self, x, *, bits, group_size):
        out = self._inner(x, bits=bits, group_size=group_size)
        host = [x.float().cpu()] + [t.cpu() for t in out]
        if self.mode == "record":
            self.records.append(host)
            return out
        ref = self.reference[len(self.stats)]
        self.stats.append({"kind": self.engine.kind,
                           **self._compare(host, ref, self.engine.live,
                                           bits, group_size)})
        return tuple(t.to(x.device) for t in ref[1:])

    @staticmethod
    def _compare(got, ref, live, bits, gs) -> dict:
        from repro_torch.core import packing

        def steps(x, scale, zmin):
            m, k = x.shape
            return ((x.reshape(m, k // gs, gs) - zmin[..., None])
                    / scale[..., None]).reshape(m, k)
        diff = (packing.unpack(got[1], bits).int()
                - packing.unpack(ref[1], bits).int()).abs()
        du = (steps(got[0], got[2], got[3])
              - steps(ref[0], ref[2], ref[3])).abs()[live]
        return {"codes": du.numel(), "differ": int((diff[live] > 0).sum()),
                "max_diff": int(diff[live].max()),
                "expected": float(du.clamp_max(1.0).sum()),
                "dead_differ": int((diff[~live] > 0).sum()),
                "dead_max_diff": int(diff[~live].max()) if (~live).any()
                else 0}


def _code_summary(stats) -> dict:
    n = sum(s["codes"] for s in stats)
    d = sum(s["differ"] for s in stats)
    e = sum(s["expected"] for s in stats)
    return {"calls": len(stats), "codes": n, "differ": d, "share": d / n,
            "max_diff": max(s["max_diff"] for s in stats),
            "expected_flips": e,
            "dead_rows": {k: {"differ": sum(s["dead_differ"] for s in of),
                              "max_diff": max(s["dead_max_diff"] for s in of)}
                          for k in ("prefill", "decode")
                          for of in [[s for s in stats if s["kind"] == k]]},
            "flip_bound": e + 4 * e ** 0.5 + 4}


def phase_parity_act(dev, cfg, params, prompts, scheme) -> dict:
    """Card against CPU under an activation-quantized scheme.

    The CPU run goes first, free running, and records every act_quant
    call and the tokens each engine call emits.  Then the card runs: its
    act_quant runs (the kernel, on the card's inputs), is compared with
    the CPU's call at the same place, then hands on the CPU's codes.
    Gates: codes differ by at most 1, no more often than the flips the
    measured input noise predicts, E, plus 4 sqrt(E) + 4, and every
    call's logits within PARITY_LOGIT_TOL.  lq8 runs free: its greedy
    tokens must equal the CPU's; lq2_lut is teacher-forced on the CPU's
    tokens (at 2 bits one flipped code moves its row by a third of its
    region's range, enough to change a greedy token)."""
    from repro_torch.models import transformer
    per_call = 7 * cfg.n_layers            # act_quant calls per logit call
    cpu_engine = make_engine(cfg, params, scheme, torch.device("cpu"),
                             record=True)
    with ActQuantTap("record", cpu_engine) as ref:
        _, c_out, _ = serve(cpu_engine, prompts=prompts, new_tokens=8)
    forced = None if scheme == "lq8" else cpu_engine.emitted
    engine = make_engine(cfg, transformer.params_to(params, dev), scheme,
                         dev, record=True, forced=forced)
    # the tap reads each call's codes back to the host, which no captured
    # step can do: this run issues every step eagerly
    engine.eager = True
    with ActQuantTap("share", engine, ref.records) as tap:
        _, g_out, _ = serve(engine, prompts=prompts, new_tokens=8)
    diffs = _logit_diffs(engine.logits, cpu_engine.logits)
    if len(tap.stats) != per_call * len(diffs):
        raise AssertionError(f"{len(tap.stats)} act_quant calls for "
                             f"{len(diffs)} logit calls")
    row = {"phase": "parity", "scheme": scheme, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": "float32",
           "requests": len(prompts), "tolerance": PARITY_LOGIT_TOL,
           **_code_summary(tap.stats),
           "teacher_forced": forced is not None,
           "tokens_identical": g_out == c_out,
           "logit_calls": len(diffs), "max_abs_logit_diff": max(diffs),
           "per_call": [[k, d] for (k, _), d in zip(engine.logits, diffs)]}
    emit(row)
    if not row["tokens_identical"]:
        raise AssertionError(f"{scheme}: greedy tokens differ between card "
                             f"and CPU")
    if row["max_diff"] > 1 or row["differ"] > row["flip_bound"]:
        raise AssertionError(f"{scheme}: act_quant codes differ by up to "
                             f"{row['max_diff']} on {row['differ']} codes "
                             f"(bound {row['flip_bound']:.1f})")
    if row["max_abs_logit_diff"] > PARITY_LOGIT_TOL:
        raise AssertionError(f"{scheme}: logits from shared codes differ by "
                             f"{row['max_abs_logit_diff']}")
    return row


# ---------------------------------------------------------------------------
# phase: timing
# ---------------------------------------------------------------------------

def kernel_split_us(fn, calls: int = 20) -> dict:
    """Mean device us per call of each kernel ``fn`` launches (eager calls
    under torch.profiler), keyed by the kernel's name: the split-K kernel
    and its reduction, or the one-pass kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {(re.findall(r"\w+_kernel", e.key) or [e.key[:40]])[0]:
            e.self_device_time_total / calls
            for e in prof.key_averages() if e.self_device_time_total > 0}


def quant_matmul_layer(qws, m: int, gen, reps: int = 2,
                       iters: int = 20) -> dict:
    """One layer's 7 projections at M = ``m``, bf16 x, timed over every
    layer's own packed weights ``qws`` (so they stream from memory as on
    the path) by graph replay, per layer: the kernel (``ms``),
    ``torch.matmul`` on the bf16 dequantized weights (``library_ms``) and
    the bound.  M <= 16 runs the split-K kernel, larger M the one-pass
    kernel (the prefill bucket's route).  Returns ``(times, xs, kernel)``,
    the inputs by K and the timed loop beside the times."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_matmul as qm
    dev = qws[0][0].packed.device
    xs = {qw.k: torch.randn((m, qw.k), generator=gen,
                            device=dev).to(torch.bfloat16)
          for qw in qws[0]}
    wd = [[ops.dequantize_weight(qw, torch.bfloat16) for qw in row]
          for row in qws]

    def kernel():
        for row in qws:
            for qw in row:
                qm.quant_matmul(xs[qw.k], qw.packed, qw.scale, qw.zmin,
                                bits=qw.bits, group_size=qw.group_size)

    def library():
        for row in wd:
            for w in row:
                torch.matmul(xs[w.shape[0]], w)
    nbytes = flops = 0
    for qw in qws[0]:
        nbytes += qw.nbytes() + m * qw.k * 2 + m * qw.n * 2
        flops += 2 * m * qw.k * qw.n
    b_ms, b_by = bound(nbytes, flops)
    n_layers = len(qws)
    return ({"ms": graph_time(kernel, reps, iters) / n_layers,
             "library_ms": graph_time(library, reps, iters) / n_layers,
             "bound_ms": b_ms, "bound_by": b_by,
             "route": "split-K" if m <= qm.DECODE_M else "one-pass"},
            xs, kernel)


def _projections(engine) -> list:
    """Every layer's 7 projection weights (QWeight) of an engine."""
    return [[lay[a][b]["w"] for a, b in PROJECTION_NAMES]
            for lay in engine.params["layers"]]


def time_quant_matmul(engine, cfg) -> dict:
    """One decode step's worth of projections (7 per layer, every layer's
    own weights, so the weights stream from memory as on the path) at M =
    max_slots, bf16 x; per-layer times are that over the layer count.
    ``ms``, ``library_ms`` and ``per_projection_hot_l2`` are device time
    from CUDA-graph replays; ``eager_ms`` is the same calls in an eager
    loop, which the wrapper's host work paces once the kernel is short;
    ``kernel_us`` splits a projection's call between its kernels.
    ``at_m16`` times the same at M = 16, the split-K kernel's other tile
    (BM 16), and ``at_m176`` at M = MAX_CONTEXT, the prefill bucket's
    one-pass route, each against ``torch.matmul`` and its own bound."""
    from repro_torch.kernels import quant_matmul as qm
    qws = _projections(engine)
    n_layers = len(qws)
    gen = torch.Generator(device=engine.device).manual_seed(SEED + 5)
    main, xs, kernel = quant_matmul_layer(qws, SLOTS, gen)

    def plain():
        for row in qws:
            for qw in row:
                qm.plain(xs[qw.k], qw.packed, qw.scale, qw.zmin,
                         bits=qw.bits, group_size=qw.group_size)

    def one(qw):
        return lambda: qm.quant_matmul(xs[qw.k], qw.packed, qw.scale,
                                       qw.zmin, bits=qw.bits,
                                       group_size=qw.group_size)

    per_proj = {lab: {"K": qw.k, "N": qw.n,
                      "plan": list(qm.plan(SLOTS, qw.k, qw.n, qw.bits)),
                      "ms": graph_time(one(qw)),
                      "kernel_us": kernel_split_us(one(qw))}
                for lab, qw in zip(LABELS, qws[0])}
    at = {m: quant_matmul_layer(qws, m, gen, reps=1 if m > 16 else 2,
                                iters=10 if m > 16 else 20)[0]
          for m in (16, MAX_CONTEXT)}
    return {**main,
            "eager_ms": cuda_time(kernel, 20) / n_layers,
            "plain_ms": cuda_time(plain, 3, warmup=1) / n_layers,
            "shape": f"one layer's 7 projections at M={SLOTS}, bf16 x, "
                     f"lq4w (K,N) as in per_projection; timed over all "
                     f"{n_layers} layers' own weights",
            "per_projection_hot_l2": per_proj,
            "at_m16": {**at[16], "plans": {
                lab: list(qm.plan(16, qw.k, qw.n, qw.bits))
                for lab, qw in zip(LABELS, qws[0])}},
            "at_m176": at[MAX_CONTEXT]}


def time_prefill_quant_matmul(engine) -> dict:
    """``quant_matmul_layer`` at M = MAX_CONTEXT over another scheme's
    weights (lq8: 8-bit codes)."""
    gen = torch.Generator(device=engine.device).manual_seed(SEED + 12)
    return quant_matmul_layer(_projections(engine), MAX_CONTEXT, gen,
                              reps=1, iters=10)[0]


def time_paged_attention(dev) -> dict:
    """One layer's paged attention at decode, bf16 q, 4-bit pages, distinct
    pages per slot: 4 slots near 160 keys (the serve shape), and in
    ``long_context`` near 4096.  ``ms`` and ``library_ms`` are device time
    from CUDA-graph replays; ``eager_ms`` and ``library_eager_ms`` the same
    calls in an eager loop, which host work paces once the kernel is
    short; ``kernel_us`` splits a call between the split kernel and the
    combine; ``plan`` is the split count with the block geometry.
    ``verify_lq9`` is a speculative verify at the serve shape: Lq 9, 36
    query rows a kv head, two row tiles."""
    from repro_torch.kernels import paged_attention as pa
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    out = timed_paged(dev, gen, [159, 158, 152, 160], MAX_CONTEXT // PAGE)
    q, kp, vp, table, pos = out.pop("inputs")
    out["plain_ms"] = cuda_time(lambda: pa.plain(q, kp, vp, table.long(),
                                                 pos.long()), 50)
    long = timed_paged(dev, gen, [LONG_CONTEXT - 1] * 4,
                       LONG_CONTEXT // PAGE)
    long.pop("inputs")
    verify = timed_paged(dev, gen, [151, 150, 144, 152], MAX_CONTEXT // PAGE,
                         lq=9)
    verify.pop("inputs")
    return {**out, "long_context": long, "verify_lq9": verify,
            "library": "scaled_dot_product_attention on the gathered, "
                       "dequantized bf16 cache"}


def timed_paged(dev, gen, pos, pps, lq=1) -> dict:
    """The timing fields of one paged-attention shape (see
    time_paged_attention), with the bound of these inputs."""
    from repro_torch.core import kvwire
    from repro_torch.kernels import paged_attention as pa
    q, kp, vp, table, posb = paged_case(dev, KV_BITS, torch.bfloat16, lq,
                                        gen, pos=pos, pps=pps)
    b, lq, kvh, g, d = q.shape
    for i in range(b):                    # distinct pages, no scratch
        live = (pos[i] + lq - 1) // PAGE + 1
        table[i] = 0
        table[i, :live] = 1 + i * pps + torch.arange(live, device=dev)
    tbl = table.long()
    kk = kvwire.dequantize_kv(kvwire.gather_pages(kp, tbl), d,
                              torch.bfloat16)
    vv = kvwire.dequantize_kv(kvwire.gather_pages(vp, tbl), d,
                              torch.bfloat16)
    s = kk.shape[1]
    qs = q.reshape(b, lq, kvh * g, d).transpose(1, 2)           # (B,H,Lq,D)
    ks, vs = kk.transpose(1, 2), vv.transpose(1, 2)              # (B,KV,S,D)
    qpos = posb.long()[:, None] + torch.arange(lq, device=dev)   # (B, Lq)
    mask = (torch.arange(s, device=dev)[None, None, :]
            <= qpos[:, :, None])[:, None]                        # (B,1,Lq,S)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def kernel():
        return pa.paged_attention(q, kp, vp, table, posb)

    def library():
        return sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True)
    ntok = [p + lq for p in pos]
    per_tok = kvh * 2 * (d * KV_BITS // 8 + 8 * (d // KV_GROUP))
    nbytes = sum(ntok) * per_tok + 2 * q.numel() * q.element_size() \
        + table.numel() * 4 + posb.numel() * 4
    # query row i of a slot at pos sees pos + i + 1 keys
    flops = sum(4 * (p + i + 1) * kvh * g * d for p in pos for i in range(lq))
    b_ms, b_by = bound(nbytes, flops)
    splits = pa.plan(b, kvh, lq * g, pps, PAGE)
    geom = pa.geometry(lq * g, d, PAGE, pps, splits)
    return {"ms": graph_time(kernel), "eager_ms": cuda_time(kernel, 500),
            "library_ms": graph_time(library),
            "library_eager_ms": cuda_time(library, 500),
            "bound_ms": b_ms, "bound_by": b_by,
            "kernel_us": kernel_split_us(kernel),
            "plan": {"splits": splits, "blocks": b * kvh * splits * geom[-1],
                     "elems_lanes_tokens_rowteams_tokenteams_tiles":
                     list(geom)},
            "shape": f"q {tuple(q.shape)} bf16, {KV_BITS}-bit pages, page "
                     f"{PAGE}, {pps} table entries, tokens per slot {ntok}",
            "inputs": (q, kp, vp, table, posb)}


def time_act_quant(dev) -> dict:
    """One decode step's act_quant calls of a layer at M = max_slots, bf16
    x: six at K = 2048 and one at K = 8192, at 2 bits (lq2_lut) and at 8
    (lq8).  It moves a few KB per call, so the kernel takes less time
    than its wrapper's host work: ``ms`` is device time from CUDA-graph
    replays, ``eager_ms`` the eager loop that the host paces."""
    from repro_torch.kernels import act_quant as aq
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    xs = [torch.randn((SLOTS, k), generator=gen,
                      device=dev).to(torch.bfloat16)
          for k, _ in PROJECTIONS]
    out = {}
    for bits in (2, 8):
        def kernel(bits=bits):
            for x in xs:
                aq.act_quant(x, bits=bits, group_size=128)

        def plain(bits=bits):
            for x in xs:
                aq.plain(x, bits=bits, group_size=128)
        nbytes = flops = 0
        for x in xs:
            m, k = x.shape
            nbytes += m * k * 2 + m * k * bits / 8 + m * (k // 128) * 8
            flops += 6 * m * k       # min, max, sub, div, round, clip
        b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
        out[bits] = {"ms": graph_time(kernel),
                     "eager_ms": cuda_time(kernel, 200),
                     "plain_ms": cuda_time(plain, 50),
                     "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    one = torch.zeros(1, device=dev)
    return {**out[2], "eight_bit": out[8],
            "per_call_ms": out[2]["ms"] / len(xs),
            # what any kernel node of a graph costs: a one-element in-place
            # add, 112 nodes a graph (a decode step's act_quant calls)
            "kernel_node_floor_ms": graph_time(lambda: one.add_(1),
                                               reps=112, iters=50),
            "shape": f"one layer's 7 calls at M={SLOTS}, bf16 x, K 6x2048 "
                     f"+ 1x8192, 2 bits (eight_bit: the same at 8 bits)",
            "library": "none: no single PyTorch call quantizes per region"}


def time_lut_matmul(engine) -> dict:
    """One decode step's lut_matmul calls (7 per layer, every layer's own
    f32 weights, so they stream from memory as on the path) at M =
    max_slots with 2-bit codes (lq2_lut); per-layer times are that over the
    layer count.  ``ms``, ``library_ms`` and ``per_projection_hot_l2`` are
    device time from CUDA-graph replays; ``eager_ms`` is the same calls in
    an eager loop, which the wrapper's host work paces once the kernel is
    short; ``kernel_us`` splits a projection's call between its kernels.
    ``at_m16`` times the same at M = 16 and ``four_bit`` with 4-bit codes
    (lq4_lut), ``at_m176`` and ``at_m176_four_bit`` at M = MAX_CONTEXT,
    the prefill bucket's one-pass route, each against the library call and
    its own bound.  The
    library call is torch.matmul of the dequantized activations and the
    f32 weights, TF32 off."""
    from repro_torch.core import packing
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import lut_matmul as lm
    from repro_torch.kernels import ops, ref
    dev = engine.device
    ws = [[ops.dequantize_weight(lay[a][b]["w"]) for a, b in PROJECTION_NAMES]
          for lay in engine.params["layers"]]
    n_layers = len(ws)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)

    def inputs(m, bits):
        return {k: aq.plain(torch.randn((m, k), generator=gen, device=dev),
                            bits=bits, group_size=128)
                for k in sorted({k for k, _ in PROJECTIONS})}

    def kernel(acts, bits):
        def run():
            for row in ws:
                for w in row:
                    lm.lut_matmul(*acts[w.shape[0]], w, bits=bits,
                                  group_size=128)
        return run

    def library(acts, bits):
        deq = {k: ref.act_dequant(*a, bits=bits, group_size=128)
               for k, a in acts.items()}

        def run():
            for row in ws:
                for w in row:
                    torch.matmul(deq[w.shape[0]], w)
        return run

    def layer_bound(m, bits):
        nbytes = flops = 0
        for k, n in PROJECTIONS:
            g = k // 128
            nbytes += (k * n * 4 + m * (k // packing.codes_per_byte(bits)
                                        + g * 8) + m * n * 4)
            # a table add per (m, k, n), the combine and affine per
            # (m, g, n), sum_j w_j per (k, n)
            flops += m * k * n + m * g * n * (2 * ((1 << bits) - 1) + 4) \
                + k * n
        return bound(nbytes, flops, F32_FLOPS)

    def plans(m, bits):
        return {lab: list(lm.plan(m, k, n, bits))
                for lab, (k, n) in zip(LABELS, PROJECTIONS)}

    def timed(m, bits, reps=2, iters=10):
        acts = inputs(m, bits)
        b_ms, b_by = layer_bound(m, bits)
        out = {"ms": graph_time(kernel(acts, bits), reps, iters) / n_layers,
               "library_ms": graph_time(library(acts, bits), reps, iters)
               / n_layers,
               "bound_ms": b_ms, "bound_by": b_by}
        if m > lm.DECODE_M:         # the one-pass kernel takes no plan
            return {**out, "route": "one-pass"}
        return {**out, "route": "split-K", "plans": plans(m, bits)}

    acts = inputs(SLOTS, 2)

    def plain():
        for row in ws:
            for w in row:
                lm.plain(*acts[w.shape[0]], w, bits=2, group_size=128)

    def one(w):
        return lambda: lm.lut_matmul(*acts[w.shape[0]], w, bits=2,
                                     group_size=128)

    per_proj = {lab: {"K": w.shape[0], "N": w.shape[1],
                      "plan": list(lm.plan(SLOTS, *w.shape, 2)),
                      "ms": graph_time(one(w)),
                      "kernel_us": kernel_split_us(one(w))}
                for lab, w in zip(LABELS, ws[0])}
    b_ms, b_by = layer_bound(SLOTS, 2)
    return {"ms": graph_time(kernel(acts, 2), reps=2, iters=10) / n_layers,
            "eager_ms": cuda_time(kernel(acts, 2), 10) / n_layers,
            "plain_ms": cuda_time(plain, 2, warmup=1) / n_layers,
            "library_ms": graph_time(library(acts, 2), reps=2, iters=10)
            / n_layers,
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"one layer's 7 projections at M={SLOTS}, 2-bit codes, "
                     f"f32 W (K,N) as in per_projection; timed over all "
                     f"{n_layers} layers' own weights; bound against the "
                     f"f32 non-tensor peak",
            "library": "torch.matmul(act_dequant(a), W), f32, TF32 off, by "
                       "graph replay",
            "plans": plans(SLOTS, 2),
            "per_projection_hot_l2": per_proj,
            "at_m16": timed(16, 2),
            "four_bit": timed(SLOTS, 4),
            "at_m176": timed(MAX_CONTEXT, 2, reps=1, iters=5),
            "at_m176_four_bit": timed(MAX_CONTEXT, 4, reps=1, iters=5)}


def phase_timing(serves, dev) -> dict:
    lq4w = serves["lq4w"]
    t = {"quant_matmul": {
            **time_quant_matmul(lq4w["engine"], lq4w["cfg"]),
            "at_m176_lq8": time_prefill_quant_matmul(
                serves["lq8"]["engine"])},
         "paged_attention": time_paged_attention(dev),
         "act_quant": time_act_quant(dev),
         "lut_matmul": time_lut_matmul(serves["lq2_lut"]["engine"])}
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
    from repro_torch import configs
    from repro_torch.models import transformer
    cfg = configs.get("llama3.2-1b")
    params = transformer.init_params(cfg, SEED, dev)
    serves = {}
    for scheme in SCHEMES:
        serves[scheme] = phase_serve(dev, cfg, params, scheme)
        phase_profile(serves[scheme])
    del params
    pcfg, pparams, prompts = _parity_setup()
    phase_parity(dev, pcfg, pparams, prompts)
    for scheme in ("lq8", "lq2_lut"):
        phase_parity_act(dev, pcfg, pparams, prompts, scheme)
    timing = phase_timing(serves, dev)
    by_scheme = {sc: sv["row"]["launches"] for sc, sv in serves.items()}
    # ``launches`` is one path's count: the path of the slice that ported
    # the kernel; the other paths' counts are in launches_by_scheme
    path = {"quant_matmul": "lq4w", "paged_attention": "lq4w",
            "act_quant": "lq2_lut", "lut_matmul": "lq2_lut"}
    csrc = "src/repro_torch/kernels/csrc"
    replaces = {"quant_matmul": "src/repro/kernels/quant_matmul.py:121",
                "paged_attention": "src/repro/kernels/paged_attention.py:341",
                "act_quant": "src/repro/kernels/act_quant.py:64",
                "lut_matmul": "src/repro/kernels/lut_matmul.py:101"}
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": f"{csrc}/{name}.cu",
         "replaces": replaces[name],
         "launches": by_scheme[path[name]][name], "path": path[name],
         "launches_by_scheme": {sc: ln[name] for sc, ln in by_scheme.items()},
         "max_abs_err": checks[name]["max_abs_err"],
         "max_rel_err": checks[name]["max_rel_err"],
         "ms": timing[name]["ms"], "eager_ms": timing[name].get("eager_ms"),
         "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound_ms"],
         "bound_by": timing[name]["bound_by"],
         "library_ms": timing[name]["library_ms"],
         "shape": timing[name]["shape"]}
        for name in replaces]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
