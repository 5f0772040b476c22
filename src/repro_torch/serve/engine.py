"""Paged serving engine: bucketed prefill into pool pages and batched
greedy decode over them (port of ``repro/serve/engine.py``, paged path).

Weights are quantized offline into the packed LQ format
(``transformer.quantize_params``) and every projection runs
``ops.quant_dense``: ``quant_matmul``, after ``act_quant`` where the
scheme quantizes activations, or ``act_quant`` then ``lut_matmul`` under
the LUT schemes; K/V live in the paged pool in the wire format.  With
``fused_attention`` each layer's decode attention runs the paged-attention
kernel; without it the pages are gathered, dequantized and attended in
plain PyTorch, as the JAX package's XLA path does.

On the card each pool's decode step and prefill bucket run as one
captured CUDA graph each, the counterpart of the JAX engine's two jitted
steps: the step reads fixed-shape device buffers, which every call fills
from the host before it replays the graph.  The CPU runs the same body on
the same buffers eagerly.
"""
from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from .. import device as _device
from .. import kernels
from ..core import kvwire, schemes
from ..models import transformer
from ..models.config import ModelConfig
from ..models.layers import NO_QUANT, QuantPolicy
from .pool import PagedKVPool


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_len: int = 2048
    kv_bits: int | None = None           # None = fp cache
    kv_group: int = 64
    weight_scheme: str | None = None     # e.g. "lq4w"; None = fp weights
    a_bits: int | None = None            # overrides the scheme's a_bits
    # paged decode through the paged-attention kernel; on the card that
    # is the CUDA kernel or an error, never a silent fallback
    fused_attention: bool = False


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    """Geometry of the continuous-batching cell.  max_context bounds prompt
    + generation per request and is the prefill bucket; every decode step
    reads max_context // page_size table entries per slot."""
    max_slots: int = 4
    page_size: int = 16
    n_pages: int = 64
    max_context: int = 256

    def __post_init__(self):
        if self.max_context % self.page_size:
            raise ValueError("max_context must be a multiple of page_size")

    @property
    def pages_per_slot(self) -> int:
        return self.max_context // self.page_size


class _Buffers:
    """The fixed-shape device buffers the steps read and write.

    Each step's inputs are views of one flat int64 tensor, so that a call
    fills them with a single copy from the host: decode ``tokens`` (S, 1),
    ``pos`` (S,) and ``table`` (S, P); prefill ``bucket`` (1, C) (the
    right-padded prompt), ``page_ids`` (P,) and ``logits_pos`` (1,).  The
    outputs are the step's logits (rows, V) f32 and greedy tokens (rows,)
    int32; ``cache`` is the prefill bucket's contiguous cache, which every
    prefill overwrites whole."""

    def __init__(self, cfg: ModelConfig, pcfg: PagedConfig, kvq, device):
        s, p, c = pcfg.max_slots, pcfg.pages_per_slot, pcfg.max_context
        v = cfg.padded_vocab
        self.decode_in = torch.zeros(s * (2 + p), dtype=torch.long,
                                     device=device)
        self.tokens = self.decode_in[:s].view(s, 1)
        self.pos = self.decode_in[s:2 * s]
        self.table = self.decode_in[2 * s:].view(s, p)
        self.prefill_in = torch.zeros(c + p + 1, dtype=torch.long,
                                      device=device)
        self.bucket = self.prefill_in[:c].view(1, c)
        self.page_ids = self.prefill_in[c:c + p]
        self.logits_pos = self.prefill_in[c + p:]
        self.cache = transformer.init_cache(cfg, 1, c, kv_quant=kvq,
                                            device=device)
        self.logits = {"decode": torch.zeros((s, v), device=device),
                       "prefill": torch.zeros((1, v), device=device)}
        self.greedy = {k: torch.zeros((len(x),), dtype=torch.int32,
                                      device=device)
                       for k, x in self.logits.items()}


class _Graph:
    """One step captured for one pool.  The wrappers' ``launches`` counts
    tick in Python, which a replay does not run, so the replay adds what
    the capture launched."""

    def __init__(self, graph, launches: dict):
        self.graph, self.launches = graph, launches

    def replay(self):
        self.graph.replay()
        for fn, n in self.launches.items():
            fn.launches += n


class PagedEngine:
    """Prefill one request at a time into its pages; decode all slots at
    once.  Runs on ``device`` (the card unless ``"cpu"`` is asked for)."""

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig,
                 pcfg: PagedConfig, *, device=None):
        if pcfg.max_context > ecfg.max_len:
            raise ValueError("pcfg.max_context exceeds ecfg.max_len")
        self.cfg, self.ecfg, self.pcfg = cfg, ecfg, pcfg
        self.device = _device.resolve(device)
        if ecfg.weight_scheme is not None:
            qcfg = schemes.get(ecfg.weight_scheme)
            if ecfg.a_bits is not None:
                qcfg = dataclasses.replace(qcfg, a_bits=ecfg.a_bits)
            params = transformer.quantize_params(params, cfg, qcfg)
            self.policy = QuantPolicy.serve(qcfg)
        else:
            self.policy = NO_QUANT
        params = transformer.params_to(params, self.device)
        # the embedding is only ever read in the activation dtype (lookup
        # then cast, or cast then tied read-out): storing it so is exact
        params["embed"] = {"table": params["embed"]["table"].to(
            cfg.activation_dtype)}
        self.params = params
        self._kvq = (None if ecfg.kv_bits is None
                     else (ecfg.kv_bits, ecfg.kv_group))
        self._io = _Buffers(cfg, pcfg, self._kvq, self.device)
        # pool -> {"decode" | "prefill": _Graph}.  A graph holds the
        # addresses of its pool's pages, which the pool writes in place
        # (core/kvwire.py) and never reallocates, so it stays valid for
        # that pool and is never replayed for another; it goes with its
        # pool.  Every graph of the engine draws its memory from one pool
        # of the allocator (they never run at the same time), so serving
        # another pool adds no device memory for them.
        self._graphs = weakref.WeakKeyDictionary()
        # pool -> {kind: captures made}: a step captured again reads 2
        self._captures = weakref.WeakKeyDictionary()
        self._mempool = self._stream = None

    def new_pool(self) -> PagedKVPool:
        return PagedKVPool(self.cfg, n_pages=self.pcfg.n_pages,
                           page_size=self.pcfg.page_size,
                           kv_bits=self.ecfg.kv_bits,
                           kv_group=self.ecfg.kv_group, device=self.device)

    @property
    def attention_mode(self) -> str:
        """The paged-decode attention this engine runs: ``fused-cuda`` (the
        kernel), ``fused-plain`` (the kernel's plain version, on the CPU)
        or ``xla`` (gather -> dequantize -> attend, the unfused path)."""
        if not self.ecfg.fused_attention:
            return "xla"
        return "fused-cuda" if self.device.type == "cuda" else "fused-plain"

    def compilations(self, pool: PagedKVPool, kind: str = "decode") -> int:
        """Times step ``kind`` was captured for ``pool``: 1 once the pool
        has run it on the card (1 == no per-step recapture), 0 on the CPU,
        where nothing is captured."""
        return self._captures.get(pool, {}).get(kind, 0)

    @property
    def decode_compilations(self) -> int:
        """The most decode-step captures any one pool has made."""
        return max((c.get("decode", 0) for c in self._captures.values()),
                   default=0)

    # ------------------------------------------------------------ steps
    def _decode_body(self, pages):
        io = self._io
        logits, _ = transformer.paged_decode_step(
            self.params, self.cfg, io.tokens, pages, io.table, io.pos,
            policy=self.policy, fused=self.ecfg.fused_attention)
        io.logits["decode"].copy_(logits[:, -1])
        io.greedy["decode"].copy_(greedy_sample(io.logits["decode"]))

    def _prefill_body(self, pages):
        io = self._io
        logits, cache = transformer.prefill(
            self.params, self.cfg, io.bucket, io.cache, policy=self.policy,
            logits_pos=io.logits_pos)
        for pl, cl in zip(pages, cache):
            for name in ("k", "v"):
                kvwire.scatter_prefill(pl[name], cl[name], io.page_ids)
        io.logits["prefill"].copy_(logits[:, -1])
        io.greedy["prefill"].copy_(greedy_sample(io.logits["prefill"]))

    def _run_eager(self, kind: str, pool: PagedKVPool):
        """Step ``kind`` ("decode" or "prefill") of ``pool`` as it is issued,
        operation by operation, on the buffers."""
        body = self._decode_body if kind == "decode" else self._prefill_body
        body(pool.pages)

    def _run(self, kind: str, pool: PagedKVPool):
        """Step ``kind`` of ``pool`` on the buffers: on the card, the
        replay of its graph, captured at the pool's first such step; on
        the CPU, the body run eagerly."""
        if self.device.type != "cuda":
            self._run_eager(kind, pool)
            return
        graphs = self._graphs.setdefault(pool, {})
        if kind in graphs:
            graphs[kind].replay()
        else:
            graphs[kind] = self._capture(kind, pool)

    def _capture(self, kind: str, pool: PagedKVPool) -> _Graph:
        """Run step ``kind`` once eagerly on a side stream (the warm-up
        PyTorch asks for before a capture: it also builds and loads the
        kernels; its results are this call's), then capture it.  A step
        that syncs with the host or copies from it raises here; the engine
        never goes on without the graph."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._mempool = torch.cuda.graph_pool_handle()
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self._run_eager(kind, pool)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        wrappers = kernels.wrappers().values()
        before = {fn: fn.launches for fn in wrappers}
        # the graph keeps its cudaGraph_t, so that its nodes can be read
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with torch.cuda.graph(graph, pool=self._mempool, stream=stream):
                self._run_eager(kind, pool)
        finally:
            # a capture launches nothing: take back the wrappers' ticks
            launched = {fn: fn.launches - n for fn, n in before.items()}
            for fn, n in launched.items():
                fn.launches -= n
        graph.instantiate()
        counts = self._captures.setdefault(pool, {})
        counts[kind] = counts.get(kind, 0) + 1
        return _Graph(graph, {fn: n for fn, n in launched.items() if n})

    def _decode(self, pool: PagedKVPool, tokens, page_table, pos):
        """One decode step of every slot -> (logits, greedy tokens), the
        engine's output buffers, which the next step overwrites."""
        s, p = self.pcfg.max_slots, self.pcfg.pages_per_slot
        tokens, pos = np.asarray(tokens), np.asarray(pos)
        table = np.asarray(page_table)
        if tokens.shape != (s,) or pos.shape != (s,) or table.shape != (s, p):
            raise ValueError(f"decode takes tokens/pos ({s},) and a page "
                             f"table ({s}, {p}); got {tokens.shape}, "
                             f"{pos.shape}, {table.shape}")
        self._io.decode_in.copy_(torch.from_numpy(np.concatenate(
            [tokens, pos, table.reshape(-1)]).astype(np.int64)))
        self._run("decode", pool)
        return self._io.logits["decode"], self._io.greedy["decode"]

    def _prefill(self, pool: PagedKVPool, tokens, page_ids):
        """Prefill one request on the right-padded max_context bucket and
        copy its cache into its pages -> (logits (1, V) at the prompt's last
        token, greedy token (1,)), the engine's output buffers."""
        bucket, p = self.pcfg.max_context, self.pcfg.pages_per_slot
        if not 0 < len(tokens) <= bucket:
            raise ValueError(f"prompt len {len(tokens)} not in [1, bucket "
                             f"{bucket}]")
        if len(page_ids) > p:
            raise ValueError(f"{len(page_ids)} pages > {p} a slot")
        host = np.zeros((bucket + p + 1,), np.int64)
        host[:len(tokens)] = tokens
        host[bucket:bucket + len(page_ids)] = page_ids
        host[-1] = len(tokens) - 1
        self._io.prefill_in.copy_(torch.from_numpy(host))
        self._run("prefill", pool)
        return self._io.logits["prefill"], self._io.greedy["prefill"]

    # ----------------------------------------------------------- logits
    @torch.no_grad()
    def prefill_logits(self, pool: PagedKVPool, tokens, page_ids):
        """Prefill one request into its pages.  Returns the logits (1, V)
        at the prompt's last token (the caller's own tensor)."""
        return self._prefill(pool, tokens, page_ids)[0].clone()

    @torch.no_grad()
    def decode_logits(self, pool: PagedKVPool, tokens, page_table, pos):
        """One decode step for every slot.  tokens/pos (max_slots,),
        page_table (max_slots, pages_per_slot).  Returns logits (B, V), the
        caller's own tensor."""
        return self._decode(pool, tokens, page_table, pos)[0].clone()

    # ------------------------------------------------------------- tokens
    @torch.no_grad()
    def prefill_request(self, pool: PagedKVPool, tokens, page_ids) -> int:
        """Prefill one request; returns its greedy first continuation."""
        return int(self._prefill(pool, tokens, page_ids)[1][0])

    @torch.no_grad()
    def decode_step_batch(self, pool: PagedKVPool, tokens, page_table,
                          pos) -> np.ndarray:
        """Advance every slot one greedy token (the caller's own array:
        on the CPU a plain ``numpy()`` would share the output buffer)."""
        return self._decode(pool, tokens, page_table,
                            pos)[1].to("cpu", copy=True).numpy()

    # ------------------------------------------------------ scheduler API
    @property
    def lookahead_tokens(self) -> int:
        """Cache rows one scheduler step may write per slot."""
        return 1

    def advance_slots(self, pool: PagedKVPool, tokens, page_table, pos,
                      budget=None):
        """Scheduler step contract: ``(emitted, rejected)`` per slot.  The
        plain engine emits one token per slot and never rejects."""
        toks = self.decode_step_batch(pool, tokens, page_table, pos)
        return [[int(t)] for t in toks], [0] * len(toks)
