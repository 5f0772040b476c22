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
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as _device
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

    # ----------------------------------------------------------- logits
    @torch.no_grad()
    def prefill_logits(self, pool: PagedKVPool, tokens, page_ids):
        """Prefill one request on a right-padded max_context bucket and copy
        its cache into its pages.  Returns the logits (1, V) at the prompt's
        last token."""
        bucket = self.pcfg.max_context
        if len(tokens) > bucket:
            raise ValueError(f"prompt len {len(tokens)} > bucket {bucket}")
        padded = torch.zeros((1, bucket), dtype=torch.long)
        padded[0, :len(tokens)] = torch.as_tensor(tokens)
        ids = torch.zeros((self.pcfg.pages_per_slot,), dtype=torch.long)
        ids[:len(page_ids)] = torch.as_tensor(page_ids)
        cache = transformer.init_cache(self.cfg, 1, bucket,
                                       kv_quant=self._kvq,
                                       device=self.device)
        logits, cache = transformer.prefill(
            self.params, self.cfg, padded.to(self.device), cache,
            policy=self.policy, logits_pos=len(tokens) - 1)
        ids = ids.to(self.device)
        for pl, cl in zip(pool.pages, cache):
            for name in ("k", "v"):
                kvwire.scatter_prefill(pl[name], cl[name], ids)
        return logits[:, -1]

    @torch.no_grad()
    def decode_logits(self, pool: PagedKVPool, tokens, page_table, pos):
        """One decode step for every slot.  tokens/pos (max_slots,),
        page_table (max_slots, pages_per_slot).  Returns logits (B, V)."""
        dev = self.device
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long)
        logits, _ = transformer.paged_decode_step(
            self.params, self.cfg, toks.to(dev)[:, None], pool.pages,
            torch.as_tensor(np.asarray(page_table), dtype=torch.long).to(dev),
            torch.as_tensor(np.asarray(pos), dtype=torch.long).to(dev),
            policy=self.policy, fused=self.ecfg.fused_attention)
        return logits[:, -1]

    # ------------------------------------------------------------- tokens
    def prefill_request(self, pool: PagedKVPool, tokens, page_ids) -> int:
        """Prefill one request; returns its greedy first continuation."""
        return int(greedy_sample(self.prefill_logits(pool, tokens,
                                                      page_ids))[0])

    def decode_step_batch(self, pool: PagedKVPool, tokens, page_table,
                          pos) -> np.ndarray:
        """Advance every slot one greedy token."""
        return greedy_sample(self.decode_logits(
            pool, tokens, page_table, pos)).cpu().numpy()

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
