"""Synchronous-loop serving front end (port of ``repro/serve/server.py``).

    server = Server(cfg, params, ecfg, pcfg)            # on the card
    rid = server.submit(prompt, RequestParams(max_new_tokens=32))
    server.drain()                                      # or server.step()

``device="cpu"`` runs the same path on the CPU, through the kernels'
plain versions.
"""
from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig
from .engine import EngineConfig, PagedConfig, PagedEngine
from .scheduler import Completion, Scheduler


@dataclasses.dataclass(frozen=True)
class RequestParams:
    """Per-request scheduling parameters (sampling is greedy)."""
    max_new_tokens: int = 16
    priority: int = 0


class Server:
    """Owns the paged engine, the page pool and the scheduler."""

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig,
                 pcfg: PagedConfig, *, engine=None, on_token=None,
                 on_complete=None, device=None):
        """``engine`` swaps in a prebuilt engine with the paged-engine step
        contract; by default a :class:`PagedEngine` is built on
        ``device``."""
        self.engine = engine or PagedEngine(cfg, params, ecfg, pcfg,
                                            device=device)
        self.pool = self.engine.new_pool()
        self.scheduler = Scheduler(self.engine, self.pool,
                                   on_token=on_token,
                                   on_complete=on_complete)

    def submit(self, prompt, params: RequestParams = RequestParams(), *,
               on_token=None) -> int:
        """Enqueue a request; returns its request id immediately."""
        return self.scheduler.submit(
            prompt, max_new_tokens=params.max_new_tokens,
            priority=params.priority, on_token=on_token)

    def step(self) -> list[Completion]:
        """Advance every in-flight request by one token."""
        return self.scheduler.step()

    def drain(self, max_steps: int | None = None) -> dict[int, list[int]]:
        """Run to quiescence; returns {rid: generated tokens}."""
        return self.scheduler.drain(max_steps=max_steps)

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    def output(self, rid: int) -> list[int]:
        return list(self.scheduler.request(rid).generated)

    def stats(self) -> dict:
        s = self.scheduler.stats()
        s["pool_bytes"] = self.pool.nbytes()
        s["decode_compilations"] = self.engine.compilations(self.pool)
        s["attention_mode"] = self.engine.attention_mode
        return s
