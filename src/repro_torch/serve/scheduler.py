"""Continuous-batching request scheduler over the paged engine (port of
``repro/serve/scheduler.py``; the observability hooks of the JAX package
are a later slice).

submit -> QUEUED -> admit (prefill into fresh pages, take a decode slot)
-> RUNNING -> decode steps shared with every other in-flight request ->
COMPLETE.  Admission is FCFS within a priority lane, higher lanes first.
When the pool runs out mid-decode the lowest-priority, latest-arrived
request is preempted: its pages are freed, it re-queues at the front of
its lane, and on re-admission its prompt + generated prefix is prefilled
again (recompute preemption).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable

import numpy as np

from .engine import PagedEngine
from .pool import PagedKVPool

QUEUED, RUNNING, COMPLETE = "queued", "running", "complete"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    priority: int = 0
    on_token: Callable[[int, int], None] | None = None   # (rid, token)
    generated: list[int] = dataclasses.field(default_factory=list)
    state: str = QUEUED
    n_preemptions: int = 0
    rejected_tokens: int = 0
    arrival: int = 0          # submit order; FCFS tiebreak + victim choice


@dataclasses.dataclass(frozen=True)
class Completion:
    rid: int
    tokens: tuple[int, ...]
    n_preemptions: int
    rejected_tokens: int = 0


class Scheduler:
    """Admits a stream of requests and interleaves their decode steps."""

    def __init__(self, engine: PagedEngine, pool: PagedKVPool, *,
                 on_token=None, on_complete=None):
        self.engine, self.pool = engine, pool
        self.pcfg = engine.pcfg
        self.on_token, self.on_complete = on_token, on_complete
        self._lanes: dict[int, deque[Request]] = {}
        self._requests: dict[int, Request] = {}
        self._slots: list[Request | None] = [None] * self.pcfg.max_slots
        self._pos = np.zeros((self.pcfg.max_slots,), np.int32)
        self._last_tok = np.zeros((self.pcfg.max_slots,), np.int32)
        self._next_rid = 0
        self._decode_steps = 0
        self._prefills = 0

    # ------------------------------------------------------------- submit
    def submit(self, prompt, *, max_new_tokens: int = 16, priority: int = 0,
               on_token=None) -> int:
        """Validate and enqueue.  A request that could never be admitted
        (empty prompt, no token budget, longer than the bucket, more pages
        than the pool holds) raises ValueError here."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        total = len(prompt) + max_new_tokens
        if total > self.pcfg.max_context:
            raise ValueError(f"prompt+max_new_tokens={total} exceeds "
                             f"max_context={self.pcfg.max_context}")
        need = -(-total // self.pcfg.page_size)
        if need > self.pool.n_allocatable:
            raise ValueError(
                f"request needs {need} pages at full length but the pool "
                f"holds only {self.pool.n_allocatable} allocatable pages "
                f"(n_pages={self.pool.n_pages} minus scratch); it could "
                f"never be admitted")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, prompt, max_new_tokens, priority=priority,
                      on_token=on_token, arrival=rid)
        self._requests[rid] = req
        self._lanes.setdefault(priority, deque()).append(req)
        return rid

    # -------------------------------------------------------------- state
    @property
    def has_work(self) -> bool:
        return any(self._lanes.values()) or any(
            r is not None for r in self._slots)

    def active_requests(self) -> list[Request]:
        return [r for r in self._slots if r is not None]

    def queued_requests(self) -> list[Request]:
        return [r for lane in self._lanes.values() for r in lane]

    def stats(self) -> dict:
        return {"active": len(self.active_requests()),
                "queued": len(self.queued_requests()),
                "pool_occupancy": self.pool.occupancy(),
                "steps": self._decode_steps,
                "prefills": self._prefills,
                "preemptions": sum(r.n_preemptions
                                   for r in self._requests.values()),
                "rejected_tokens": sum(r.rejected_tokens
                                       for r in self._requests.values())}

    def request(self, rid: int) -> Request:
        return self._requests[rid]

    def outputs(self) -> dict[int, list[int]]:
        """Generated tokens of every submitted request so far."""
        return {rid: list(r.generated) for rid, r in self._requests.items()}

    # ------------------------------------------------------------ helpers
    def _emit(self, req: Request, tok: int):
        req.generated.append(tok)
        if req.on_token:
            req.on_token(req.rid, tok)
        if self.on_token:
            self.on_token(req.rid, tok)

    def _finish(self, req: Request, slot: int | None,
                events: list[Completion]):
        if slot is not None:
            self._slots[slot] = None
        self.pool.free(req.rid)
        req.state = COMPLETE
        done = Completion(req.rid, tuple(req.generated), req.n_preemptions,
                          rejected_tokens=req.rejected_tokens)
        events.append(done)
        if self.on_complete:
            self.on_complete(done)

    def _next_queued(self) -> Request | None:
        for prio in sorted(self._lanes, reverse=True):
            if self._lanes[prio]:
                return self._lanes[prio].popleft()
        return None

    def _requeue_front(self, req: Request):
        self._lanes.setdefault(req.priority, deque()).appendleft(req)

    # -------------------------------------------------------------- admit
    def _admit(self, events: list[Completion]):
        while None in self._slots:
            req = self._next_queued()
            if req is None:
                return
            resume = bool(req.generated)
            # a resume prefills prompt + generated[:-1] and feeds the last
            # generated token through the decode step, as an uninterrupted
            # run would
            tokens = req.prompt + req.generated[:-1]
            need = -(-len(tokens) // self.pcfg.page_size)
            if not self.pool.alloc(req.rid, need):
                self._requeue_front(req)
                return
            first = self.engine.prefill_request(
                self.pool, tokens, self.pool.pages_of(req.rid))
            self._prefills += 1
            slot = self._slots.index(None)
            req.state = RUNNING
            if resume:
                tok = req.generated[-1]
            else:
                tok = first
                self._emit(req, tok)
                if len(req.generated) >= req.max_new_tokens:
                    self._finish(req, None, events)
                    continue
            self._slots[slot] = req
            self._pos[slot] = len(tokens)
            self._last_tok[slot] = tok

    # ------------------------------------------------------------ preempt
    def _preempt_victim(self) -> bool:
        """Evict the lowest-priority, latest-arrived running request."""
        victims = [(r.priority, -r.arrival, i)
                   for i, r in enumerate(self._slots) if r is not None]
        if not victims:
            return False
        _, _, slot = min(victims)
        req = self._slots[slot]
        self._slots[slot] = None
        self.pool.free(req.rid)
        req.state = QUEUED
        req.n_preemptions += 1
        self._requeue_front(req)
        return True

    def _ensure_pages(self):
        """Every active slot needs the pages covering each position the
        engine may write this step; preempt on exhaustion."""
        look = self.engine.lookahead_tokens
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            total = len(req.prompt) + req.max_new_tokens
            last = min(int(self._pos[slot]) + look - 1, total - 1,
                       self.pcfg.max_context - 1)
            need_idx = last // self.pcfg.page_size
            while need_idx >= len(self.pool.pages_of(req.rid)):
                if self.pool.alloc(req.rid, 1):
                    continue
                if len(self.active_requests()) <= 1:
                    raise RuntimeError(
                        "page pool exhausted with a single request in "
                        "flight; increase n_pages")
                self._preempt_victim()
                if self._slots[slot] is None:   # the victim was this slot
                    break

    # ---------------------------------------------------------------- step
    def step(self) -> list[Completion]:
        """Admit what fits, then advance every in-flight request one token
        (emission is capped at each request's token budget)."""
        events: list[Completion] = []
        self._admit(events)
        self._ensure_pages()
        active = [i for i, r in enumerate(self._slots) if r is not None]
        if not active:
            return events
        table = np.zeros((self.pcfg.max_slots, self.pcfg.pages_per_slot),
                         np.int32)
        budget = [0] * self.pcfg.max_slots
        for i in active:
            table[i] = self.pool.table_array(self._slots[i].rid,
                                             self.pcfg.pages_per_slot)
            budget[i] = (self._slots[i].max_new_tokens
                         - len(self._slots[i].generated))
        pos = np.where([r is not None for r in self._slots], self._pos, 0)
        emitted, rejected = self.engine.advance_slots(
            self.pool, self._last_tok, table, pos.astype(np.int32),
            budget=budget)
        self._decode_steps += 1
        for i in active:
            req = self._slots[i]
            req.rejected_tokens += int(rejected[i])
            for tok in emitted[i]:
                if len(req.generated) >= req.max_new_tokens:
                    break
                self._pos[i] += 1
                self._last_tok[i] = int(tok)
                self._emit(req, int(tok))
            if len(req.generated) >= req.max_new_tokens:
                self._finish(req, i, events)
        return events

    def drain(self, max_steps: int | None = None) -> dict[int, list[int]]:
        """Run until every submitted request completes."""
        steps = 0
        while self.has_work:
            self.step()
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError("drain exceeded max_steps")
        return self.outputs()
