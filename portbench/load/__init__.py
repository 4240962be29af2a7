"""Traffic generation: the offline queue and the open-loop HTTP schedule.

Every seed gets the same multiset of sizes and of inter-arrival gaps, in
its own order: lengths are quantiles of the mix's distribution at fixed
probabilities, and the seed only permutes them.  So two seeds load the
system with the same work and differ in its order, and runs of different
seeds spread about as much as two runs of one seed.
"""
from __future__ import annotations

import asyncio
import json
import math
import statistics
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for one named stream of one seed (any whole
    number, negative or above 64 bits included)."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def lognormal_lengths(n: int, median: float, sigma: float, lo: int,
                      hi: int) -> np.ndarray:
    """``n`` lengths at the lognormal's quantiles (i + 0.5) / n, clipped
    to [lo, hi]."""
    p = (np.arange(n) + 0.5) / n
    z = np.array([statistics.NormalDist().inv_cdf(float(x)) for x in p])
    return np.clip(np.round(median * np.exp(sigma * z)), lo, hi).astype(int)


class OfflineQueue:
    """An endless offline queue of greedy requests.

    Prompt lengths cycle through the mix's pool of ``pool`` lengths (its
    quantiles).  The sorted pool is cut into ``strata`` bands; each round
    of ``strata`` consecutive requests takes one length from every band,
    so every batch of that many spans the whole distribution and a cycle
    of the pool holds the same lengths for every seed: the seed orders the
    members of each band and the requests of each round.  Request ``k``'s
    tokens are drawn from its own stream, so any request can be made again
    from ``(seed, k)`` alone."""

    def __init__(self, traffic: Dict, seed: int, vocab: int):
        p = traffic["prompt"]
        self.pool = lognormal_lengths(traffic["pool"], p["median"],
                                      p["sigma"], p["min"], p["max"])
        self.strata = traffic["strata"]
        if len(self.pool) % self.strata:
            raise ValueError("the pool must hold whole rounds of strata")
        self.seed, self.vocab = seed, vocab
        self.new_tokens = traffic["new_tokens"]
        self._order = rng_for(seed, 0)
        self._lengths: List[int] = []
        self.made = 0

    def _cycle(self) -> List[int]:
        bands = np.sort(self.pool).reshape(self.strata, -1)
        bands = np.stack([self._order.permutation(b) for b in bands])
        return [int(x) for r in range(bands.shape[1])
                for x in self._order.permutation(bands[:, r])]

    def prompt(self, k: int, length: int, stream: int = 1) -> np.ndarray:
        return rng_for(self.seed, stream, k).integers(
            0, self.vocab, size=length, dtype=np.int64).astype(np.int32)

    def next(self) -> np.ndarray:
        if not self._lengths:
            self._lengths = self._cycle()[::-1]
        k = self.made
        self.made += 1
        return self.prompt(k, self._lengths.pop())


def exponential_gaps(rate: float, seconds: float) -> np.ndarray:
    """The ``round(rate * seconds)`` inter-arrival gaps of every seed: the
    exponential's quantiles (i + 0.5) / n, shrunk where their sum would
    reach ``seconds``."""
    n = max(int(round(rate * seconds)), 1)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    return gaps * min(1.0, seconds * (n - 0.5) / n / gaps.sum())


def arrival_offsets(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Open-loop Poisson arrivals at ``rate`` a second over ``seconds``:
    :func:`exponential_gaps` in an order drawn from the seed; offsets from
    0, all below ``seconds``."""
    gaps = rng_for(seed, 2).permutation(exponential_gaps(rate, seconds))
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


@dataclass
class Sent:
    """One request of the open loop, timed at the client."""
    due: float                      # perf_counter when it was due
    sent: float = math.nan          # when its bytes were written
    end: float = math.nan           # when the whole response was read
    status: int = 0                 # HTTP status (0: no response)
    body: Optional[dict] = None

    @property
    def latency_ms(self) -> float:
        return (self.end - self.due) * 1e3


async def _post(host: str, port: int, path: str, timeout: float
                ) -> tuple:
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port), timeout)
    try:
        writer.write((f"POST {path} HTTP/1.1\r\nHost: {host}\r\n"
                      f"Content-Length: 0\r\nConnection: close\r\n\r\n"
                      ).encode())
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), timeout)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), body


@dataclass
class OpenLoop:
    """Open-loop HTTP client on its own thread and event loop, so a
    blocked server loop cannot hold back a send.  Each request is timed
    from the moment it was due; how late the client itself sent each one
    is kept in ``Sent.sent``."""
    host: str
    port: int
    path: str
    offsets: Sequence[float]
    drain_s: float = 60.0
    sent: List[Sent] = field(default_factory=list)
    t0: float = math.nan
    _thread: Optional[threading.Thread] = None

    def start(self, t0: float) -> None:
        self.t0 = t0
        self.sent = [Sent(due=t0 + float(o)) for o in self.offsets]
        self._thread = threading.Thread(target=asyncio.run,
                                        args=(self._main(),),
                                        name="portbench-client", daemon=True)
        self._thread.start()

    def done(self) -> bool:
        return self._thread is not None and not self._thread.is_alive()

    def join(self, timeout: float) -> None:
        self._thread.join(timeout)

    async def _one(self, s: Sent, deadline: float) -> None:
        delay = s.due - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        s.sent = time.perf_counter()
        try:
            status, body = await _post(self.host, self.port, self.path,
                                       max(deadline - s.sent, 1.0))
        except (OSError, asyncio.TimeoutError, ValueError, IndexError):
            return
        s.end = time.perf_counter()
        s.status = status
        try:
            s.body = json.loads(body) if body else {}
        except ValueError:
            s.body = None

    async def _main(self) -> None:
        last = max((s.due for s in self.sent), default=self.t0)
        deadline = last + self.drain_s
        await asyncio.gather(*(self._one(s, deadline) for s in self.sent))

    def lateness_ms(self) -> Dict[str, float]:
        late = sorted((s.sent - s.due) * 1e3 for s in self.sent
                      if not math.isnan(s.sent))
        if not late:
            return {"p50": math.nan, "max": math.nan}
        return {"p50": late[len(late) // 2], "max": late[-1]}
