"""Request traces for the fleet simulator: format, I/O, and a synthetic
generator — carried unchanged from the JAX package's ``sim/trace.py``.

A trace is a time-ordered sequence of :class:`Request` records — the
*workload* half of a simulation, fully decoupled from the *fleet* half
(:mod:`sparkflow_tpu_torch.sim.core`). Each record carries only what the router
would see at the front door: arrival time, prompt/output token counts,
tenant, and session id. Nothing about replicas or placement lives here, so
one trace replays unchanged against any what-if fleet.

The synthetic generator models the three properties of real serving
traffic that uniform Poisson misses (and that routing policies are most
sensitive to):

- **bursty arrivals** — a two-state modulated Poisson process (MMPP-2):
  the arrival rate flips between a calm base rate and ``burst_factor`` x
  that rate, with exponentially distributed dwell times. Bursts are what
  fill queues and trip breakers; a flat-rate trace never exercises either.
- **heavy-tail lengths** — prompt and output lengths draw from a bounded
  Pareto (power-law) distribution. A handful of giant requests dominate
  KV-page footprint, which is exactly the regime where byte-headroom
  routing and plain least-loaded routing diverge.
- **multi-turn sessions** — a fraction of requests continue an earlier
  session (geometric number of turns, exponential think time), carrying a
  growing prompt (the accumulated conversation). Session affinity and KV
  reuse studies need these.

Everything is driven by one ``random.Random(seed)`` — same seed, same
trace, byte for byte. Traces serialize to JSON-lines (one request per
line) via :func:`save` / :func:`load` so a trace captured from production
logs can replay through the same door.
"""

from __future__ import annotations

import json
import math
import random
from dataclasses import asdict, dataclass
from typing import Iterable, List, Optional

__all__ = ["Request", "synthetic_trace", "save", "load",
           "bounded_pareto"]


@dataclass(frozen=True)
class Request:
    """One request as the router's front door sees it.

    ``arrival_s`` is seconds from trace start (monotone non-decreasing
    across a trace). ``prompt_tokens`` / ``output_tokens`` are the true
    lengths — the simulator treats output length as an oracle (the cost
    of a request once admitted), matching how trace-driven simulators
    replay logged completions. ``turn`` counts from 0 within a session.
    """

    arrival_s: float
    prompt_tokens: int
    output_tokens: int
    tenant: str = "default"
    session: str = ""
    turn: int = 0

    def to_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True,
                          separators=(",", ":"))

    @staticmethod
    def from_json(line: str) -> "Request":
        return Request(**json.loads(line))


def bounded_pareto(rng: random.Random, alpha: float, lo: int,
                   hi: int) -> int:
    """One draw from a bounded Pareto(alpha) on ``[lo, hi]`` (inverse-CDF).

    ``alpha`` near 1 is very heavy-tailed; 2-3 is moderate. Integer
    result, inclusive bounds.
    """
    if lo >= hi:
        return lo
    u = rng.random()
    la, ha = float(lo) ** alpha, float(hi) ** alpha
    # inverse CDF of the truncated Pareto
    x = (-(u * ha - u * la - ha) / (ha * la)) ** (-1.0 / alpha)
    return max(lo, min(hi, int(x)))


def synthetic_trace(num_requests: int, *, seed: int = 0,
                    rate_rps: float = 100.0,
                    burst_factor: float = 4.0,
                    burst_fraction: float = 0.1,
                    burst_dwell_s: float = 5.0,
                    prompt_alpha: float = 1.5,
                    prompt_range: (int, int) = (16, 4096),
                    output_alpha: float = 1.8,
                    output_range: (int, int) = (8, 1024),
                    session_fraction: float = 0.3,
                    mean_turns: float = 3.0,
                    think_time_s: float = 10.0,
                    tenants: int = 4) -> List[Request]:
    """Generate ``num_requests`` requests; deterministic in ``seed``.

    Arrivals follow an MMPP-2: calm rate ``rate_rps`` (scaled so the
    *time-average* rate stays ``rate_rps`` despite bursts), burst rate
    ``burst_factor`` x calm, spending ``burst_fraction`` of time bursting
    with mean dwell ``burst_dwell_s`` per visit. Lengths are bounded
    Pareto. ``session_fraction`` of non-continuation requests open a
    session whose later turns (geometric, mean ``mean_turns``) are
    injected after exponential think times with the conversation so far
    as a growing prompt. The returned list is sorted by arrival time with
    ties broken deterministically.
    """
    if num_requests <= 0:
        raise ValueError(f"num_requests must be >= 1, got {num_requests}")
    if rate_rps <= 0.0:
        raise ValueError(f"rate_rps must be positive, got {rate_rps}")
    rng = random.Random(seed)
    # scale the calm rate so E[rate] over both states == rate_rps
    avg_mult = (1.0 - burst_fraction) + burst_fraction * burst_factor
    calm_rate = rate_rps / avg_mult
    burst_rate = calm_rate * burst_factor
    # MMPP state machine
    bursting = False
    state_ends = rng.expovariate(
        1.0 / (burst_dwell_s * (1.0 - burst_fraction) / burst_fraction))
    now = 0.0
    out: List[Request] = []
    # session continuations scheduled for future injection:
    # (arrival_s, prompt, output, tenant, session, turn)
    pending: List[tuple] = []
    session_seq = 0
    while len(out) + len(pending) < num_requests:
        rate = burst_rate if bursting else calm_rate
        gap = rng.expovariate(rate)
        if now + gap >= state_ends:
            # flip the MMPP state at its dwell boundary, re-draw the gap
            now = state_ends
            bursting = not bursting
            dwell = (burst_dwell_s if bursting else
                     burst_dwell_s * (1.0 - burst_fraction) /
                     burst_fraction)
            state_ends = now + rng.expovariate(1.0 / dwell)
            continue
        now += gap
        prompt = bounded_pareto(rng, prompt_alpha, *prompt_range)
        output = bounded_pareto(rng, output_alpha, *output_range)
        tenant = f"tenant-{rng.randrange(tenants)}"
        if rng.random() < session_fraction:
            session_seq += 1
            sid = f"s{seed}-{session_seq}"
            out.append(Request(now, prompt, output, tenant, sid, 0))
            # geometric number of follow-up turns, mean mean_turns - 1
            turns = 0
            p_stop = 1.0 / max(1.0, mean_turns)
            t, ptoks = now, prompt
            while (rng.random() > p_stop
                   and len(out) + len(pending) < num_requests):
                turns += 1
                t += rng.expovariate(1.0 / think_time_s)
                nxt = bounded_pareto(rng, prompt_alpha, prompt_range[0],
                                     max(prompt_range[0],
                                         prompt_range[1] // 4))
                ptoks = min(prompt_range[1], ptoks + output + nxt)
                output = bounded_pareto(rng, output_alpha, *output_range)
                pending.append((t, ptoks, output, tenant, sid, turns))
        else:
            out.append(Request(now, prompt, output, tenant, "", 0))
    out.extend(Request(*p) for p in pending)
    # stable deterministic order: arrival, then the other fields
    out.sort(key=lambda r: (r.arrival_s, r.session, r.turn,
                            r.prompt_tokens, r.output_tokens))
    return out[:num_requests]


def save(path: str, trace: Iterable[Request]) -> int:
    """Write a trace as JSON-lines; returns the number of records."""
    n = 0
    with open(path, "w", encoding="utf-8") as fh:
        for req in trace:
            fh.write(req.to_json() + "\n")
            n += 1
    return n


def load(path: str, limit: Optional[int] = None) -> List[Request]:
    """Read a JSON-lines trace (optionally just the first ``limit``)."""
    out: List[Request] = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            out.append(Request.from_json(line))
            if limit is not None and len(out) >= limit:
                break
    return out
