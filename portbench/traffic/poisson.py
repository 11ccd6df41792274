"""Open loop: Poisson arrivals at `rate_per_s` requests a second from
independent users, whatever the system does; request k of the mix is the
k-th arrival (client 0).

Arrival times come from the seed alone.  With `strata` = B, the gaps
come in blocks of B that are one fixed set for every seed: the B
exponential quantiles at (i + 0.5) / B, scaled to a mean of 1 /
`rate_per_s`, in an order drawn from the seed.  Each block then spans
exactly B / `rate_per_s` seconds: every seed offers the same arrivals,
bunched in another order, and a window holds the same count give or
take a block's part.  The first `lead_in_s` seconds of
arrivals are the lead-in, which counts in nothing.  A request is due at
its arrival time, and is sent at the first poll at or after it: `report`
gives how late the generator ran (the send time less the due time) as a
median, a 95th percentile and a maximum, in seconds."""

from __future__ import annotations

import numpy as np


class Driver:
    def __init__(self, params: dict, mix):
        self.rate = params["rate_per_s"]
        self.lead_s = params["lead_in_s"]
        self.horizon = params.get("horizon_s", 600.0)
        self.mix = mix
        rng = np.random.default_rng([mix.seed, 0x9015])
        n = int(self.rate * self.horizon * 1.5) + 16
        b = params.get("strata")
        if b:
            q = -np.log1p(-(np.arange(b) + 0.5) / b)
            q = q / q.mean() / self.rate
            gaps = np.concatenate([q[rng.permutation(b)]
                                   for _ in range(n // b + 1)])
        else:
            gaps = rng.exponential(1.0 / self.rate, n)
        self.arrivals = np.cumsum(gaps)
        self.k = 0
        self.t0 = 0.0
        self.late: list[float] = []

    def begin(self, now: float) -> list:
        self.t0 = now
        return self.poll(now)

    def poll(self, now: float) -> list:
        out = []
        while (self.k < len(self.arrivals)
               and self.t0 + self.arrivals[self.k] <= now):
            due = self.t0 + float(self.arrivals[self.k])
            req = self.mix.request(0, self.k)
            if due < self.t0 + self.lead_s:
                req = self.mix.request(0, self.k, req.max_tokens)
            out.append((req, due))
            self.late.append(now - due)
            self.k += 1
        return out

    def finished(self, req, now: float) -> None:
        pass

    def in_lead_in(self, now: float) -> bool:
        return now < self.t0 + self.lead_s

    def report(self) -> dict:
        if not self.late:
            return {"sent": 0}
        a = np.asarray(self.late)
        return {"sent": len(a), "late_p50_s": float(np.percentile(a, 50)),
                "late_p95_s": float(np.percentile(a, 95)),
                "late_max_s": float(a.max())}
