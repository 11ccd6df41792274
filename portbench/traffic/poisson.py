"""Open loop: Poisson arrivals at `rate_per_s` requests a second from
independent users, whatever the system does; request k of the mix is the
k-th arrival (client 0).

Arrival times come from the seed alone.  The first `lead_in_s` seconds of
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
        self.arrivals = np.cumsum(rng.exponential(1.0 / self.rate, n))
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
