"""Closed loop: `clients` clients, each sending its next request as soon
as its previous one has finished (callers that each wait for a reply).

A lead-in fills the slots at staggered stages before the window: each
client's first request has a budget spread evenly over [4,
lead_in_max_tokens] across the clients, so the slots free up one after
another.  The lead-in is over once every lead-in request has finished;
its requests count in nothing.  A request is due when it is sent."""

from __future__ import annotations


class Driver:
    def __init__(self, params: dict, mix):
        self.n = params["clients"]
        self.lead_max = params["lead_in_max_tokens"]
        self.mix = mix
        self.next_index = [0] * self.n
        self.ready: list[int] = []
        self.lead_open = 0

    def _next(self, client: int, lead_tokens: int = 0):
        req = self.mix.request(client, self.next_index[client], lead_tokens)
        self.next_index[client] += 1
        return req

    def begin(self, now: float) -> list:
        """The lead-in requests, all due now."""
        out = []
        for c in range(self.n):
            budget = 4 + (self.lead_max - 4) * c // max(1, self.n - 1)
            out.append((self._next(c, budget), now))
        self.lead_open = self.n
        return out

    def poll(self, now: float) -> list:
        out = [(self._next(c), now) for c in self.ready]
        self.ready = []
        return out

    def finished(self, req, now: float) -> None:
        if req.lead_in:
            self.lead_open -= 1
        self.ready.append(req.client)

    def in_lead_in(self, now: float) -> bool:
        return self.lead_open > 0

    def report(self) -> dict:
        return {"clients": self.n}
