"""Traffic kinds: one module a kind, named as a workload's "traffic" names
it, each with a `Driver(params, mix)` that says when each request of the
mix is due (`begin`, `poll`, `finished`, `in_lead_in`, `report`)."""
