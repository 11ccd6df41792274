"""Per-layer metrics: one module a metric, named as BENCHMARK.json names
it, each with UNIT, BETTER, LAYER, MOVES, SOURCE and `read(ctx)`, which
returns the metric's value from a traced run's context (see
portbench/harness.py, `LayerContext`) or None when it finds nothing to
read.  A reader never returns 0 for a share of a roofline or a peak."""
