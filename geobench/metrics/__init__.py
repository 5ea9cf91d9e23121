"""Per-layer metric readers, one file each, named as the metric: each has
`LAYER` (the layer's name in PERF.md), `SOURCE` (where the number comes
from) and `read(obs) -> float | None`. `obs` holds the cell ("cell"), the
device trace of the traced window ("trace", a `geobench.trace.Trace`, None
off the card) and the driver's counters. A reader that finds nothing to
read returns None, and the metric is left out of the result line."""
