"""The benchmark of `geoestimation_tpu_torch`, the PyTorch and CUDA port.

    python3 -m geobench.run --workload <cell> --seed <n> --seconds <s> --trace 0|1

`BENCHMARK.json` at the root of the checkout names the cells, the
configurations and the metrics; each is found here by its name:

  configs/<config>.json     a configuration: arch, widths, class counts
  cells/<cell>.json         a cell: configuration, loop kind (driver),
                            precision, serving path or training recipe,
                            traffic mix, limits
  traffic/<traffic>.json    a traffic mix's parameters
  drivers/<kind>.py         a loop kind: set-up, the measured window, the
                            answers to check
  metrics/<metric>.py       a per-layer metric's reader
  reference/                the plain float32 reference and its controls
  frozen/                   the frozen yardstick: seeded partitionings,
                            photos, kernel costs, the card's peaks

Adding a cell, a configuration, a traffic mix or a per-layer metric is
adding files of these kinds and entries to `BENCHMARK.json`.
"""
