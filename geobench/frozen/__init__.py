"""The benchmark's frozen copies of the yardstick: the seeded partitionings
and the numpy S2 geometry under them, the textured JPEG generator, the
kernels' cost functions, the card's published peaks and the operation count.

Later changes to the port may change the port's own copies; these stay as
they are, so that a number the benchmark reports means the same from one
change to the next. `geobench/tests/test_frozen.py` shows that each gives
today what the port's tool gives.
"""
