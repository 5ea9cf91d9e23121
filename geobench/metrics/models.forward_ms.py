"""Device milliseconds per forward of the `models.forward` span (the
crops, trunk and heads, the TTA mean, f* and the packing of the answers):
CUDA events on the current stream around what it launches, in the traced
window. Moves `images_per_s`."""

from geobench.metrics._spans import per_call_ms

LAYER = "models"
SOURCE = "program_span"


def read(obs):
    return per_call_ms(obs, "models.forward")
