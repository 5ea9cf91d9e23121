"""Device milliseconds per forward of the `models.stem` span (int8: the
space-to-depth buffer, the `conv_s8` launch and the max pool; bf16: the
convolution and the pool): CUDA events on the current stream around what
it launches, in the traced window. Moves `images_per_s`."""

from geobench.metrics._spans import per_call_ms

LAYER = "models"
SOURCE = "program_span"


def read(obs):
    return per_call_ms(obs, "models.stem")
