"""Device milliseconds per step of the `train.optimizer` span (the train
step's `Optimizer.step`, SGD per leaf): CUDA events on the current stream
around what it launches, in the traced window. Moves
`train_images_per_s`."""

from geobench.metrics._spans import per_call_ms

LAYER = "train step"
SOURCE = "program_span"


def read(obs):
    return per_call_ms(obs, "train.optimizer")
