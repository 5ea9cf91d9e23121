"""The training step's share of the cards' peak over the traced window: the
useful operations of one image's step (`frozen.flops`: the convolutions and
the head, forward and backward, from the published shapes) times the images
of the traced steps, over the traced window's length and the cards' dense
bf16 peak (`frozen.costs.PEAKS`). Moves `train_images_per_s`."""

from geobench.frozen.costs import PEAKS
from geobench.frozen.flops import train_ops_per_image

LAYER = "train step"
SOURCE = "device_trace"


def read(obs):
    trace = obs["trace"]
    if trace is None or trace.busy_s <= 0:
        return None
    cell = obs["cell"]
    images = trace.calls * cell["recipe"]["batch_size"]
    return (100.0 * train_ops_per_image(cell["config"],
                                        cell["recipe"]["image_size"])
            * images / trace.window_s
            / (PEAKS[cell["precision"]] * obs["chips"]))
