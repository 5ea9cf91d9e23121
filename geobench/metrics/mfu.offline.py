"""The offline forward's share of the card's peak over the traced window:
the useful operations of a photo (`frozen.flops`: ten crops through the
trunk and the heads, from the published shapes) times the photos the traced
calls answered, over the traced window's length and the dense peak of the
cell's precision (`frozen.costs.PEAKS`). The contract's whole-step share,
which bounds the kernels' rooflines. Moves `images_per_s`."""

from geobench.frozen.costs import PEAKS
from geobench.frozen.flops import ops_per_photo

LAYER = "models"
SOURCE = "device_trace"


def read(obs):
    trace = obs["trace"]
    if trace is None or trace.busy_s <= 0:
        return None
    cell = obs["cell"]
    photos = trace.calls * cell["traffic"]["batch"]
    return (100.0 * ops_per_photo(cell["config"]) * photos
            / trace.window_s / PEAKS[cell["precision"]])
