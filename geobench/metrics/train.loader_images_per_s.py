"""The loader's rate: the images that `ShardBatcher` read, decoded and
labelled while the cell's held batches were drawn in set-up, over the host
seconds that took (no train step runs meanwhile). Moves `setup_s`."""

LAYER = "train loader"
SOURCE = "host_clock"


def read(obs):
    if not obs.get("loader_s") or not obs.get("loader_images"):
        return None
    return obs["loader_images"] / obs["loader_s"]
