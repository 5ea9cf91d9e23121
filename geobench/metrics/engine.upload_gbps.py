"""The rate of the engine's upload of each uint8 batch to the card: the
bytes `predict_batch` counted (`engine.upload_bytes`) over the device time
of its `engine.upload` spans (CUDA events around the copy), in the traced
window. Moves `images_per_s`."""

from geobench.metrics._spans import summary

LAYER = "engine, device ingest"
SOURCE = "program_span"


def read(obs):
    s = summary(obs)
    upload = s and s["spans"].get("engine.upload")
    sent = s and s["counters"].get("engine.upload_bytes")
    if not upload or not upload["device_s"] or not sent:
        return None
    return sent / upload["device_s"] / 1e9
