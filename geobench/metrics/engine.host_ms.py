"""The host's own work per `predict_batch` call: host milliseconds of its
`engine.predict_batch` span less every `.wait` span inside it (the port
marks where the host waits for the card so: the answers' copy back,
`engine.wait`), per call, in the traced window. Moves `images_per_s`."""

from geobench.metrics._spans import host_less_waits_ms

LAYER = "engine, device ingest"
SOURCE = "program_span"


def read(obs):
    return host_less_waits_ms(obs, "engine.predict_batch")
