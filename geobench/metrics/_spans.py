"""What the `program_span` readers share: the port's own spans
(`geoestimation_tpu_torch.utils.spans`), which it records only while a torch
profiler runs, so in this process only over the traced window."""

_MODULE = "geoestimation_tpu_torch.utils.spans"


def _spans(obs):
    """The port's span module after a traced window, or None: off the card
    (no trace), or in a checkout of the port from before its spans (the
    benchmark's files are also run over older checkouts, which record
    none). Any other failure to import the port raises."""
    if obs.get("trace") is None:
        return None
    try:
        import geoestimation_tpu_torch.utils.spans as spans
    except ModuleNotFoundError as e:
        if e.name != _MODULE:
            raise
        return None
    return spans


def summary(obs):
    """`spans.summary()` after a traced window, or None."""
    spans = _spans(obs)
    return spans and spans.summary()


def per_call_ms(obs, name, key="device_s"):
    """Milliseconds of `key` ("device_s" or "host_s") per call of the span
    `name`, or None where it was not recorded."""
    s = summary(obs)
    rec = s and s["spans"].get(name)
    if not rec or rec[key] is None:
        return None
    return 1e3 * rec[key] / rec["calls"]


def host_less_waits_ms(obs, root):
    """Host milliseconds per call of the span `root` less the host time of
    every `.wait` span inside it (outermost ones: the host waiting for the
    card), or None where `root` was not recorded."""
    spans = _spans(obs)
    recs = spans and spans.records()
    if not recs:
        return None
    calls, total_ns = 0, 0
    for i, (name, t0, t1, parent, _) in enumerate(recs):
        if name == root:
            calls += 1
            total_ns += t1 - t0
        elif name.endswith(".wait"):
            # the nearest enclosing `root`, unless another wait is between
            while parent >= 0 and recs[parent][0] != root:
                if recs[parent][0].endswith(".wait"):
                    parent = -1
                    break
                parent = recs[parent][3]
            if parent >= 0:
                total_ns -= t1 - t0
    if not calls:
        return None
    return total_ns * 1e-6 / calls
