"""The host decode of a JPEG, as the port's loader and server state it:
decode to RGB, resize the shorter side to 256 (the longer side rounded to
the nearest pixel, never under 256) with bilinear filtering, and cut the
centered 256 square."""

from __future__ import annotations

import io

import numpy as np


def decode(blob, resize_to=256, base=256):
    from PIL import Image

    img = Image.open(io.BytesIO(blob)).convert("RGB")
    w, h = img.size
    scale = resize_to / min(w, h)
    nw = max(int(round(w * scale)), resize_to)
    nh = max(int(round(h * scale)), resize_to)
    img = img.resize((nw, nh), Image.BILINEAR)
    left, top = (nw - base) // 2, (nh - base) // 2
    return np.asarray(img.crop((left, top, left + base, top + base)),
                      dtype=np.uint8)
