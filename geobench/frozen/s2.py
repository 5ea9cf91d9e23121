"""Vectorized S2 cell geometry (numpy): the benchmark's frozen copy.

A copy of the numpy path of `geoestimation_tpu_torch/geo/s2.py`, without its
dispatch to the C++ library, so that the seeded partitionings of the
benchmark do not move when the port's S2 code does: the subset of the public S2 geometry
specification the system uses, as batch operations over numpy arrays --

  * lat/lng -> leaf cell id (level 30)          (`latlng_to_cell_id`)
  * cell id -> parent at level                  (`parent_at_level`)
  * cell id -> level                            (`cell_level`)
  * cell id -> children                         (`children`)
  * cell id -> center lat/lng                   (`cell_id_to_latlng`)
  * cell id <-> hex token                       (`token_to_id`, `id_to_token`)

Cube-face projection with the quadratic ST<->UV transform, and Hilbert-curve
position encoding via 4-bit lookup tables.

Cell id layout (64 bits): 3 face bits, 2*level Hilbert position bits, one
trailing '1' sentinel bit marking the level, zero padding below.
"""

from __future__ import annotations

import numpy as np

MAX_LEVEL = 30
NUM_FACES = 6
POS_BITS = 2 * MAX_LEVEL + 1  # 61
MAX_SIZE = 1 << MAX_LEVEL

_LOOKUP_BITS = 4
_SWAP_MASK = 0x01
_INVERT_MASK = 0x02

# Hilbert curve traversal order and orientation changes for the 4 sub-cells,
# for each of the 4 possible orientations of the parent cell.
_POS_TO_IJ = np.array(
    [
        [0, 1, 3, 2],  # canonical order
        [0, 2, 3, 1],  # axes swapped
        [3, 2, 0, 1],  # bits inverted
        [3, 1, 0, 2],  # swapped & inverted
    ],
    dtype=np.uint64,
)
_POS_TO_ORIENTATION = np.array(
    [_SWAP_MASK, 0, 0, _INVERT_MASK | _SWAP_MASK], dtype=np.uint64
)


def _init_lookup_tables():
    """Build the 4-bit-block Hilbert lookup tables (1024 entries each)."""
    n = 1 << (2 * _LOOKUP_BITS + 2)
    lookup_pos = np.zeros(n, dtype=np.uint64)
    lookup_ij = np.zeros(n, dtype=np.uint64)

    def init_cell(level, i, j, orig_orientation, orientation, pos):
        if level == _LOOKUP_BITS:
            ij = (i << _LOOKUP_BITS) + j
            lookup_pos[(ij << 2) + orig_orientation] = (pos << 2) + orientation
            lookup_ij[(pos << 2) + orig_orientation] = (ij << 2) + orientation
            return
        level += 1
        i <<= 1
        j <<= 1
        pos <<= 2
        r = _POS_TO_IJ[orientation]
        for index in range(4):
            init_cell(
                level,
                i + (int(r[index]) >> 1),
                j + (int(r[index]) & 1),
                orig_orientation,
                orientation ^ int(_POS_TO_ORIENTATION[index]),
                pos + index,
            )

    for orientation in range(4):
        init_cell(0, 0, 0, orientation, orientation, 0)
    return lookup_pos, lookup_ij


_LOOKUP_POS, _LOOKUP_IJ = _init_lookup_tables()

_U64 = np.uint64


def _u64(x):
    return np.asarray(x, dtype=np.uint64)


# ---------------------------------------------------------------------------
# lat/lng -> XYZ -> face/UV -> ST -> IJ -> cell id
# ---------------------------------------------------------------------------


def latlng_to_xyz(lat_deg, lng_deg):
    """Unit-sphere points for degree lat/lng arrays. Returns (N, 3) float64."""
    lat = np.deg2rad(np.asarray(lat_deg, dtype=np.float64))
    lng = np.deg2rad(np.asarray(lng_deg, dtype=np.float64))
    cos_lat = np.cos(lat)
    return np.stack(
        [cos_lat * np.cos(lng), cos_lat * np.sin(lng), np.sin(lat)], axis=-1
    )


def xyz_to_face_uv(xyz):
    """Project unit-sphere points onto the cube: returns (face, u, v)."""
    xyz = np.asarray(xyz, dtype=np.float64)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    abs_xyz = np.abs(xyz)
    face = np.argmax(abs_xyz, axis=-1)
    # Negative major axis -> faces 3, 4, 5.
    major = np.take_along_axis(xyz, face[..., None], axis=-1)[..., 0]
    face = np.where(major < 0, face + 3, face).astype(np.int64)

    u = np.empty_like(x)
    v = np.empty_like(x)
    for f, (ue, ve) in enumerate(
        [
            (lambda: y / x, lambda: z / x),      # face 0 (+x)
            (lambda: -x / y, lambda: z / y),     # face 1 (+y)
            (lambda: -x / z, lambda: -y / z),    # face 2 (+z)
            (lambda: z / x, lambda: y / x),      # face 3 (-x)
            (lambda: z / y, lambda: -x / y),     # face 4 (-y)
            (lambda: -y / z, lambda: -x / z),    # face 5 (-z)
        ]
    ):
        m = face == f
        if np.any(m):
            with np.errstate(divide="ignore", invalid="ignore"):
                u[m] = ue()[m]
                v[m] = ve()[m]
    return face, u, v


def uv_to_st(u):
    """Quadratic UV->ST transform (the S2_QUADRATIC_PROJECTION)."""
    u = np.asarray(u, dtype=np.float64)
    pos = 0.5 * np.sqrt(1.0 + 3.0 * np.maximum(u, 0.0))
    neg = 1.0 - 0.5 * np.sqrt(1.0 - 3.0 * np.minimum(u, 0.0))
    return np.where(u >= 0, pos, neg)


def st_to_uv(s):
    """Inverse of `uv_to_st`."""
    s = np.asarray(s, dtype=np.float64)
    return np.where(
        s >= 0.5,
        (1.0 / 3.0) * (4.0 * s * s - 1.0),
        (1.0 / 3.0) * (1.0 - 4.0 * (1.0 - s) * (1.0 - s)),
    )


def st_to_ij(s):
    return np.clip(
        np.floor(MAX_SIZE * np.asarray(s, dtype=np.float64)), 0, MAX_SIZE - 1
    ).astype(np.uint64)


def from_face_ij(face, i, j):
    """Leaf cell ids from face + leaf-grid (i, j). All inputs vectorized."""
    face = _u64(face)
    i = _u64(i)
    j = _u64(j)
    n = face << _U64(POS_BITS - 1)
    bits = face & _U64(_SWAP_MASK)
    mask = _U64((1 << _LOOKUP_BITS) - 1)
    for k in range(7, -1, -1):
        shift = _U64(k * _LOOKUP_BITS)
        bits += ((i >> shift) & mask) << _U64(_LOOKUP_BITS + 2)
        bits += ((j >> shift) & mask) << _U64(2)
        bits = _LOOKUP_POS[bits]
        n |= (bits >> _U64(2)) << _U64(k * 2 * _LOOKUP_BITS)
        bits &= _U64(_SWAP_MASK | _INVERT_MASK)
    return n * _U64(2) + _U64(1)


def latlng_to_cell_id(lat_deg, lng_deg):
    """Degree lat/lng arrays -> level-30 (leaf) S2 cell ids, vectorized."""
    face, u, v = xyz_to_face_uv(latlng_to_xyz(lat_deg, lng_deg))
    i = st_to_ij(uv_to_st(u))
    j = st_to_ij(uv_to_st(v))
    return from_face_ij(face, i, j)


# ---------------------------------------------------------------------------
# cell id -> face/IJ (inverse Hilbert walk)
# ---------------------------------------------------------------------------


def to_face_ij(cell_id):
    """Decode cell ids to (face, i, j) of the leaf cell at the id's center
    position. Works for any level (the position bits below the sentinel are
    zero, which decodes to the minimum leaf of the cell)."""
    cell_id = _u64(cell_id)
    face = (cell_id >> _U64(POS_BITS)).astype(np.int64)
    bits = _u64(face) & _U64(_SWAP_MASK)
    i = np.zeros_like(cell_id)
    j = np.zeros_like(cell_id)
    for k in range(7, -1, -1):
        nbits = (MAX_LEVEL - 7 * _LOOKUP_BITS) if k == 7 else _LOOKUP_BITS
        bits += ((cell_id >> _U64(k * 2 * _LOOKUP_BITS + 1))
                 & _U64((1 << (2 * nbits)) - 1)) << _U64(2)
        bits = _LOOKUP_IJ[bits]
        i += (bits >> _U64(_LOOKUP_BITS + 2)) << _U64(k * _LOOKUP_BITS)
        j += ((bits >> _U64(2)) & _U64((1 << _LOOKUP_BITS) - 1)) << _U64(
            k * _LOOKUP_BITS
        )
        bits &= _U64(_SWAP_MASK | _INVERT_MASK)
    return face, i, j


# ---------------------------------------------------------------------------
# level / parent / children / token algebra
# ---------------------------------------------------------------------------


def _lsb(cell_id):
    cell_id = _u64(cell_id)
    return cell_id & (~cell_id + _U64(1))


def lsb_for_level(level):
    return _U64(1) << _u64(2 * (MAX_LEVEL - np.asarray(level, dtype=np.int64)))


def cell_level(cell_id):
    """Level of each cell id (0..30), from the sentinel bit position."""
    lsb = _lsb(cell_id)
    # log2 of lsb via bit_length; vectorized through float conversion is
    # unsafe for 64-bit ints, so count trailing zeros arithmetically.
    tz = np.zeros(lsb.shape, dtype=np.int64)
    v = lsb.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        mask = (v & _U64((1 << shift) - 1)) == 0
        nonzero = v != 0
        step = np.where(mask & nonzero, shift, 0)
        tz += step
        v = v >> _u64(step)
    return MAX_LEVEL - tz // 2


def parent_at_level(cell_id, level):
    """Ancestor id at `level` (level must be <= each cell's own level)."""
    cell_id = _u64(cell_id)
    new_lsb = lsb_for_level(level)
    # (0 - new_lsb) in uint64 arithmetic masks off all bits below new_lsb.
    return (cell_id & (~new_lsb + _U64(1))) | new_lsb


def children(cell_id):
    """The 4 child ids of each cell. Returns shape (..., 4)."""
    cell_id = _u64(cell_id)
    old_lsb = _lsb(cell_id)
    new_lsb = old_lsb >> _U64(2)
    base = cell_id - old_lsb + new_lsb
    offsets = (_U64(2) * np.arange(4, dtype=np.uint64)) * new_lsb[..., None]
    return base[..., None] + offsets


def is_leaf(cell_id):
    return (_u64(cell_id) & _U64(1)) != 0


def id_to_token(cell_id):
    """Hex token: 16 hex digits with trailing zeros stripped ('X' for id 0)."""
    flat = np.atleast_1d(_u64(cell_id))
    out = []
    for v in flat.tolist():
        if v == 0:
            out.append("X")
        else:
            out.append(format(v, "016x").rstrip("0"))
    if np.ndim(cell_id) == 0:
        return out[0]
    return np.array(out)


def token_to_id(token):
    """Inverse of `id_to_token`. Accepts str or array of str."""
    def one(t):
        t = str(t).strip().lower()
        if t in ("", "x"):
            return 0
        return int(t.ljust(16, "0"), 16)

    if np.ndim(token) == 0 and not isinstance(token, (list, tuple, np.ndarray)):
        return _U64(one(token))
    return np.array([one(t) for t in np.asarray(token).ravel()],
                    dtype=np.uint64).reshape(np.shape(token))


# ---------------------------------------------------------------------------
# cell id -> center lat/lng
# ---------------------------------------------------------------------------


def face_uv_to_xyz(face, u, v):
    face = np.asarray(face)
    u = np.asarray(u, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    ones = np.ones_like(u)
    xyz = np.empty(u.shape + (3,), dtype=np.float64)
    tables = [
        (ones, u, v),        # face 0
        (-u, ones, v),       # face 1
        (-u, -v, ones),      # face 2
        (-ones, -v, -u),     # face 3
        (v, -ones, -u),      # face 4
        (v, u, -ones),       # face 5
    ]
    for f, (x, y, z) in enumerate(tables):
        m = face == f
        if np.any(m):
            xyz[m, 0] = x[m]
            xyz[m, 1] = y[m]
            xyz[m, 2] = z[m]
    return xyz


def cell_id_to_latlng(cell_id):
    """Center (lat, lng) in degrees for each cell id."""
    cell_id = _u64(cell_id)
    face, i, j = to_face_ij(cell_id)
    # Center offset in (si, ti) coordinates: leaf cells sit at +1; non-leaf
    # cells at +0 or +2 depending on the Hilbert orientation parity.
    leaf = is_leaf(cell_id)
    parity = ((i ^ (cell_id >> _U64(2))) & _U64(1)) != 0
    delta = np.where(leaf, _U64(1), np.where(parity, _U64(2), _U64(0)))
    si = _U64(2) * i + delta
    ti = _U64(2) * j + delta
    s = si.astype(np.float64) / (2.0 * MAX_SIZE)
    t = ti.astype(np.float64) / (2.0 * MAX_SIZE)
    xyz = face_uv_to_xyz(face, st_to_uv(s), st_to_uv(t))
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lat = np.rad2deg(np.arctan2(z, np.hypot(x, y)))
    lng = np.rad2deg(np.arctan2(y, x))
    return lat, lng


def cell_id_at_level(lat_deg, lng_deg, level):
    """Degree lat/lng -> cell id at `level` (convenience wrapper)."""
    return parent_at_level(latlng_to_cell_id(lat_deg, lng_deg), level)
