"""Minimal OpenEXR 2.0 scanline writer/reader, uncompressed FLOAT (port of
`optixpathtracer_tpu/film/exr.py`, byte for byte the same files).

The equivalent of the reference's tinyexr-based EXR export
(`WriteImage.cpp:35-99`): 3 float channels in B,G,R order, rows flipped so
the file is top-down, NaN pixels scrubbed to 0 with a console warning
(reference NaN scrub at `WriteImage.cpp:52-55`). No external EXR dependency -
the format's uncompressed scanline profile is simple enough to emit directly,
and the bundled reader round-trips our own files for tests and resume.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

_MAGIC = 20000630
_VERSION = 2
_PIXEL_FLOAT = 2


def _attr(name: bytes, type_: bytes, value: bytes) -> bytes:
    return name + b"\x00" + type_ + b"\x00" + struct.pack("<i", len(value)) + value


def to_host(image) -> np.ndarray:
    """A tensor (on any device) or an array as a host numpy array."""
    if isinstance(image, torch.Tensor):
        return image.detach().cpu().numpy()
    return np.asarray(image)


def write_exr(path: str, image) -> None:
    """Write [H, W, 3] linear float32 RGB (a tensor or an array) to an
    uncompressed EXR.

    Row 0 of `image` is the BOTTOM of the picture (GL/film convention);
    like the reference writer we flip to EXR's top-down scanline order
    (`WriteImage.cpp` row-flip).
    """
    img = np.asarray(to_host(image), np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3], got {img.shape}")
    nan_mask = ~np.isfinite(img)
    if nan_mask.any():
        print(f"[write_exr] WARNING: {int(nan_mask.any(axis=-1).sum())} "
              "non-finite pixels scrubbed to 0")
        img = np.where(nan_mask, 0.0, img)

    img = img[::-1]  # film bottom-up -> EXR top-down
    h, w, _ = img.shape

    # channel list, alphabetical: B, G, R (float, sampling 1)
    chan = b""
    for name in (b"B", b"G", b"R"):
        chan += name + b"\x00" + struct.pack("<i", _PIXEL_FLOAT)
        chan += struct.pack("<BBBB", 0, 0, 0, 0)  # pLinear + reserved
        chan += struct.pack("<ii", 1, 1)          # x/y sampling
    chan += b"\x00"

    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b""
    header += _attr(b"channels", b"chlist", chan)
    header += _attr(b"compression", b"compression", struct.pack("<B", 0))
    header += _attr(b"dataWindow", b"box2i", box)
    header += _attr(b"displayWindow", b"box2i", box)
    header += _attr(b"lineOrder", b"lineOrder", struct.pack("<B", 0))
    header += _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0, 0))
    header += _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\x00"

    preamble = struct.pack("<ii", _MAGIC, _VERSION) + header
    table_start = len(preamble)
    data_start = table_start + 8 * h
    row_bytes = 8 + 3 * 4 * w  # y + size + 3 float channels

    with open(path, "wb") as f:
        f.write(preamble)
        for y in range(h):
            f.write(struct.pack("<Q", data_start + y * row_bytes))
        for y in range(h):
            f.write(struct.pack("<ii", y, 3 * 4 * w))
            # channel order B, G, R, each the full row
            f.write(img[y, :, 2].astype("<f4").tobytes())
            f.write(img[y, :, 1].astype("<f4").tobytes())
            f.write(img[y, :, 0].astype("<f4").tobytes())


def read_exr(path: str) -> np.ndarray:
    """Read an uncompressed FLOAT scanline EXR written by write_exr (or any
    compatible single-part RGB file). Returns [H, W, 3] float32 with row 0 at
    the BOTTOM (film convention)."""
    with open(path, "rb") as f:
        raw = f.read()
    magic, version = struct.unpack_from("<ii", raw, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    off = 8
    attrs = {}
    while raw[off] != 0:
        name_end = raw.index(b"\x00", off)
        name = raw[off:name_end].decode()
        off = name_end + 1
        type_end = raw.index(b"\x00", off)
        type_ = raw[off:type_end].decode()
        off = type_end + 1
        (size,) = struct.unpack_from("<i", raw, off)
        off += 4
        attrs[name] = (type_, raw[off:off + size])
        off += size
    off += 1  # header terminator

    if attrs["compression"][1][0] != 0:
        raise ValueError("only uncompressed EXR supported")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1

    # channel names in file order (alphabetical)
    chan_raw = attrs["channels"][1]
    names = []
    coff = 0
    while chan_raw[coff] != 0:
        nend = chan_raw.index(b"\x00", coff)
        names.append(chan_raw[coff:nend].decode())
        coff = nend + 1 + 16
    idx = {n: i for i, n in enumerate(names)}

    off += 8 * h  # skip offset table
    img = np.zeros((h, w, 3), np.float32)
    n_chan = len(names)
    for row in range(h):
        y, size = struct.unpack_from("<ii", raw, off)
        off += 8
        data = np.frombuffer(raw, "<f4", count=n_chan * w, offset=off)
        off += size
        data = data.reshape(n_chan, w)
        for rgb_i, cname in enumerate(("R", "G", "B")):
            if cname in idx:
                img[y - y0, :, rgb_i] = data[idx[cname]]
    return img[::-1]  # EXR top-down -> film bottom-up
