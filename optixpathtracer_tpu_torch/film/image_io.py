"""PNG/BMP output and the display transform (port of
`optixpathtracer_tpu/film/image_io.py`; reference `WriteImage.cpp:8-32`,
BMP via stb). PNG goes through PIL, as in the reference; BMP is written
directly (24-bit, bottom-up, which is the film's row order, like stb's
y-flip)."""
from __future__ import annotations

import struct

import numpy as np
import torch

from .color import agx_tonemap, linear_to_srgb
from .exr import to_host


def to_display(image, tonemap: str = "srgb"):
    """Linear film [H, W, 3] (a tensor or an array) -> uint8 display image
    (row 0 = bottom), on the host."""
    img = np.asarray(to_host(image), np.float32)
    img = np.where(np.isfinite(img), img, np.float32(0.0))
    if tonemap == "agx":
        img = agx_tonemap(img)
        img = linear_to_srgb(img).numpy()
    elif tonemap == "srgb":
        img = linear_to_srgb(torch.from_numpy(img)).numpy()
    elif tonemap != "none":
        raise ValueError(tonemap)
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, image, tonemap: str = "srgb") -> None:
    """Write the film to PNG (flipped to top-down for display)."""
    from PIL import Image
    arr = to_display(image, tonemap)[::-1]
    Image.fromarray(arr).save(path)


def write_bmp(path: str, image, tonemap: str = "srgb") -> None:
    """24-bit uncompressed BMP (reference `WriteImage::WriteBMP`,
    `WriteImage.cpp:8-32`). BMP stores rows bottom-up = our film order."""
    arr = to_display(image, tonemap)  # [H, W, 3], row 0 bottom
    h, w, _ = arr.shape
    row_size = (3 * w + 3) & ~3
    pad = row_size - 3 * w
    data_size = row_size * h
    with open(path, "wb") as f:
        f.write(b"BM")
        f.write(struct.pack("<IHHI", 14 + 40 + data_size, 0, 0, 14 + 40))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, data_size,
                            2835, 2835, 0, 0))
        padding = b"\x00" * pad
        bgr = arr[:, :, ::-1]  # BMP is BGR
        for y in range(h):
            f.write(bgr[y].tobytes())
            f.write(padding)
