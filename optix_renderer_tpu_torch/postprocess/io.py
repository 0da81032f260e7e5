"""Image/buffer IO.

Replaces the reference's raw ``.btc`` float4 dumps + offline converters
(include/viewer.hpp:695-713, save.py): buffers save directly as .npy
(lossless float) and .png (gamma).  A ``.btc``-compatible reader/writer is
provided for interop with reference dumps.
"""

from __future__ import annotations

import numpy as np

from .tonemap import gamma, to_uint8


def save_npy(path: str, img: np.ndarray) -> None:
    np.save(path, np.asarray(img, np.float32))


def save_png(path: str, img: np.ndarray, apply_gamma: bool = True, flip: bool = True) -> None:
    """Write (H, W, 3|1) float image. ``flip`` converts the renderer's
    bottom-up row order (OpenGL convention, see engine.camera) to PNG's
    top-down — the same vertical flip save.py:10 performs."""
    from PIL import Image

    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    if flip:
        img = img[::-1]
    out = to_uint8(gamma(img) if apply_gamma else np.clip(img, 0, 1))
    Image.fromarray(out[..., :3]).save(path)


def save_exr(path: str, img: np.ndarray, flip: bool = True) -> None:
    """Minimal OpenEXR 2.0 writer: scanline, float32, no compression.

    The reference pipeline's interchange format (save.py converts .btc
    dumps to EXR; ltc_ratio_estimator.py consumes denoised EXRs) — written
    from scratch against the OpenEXR file-layout spec so no external EXR
    package is needed.  Channels: R,G,B (or Y for single-channel).
    """
    import struct

    img = np.ascontiguousarray(np.asarray(img, np.float32))
    if img.ndim == 2:
        img = img[..., None]
    if flip:
        img = img[::-1]
    h, w, c = img.shape
    names = ["Y"] if c == 1 else ["R", "G", "B"][:c]
    # EXR stores channels per scanline sorted lexicographically
    order = sorted(range(len(names)), key=lambda i: names[i])

    def attr(name: str, typ: str, payload: bytes) -> bytes:
        return name.encode() + b"\0" + typ.encode() + b"\0" + struct.pack("<i", len(payload)) + payload

    chlist = b""
    for i in order:
        chlist += names[i].encode() + b"\0" + struct.pack("<i", 2)  # FLOAT
        chlist += struct.pack("<BBBB", 0, 0, 0, 0) + struct.pack("<ii", 1, 1)
    chlist += b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (
        attr("channels", "chlist", chlist)
        + attr("compression", "compression", b"\0")
        + attr("dataWindow", "box2i", box)
        + attr("displayWindow", "box2i", box)
        + attr("lineOrder", "lineOrder", b"\0")
        + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
        + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\0"
    )
    magic = struct.pack("<ii", 20000630, 2)
    line_size = 8 + len(order) * w * 4  # y + size prefix counted below
    data_off = len(magic) + len(header) + 8 * h
    with open(path, "wb") as f:
        f.write(magic)
        f.write(header)
        for y in range(h):  # scanline offset table
            f.write(struct.pack("<Q", data_off + y * line_size))
        for y in range(h):
            f.write(struct.pack("<ii", y, len(order) * w * 4))
            for i in order:
                f.write(img[y, :, i].tobytes())


def load_exr(path: str) -> np.ndarray:
    """Reader for the files :func:`save_exr` writes (uncompressed float32
    scanline EXR) — enough to round-trip framework dumps and reference
    pipeline outputs saved the same way."""
    import struct

    with open(path, "rb") as f:
        raw = f.read()
    magic, _version = struct.unpack_from("<ii", raw, 0)
    assert magic == 20000630, "not an EXR file"
    pos = 8
    channels: list[str] = []
    data_window = None
    compression = 0
    while raw[pos] != 0:
        nul = raw.index(b"\0", pos)
        name = raw[pos:nul].decode()
        pos = nul + 1
        nul = raw.index(b"\0", pos)
        typ = raw[pos:nul].decode()
        pos = nul + 1
        (size,) = struct.unpack_from("<i", raw, pos)
        pos += 4
        payload = raw[pos:pos + size]
        pos += size
        if name == "channels":
            p = 0
            while payload[p] != 0:
                n2 = payload.index(b"\0", p)
                channels.append(payload[p:n2].decode())
                p = n2 + 1 + 16  # type + pLinear/reserved + samplings
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", payload)
        elif name == "compression":
            compression = payload[0]
    assert compression == 0, "only uncompressed EXR supported"
    pos += 1  # header terminator
    x0, y0, x1, y1 = data_window
    w, h = x1 - x0 + 1, y1 - y0 + 1
    pos += 8 * h  # offset table
    img = np.empty((h, w, len(channels)), np.float32)
    for y in range(h):
        _, size = struct.unpack_from("<ii", raw, pos)
        pos += 8
        for ci in range(len(channels)):
            img[y, :, ci] = np.frombuffer(raw, np.float32, w, pos)
            pos += w * 4
    # channels were written sorted; map back to R,G,B order if present
    if set(channels) >= {"R", "G", "B"}:
        idx = [channels.index(ch) for ch in ("R", "G", "B")]
        img = img[:, :, idx]
    return img[::-1]


def save_btc(path: str, img: np.ndarray) -> None:
    """Raw float4 dump, reference layout (viewer.hpp:710: fwrite of
    W*H float4, row-major from buffer order)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    out = np.ones((h, w, 4), np.float32)
    out[..., : img.shape[-1]] = img.reshape(h, w, -1)
    out.tofile(path)


def load_btc(path: str, width: int) -> np.ndarray:
    """Read a reference .btc dump -> (H, width, 4) float32 (save.py:6-9)."""
    raw = np.fromfile(path, dtype=np.float32)
    return raw.reshape(-1, width, 4)
