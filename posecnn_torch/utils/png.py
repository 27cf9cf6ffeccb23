"""PNG files read and written without cv2.

The JAX package's loaders read the datasets' `-color.png`, `-label.png` and
`-depth.png` files with `cv2.imread` (`posecnn_tpu/data/lov.py:130-142`,
`data/linemod.py:120-139`, `data/synthetic.py:396-407`); the card's host has
no cv2. `imread(path, flags)` gives what `cv2.imread` gives for the two
flags those loaders pass, with libpng's transforms as OpenCV's PNG decoder
asks for them:

  IMREAD_UNCHANGED  grey (H,W); grey with alpha, BGR with a tRNS colour key
                    and palette images with tRNS as (H,W,4) BGRA, alpha 0 at
                    the key's pixels (255 or 65535 elsewhere); BGR (H,W,3);
                    BGRA (H,W,4); 16-bit files as uint16, others as uint8
  IMREAD_COLOR      (H,W,3) uint8 BGR: grey replicated, alpha dropped,
                    palette looked up, 16-bit samples cut to their high byte
                    (libpng's png_set_strip_16)

Grey of 1, 2 or 4 bits is scaled to 8 (x255, x85, x17; palette indices are
not), and Adam7-interlaced files are read pass by pass. A missing file
raises FileNotFoundError (cv2 returns None there), a chunk whose CRC
differs raises ValueError naming the file and the chunk, and a file that
is not a PNG (a JPEG) or an eXIf chunk under IMREAD_COLOR (where cv2 would
turn the image by its orientation) raises NotImplementedError.

The data is chunks, then zlib, then one filter byte a row: the chunks and
the inflation (stdlib `zlib`) are read here; the row filters are undone by
`native.png_unfilter` (`csrc/png.cc`, g++, no fallback: a failed build
raises). `unfilter_plain` is its row-by-row NumPy version, for the tests.
`write_png(path, array)` writes 8- or 16-bit grey, BGR or BGRA (filter 0
on every row).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from posecnn_torch.native import png_unfilter

IMREAD_UNCHANGED = -1
IMREAD_COLOR = 1

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels of each colour type: grey, RGB, palette, grey + alpha, RGBA
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7's passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def is_png(path: str) -> bool:
    """Whether the file starts with the PNG signature."""
    with open(path, "rb") as f:
        return f.read(8) == SIGNATURE


def read_chunks(path: str) -> list:
    """[(type, data)] of the file's chunks, each CRC checked, up to IEND."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] != SIGNATURE:
        raise NotImplementedError(f"{path}: not a PNG file (no PNG signature; JPEG and other formats are not read)")
    chunks, pos = [], 8
    while True:
        if pos + 12 > len(raw):
            raise ValueError(f"{path}: truncated at byte {pos} (no IEND chunk)")
        (n,) = struct.unpack(">I", raw[pos:pos + 4])
        kind, data = raw[pos + 4:pos + 8], raw[pos + 8:pos + 8 + n]
        if len(data) != n or pos + 12 + n > len(raw):
            raise ValueError(f"{path}: chunk {kind!r} at byte {pos} is truncated")
        (crc,) = struct.unpack(">I", raw[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + data) != crc:
            raise ValueError(f"{path}: chunk {kind!r} at byte {pos} fails its CRC")
        chunks.append((kind.decode("latin-1"), data))
        pos += 12 + n
        if kind == b"IEND":
            return chunks


def unfilter_plain(data: np.ndarray, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """`native.png_unfilter` in NumPy, a row at a time (the Sub, Average and
    Paeth filters byte by byte): the plain version the tests hold the C++
    to."""
    rows = np.asarray(data, np.uint8).reshape(height, rowbytes + 1)
    out = np.zeros((height, rowbytes), np.uint8)
    prior = np.zeros(rowbytes, np.int32)
    for y in range(height):
        kind, x = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = x
        elif kind == 2:
            cur = (x + prior) & 255
        elif kind in (1, 3, 4):
            cur = np.zeros(rowbytes, np.int32)
            for i in range(rowbytes):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prior[i])
                c = int(prior[i - bpp]) if i >= bpp else 0
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (int(x[i]) + pred) & 255
        else:
            raise ValueError(f"unfilter_plain: row {y} has filter type {kind}")
        out[y] = cur
        prior = cur
    return out


def _samples(rows: np.ndarray, width: int, depth: int, channels: int) -> np.ndarray:
    """(H, W, channels) samples of unfiltered rows: uint16 at depth 16,
    uint8 below (the packed bits of depths 1, 2 and 4 spread, unscaled)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2")[:, :width * channels].astype(np.uint16).reshape(h, width, channels)
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    vals = (bits.astype(np.uint8) << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(axis=2, dtype=np.uint8)
    return vals[:, :width * channels].reshape(h, width, channels)


def _decode(path: str, ihdr: bytes, idat: bytes) -> tuple:
    """(samples (H, W, channels), depth, colour type) of the image data."""
    width, height, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", ihdr)
    if ctype not in CHANNELS or depth not in ((8, 16) if ctype in (2, 4, 6) else (1, 2, 4, 8) if ctype == 3
                                              else (1, 2, 4, 8, 16)):
        raise ValueError(f"{path}: colour type {ctype} at bit depth {depth} is not a PNG format")
    if comp != 0 or filt != 0 or interlace not in (0, 1) or width == 0 or height == 0:
        raise ValueError(f"{path}: IHDR {width}x{height}, compression {comp}, filter {filt}, interlace {interlace}")
    ch = CHANNELS[ctype]
    bpp = max(1, ch * depth // 8)
    data = np.frombuffer(zlib.decompress(idat), np.uint8)

    def rowbytes(w):
        return (w * ch * depth + 7) // 8

    if interlace == 0:
        need = height * (rowbytes(width) + 1)
        if data.size < need:
            raise ValueError(f"{path}: {data.size} bytes of image data, {need} needed")
        rows = png_unfilter(data[:need], height, rowbytes(width), bpp)
        return _samples(rows, width, depth, ch), depth, ctype
    out = np.zeros((height, width, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in ADAM7:
        w, h = (width - x0 + dx - 1) // dx, (height - y0 + dy - 1) // dy
        if w <= 0 or h <= 0:
            continue  # an empty pass has no rows, not even filter bytes
        need = h * (rowbytes(w) + 1)
        if data.size < pos + need:
            raise ValueError(f"{path}: {data.size} bytes of image data, more needed by the Adam7 passes")
        out[y0::dy, x0::dx] = _samples(png_unfilter(data[pos:pos + need], h, rowbytes(w), bpp), w, depth, ch)
        pos += need
    return out, depth, ctype


def imread(path: str, flags: int = IMREAD_COLOR) -> np.ndarray:
    """`cv2.imread(path, flags)` of a PNG file for flags IMREAD_COLOR and
    IMREAD_UNCHANGED (the module docstring lists what each gives)."""
    if flags not in (IMREAD_COLOR, IMREAD_UNCHANGED):
        raise ValueError(f"imread: flags {flags}: only IMREAD_COLOR (1) and IMREAD_UNCHANGED (-1)")
    try:
        chunks = read_chunks(path)
    except FileNotFoundError:
        raise FileNotFoundError(f"imread: no file {path}") from None
    if chunks[0][0] != "IHDR":
        raise ValueError(f"{path}: the first chunk is {chunks[0][0]}, not IHDR")
    kinds = {k for k, _ in chunks}
    if flags == IMREAD_COLOR and "eXIf" in kinds:
        raise NotImplementedError(f"{path}: an eXIf chunk (cv2 turns the image by its orientation): not read")
    s, depth, ctype = _decode(path, chunks[0][1], b"".join(d for k, d in chunks if k == "IDAT"))
    trns = next((d for k, d in chunks if k == "tRNS"), b"")
    top = 65535 if depth == 16 else 255
    if ctype == 3:
        plte = next((d for k, d in chunks if k == "PLTE"), None)
        if plte is None or len(plte) % 3:
            raise ValueError(f"{path}: a palette image without a valid PLTE chunk")
        lut = np.full((256, 4), 255, np.uint8)
        lut[:len(plte) // 3, :3] = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        lut[:len(trns), 3] = np.frombuffer(trns, np.uint8)[:256]
        s = lut[s[..., 0]][..., : 4 if trns else 3]
    elif ctype in (0, 4) and depth < 8:
        s = s * np.uint8(255 // (2 ** depth - 1))
    # cv2's type: 4 channels for grey + alpha, RGBA, and RGB or palette with tRNS
    four = ctype in (4, 6) or (ctype in (2, 3) and bool(trns))
    if flags == IMREAD_COLOR:
        if depth == 16:
            s = (s >> 8).astype(np.uint8)
        rgb = s[..., :3] if s.shape[2] >= 3 else np.repeat(s[..., :1], 3, axis=2)
        return np.ascontiguousarray(rgb[..., ::-1])
    if ctype == 0:
        return np.ascontiguousarray(s[..., 0])
    if ctype == 2 and trns:
        key = np.frombuffer(trns[:6], ">u2").astype(s.dtype)
        s = np.concatenate([s, np.where((s == key).all(axis=2, keepdims=True), 0, top).astype(s.dtype)], axis=2)
    elif ctype == 4:
        s = s[..., [0, 0, 0, 1]]
    out = s[..., [2, 1, 0, 3]] if four else s[..., ::-1]
    return np.ascontiguousarray(out)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def write_png(path: str, image: np.ndarray) -> None:
    """Write `image` as a PNG: (H,W) grey, (H,W,3) BGR or (H,W,4) BGRA, of
    uint8 or uint16 (stored at bit depth 8 or 16), every row with filter 0,
    zlib at level 1 (cv2's default). `imread(path, IMREAD_UNCHANGED)` gives
    it back."""
    a = np.asarray(image)
    if a.dtype not in (np.uint8, np.uint16) or a.ndim not in (2, 3) or (a.ndim == 3 and a.shape[2] not in (3, 4)):
        raise ValueError(f"write_png: (H,W), (H,W,3) or (H,W,4) uint8 or uint16, got {a.shape} {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    h, w, ch = a.shape
    if ch >= 3:
        a = a[..., [2, 1, 0, 3][:ch]]  # BGR(A) -> RGB(A)
    ctype = {1: 0, 3: 2, 4: 6}[ch]
    depth = 16 if a.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(a.astype(">u2") if depth == 16 else a).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + _chunk(b"IEND", b""))
