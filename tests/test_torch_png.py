"""The port's PNG reader and writer (`posecnn_torch/utils/png.py`, its row
filters in `csrc/png.cc`) against cv2.

`imread` equals `cv2.imread` under IMREAD_COLOR and IMREAD_UNCHANGED on
8- and 16-bit grey, grey + alpha, BGR, BGRA and palette files (with and
without tRNS), bit depths 1, 2 and 4, Adam7-interlaced files, odd widths, 1x1
and 1xN images and images split over several IDAT chunks, with each filter
type 0-4 present in the files (the filter bytes are asserted); a corrupt
CRC raises and so does a missing file; the C++ row filters equal their
NumPy version `unfilter_plain` on hypothesis-drawn rows; `write_png`
round-trips through `cv2.imread`.
"""

from __future__ import annotations

import struct
import zlib

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from posecnn_torch.native import png_unfilter
from posecnn_torch.utils import png as P

FILTERS = (cv2.IMWRITE_PNG_FILTER_NONE, cv2.IMWRITE_PNG_FILTER_SUB, cv2.IMWRITE_PNG_FILTER_UP,
           cv2.IMWRITE_PNG_FILTER_AVG, cv2.IMWRITE_PNG_FILTER_PAETH)


def filter_bytes(path: str) -> set:
    """The filter-type bytes of a non-interlaced PNG's rows."""
    chunks = P.read_chunks(path)
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[0][1][:10])
    raw = np.frombuffer(zlib.decompress(b"".join(d for k, d in chunks if k == "IDAT")), np.uint8)
    return set(raw.reshape(h, -1)[:, 0].tolist())


def assert_reads_like_cv2(path: str) -> None:
    for flags in (cv2.IMREAD_COLOR, cv2.IMREAD_UNCHANGED):
        ref, got = cv2.imread(path, flags), P.imread(path, flags)
        assert ref is not None, path
        assert got.dtype == ref.dtype and got.shape == ref.shape and np.array_equal(got, ref), (path, flags)


SHAPES = [(7, 5), (7, 5, 3), (7, 5, 4), (33, 17, 3), (1, 1), (1, 9, 3), (5, 1, 4)]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_imread_matches_cv2_on_every_filter(tmp_path, dtype, shape):
    """Grey, BGR and BGRA, 8 and 16 bits, odd widths, 1x1, 1xN and Nx1,
    each written by cv2 with every filter type; on the images of more
    than one pixel a row, the file holds the filter asked for."""
    rng = np.random.RandomState(sum(shape))
    a = rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    for kind, flag in enumerate(FILTERS):
        path = str(tmp_path / f"f{kind}.png")
        assert cv2.imwrite(path, a, [cv2.IMWRITE_PNG_FILTER, flag])
        if shape[1] > 1 and shape[0] > 1:
            assert filter_bytes(path) == {kind}
        assert_reads_like_cv2(path)


def test_every_filter_type_is_covered(tmp_path):
    """cv2 writes each filter type 0-4 when asked for it (the file with
    all five in turn is test_several_idat_chunks_and_a_corrupt_crc's)."""
    seen = set()
    a = np.random.RandomState(0).randint(0, 256, (40, 33, 3)).astype(np.uint8)
    for kind, flag in enumerate(FILTERS):
        path = str(tmp_path / f"f{kind}.png")
        cv2.imwrite(path, a, [cv2.IMWRITE_PNG_FILTER, flag])
        seen |= filter_bytes(path)
        assert_reads_like_cv2(path)
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("case", ["palette", "palette_trns", "grey_alpha", "rgb_trns", "grey_1bit", "palette_2bit",
                                  "grey16_trns"])
def test_imread_matches_cv2_on_pil_files(tmp_path, case):
    """Palette images (alpha from tRNS under IMREAD_UNCHANGED, dropped under
    IMREAD_COLOR), grey + alpha, an RGB colour key, grey at 1 bit and a
    palette at 2 bits, written by PIL."""
    rng = np.random.RandomState(3)
    path = str(tmp_path / f"{case}.png")
    rgb = rng.randint(0, 4, (9, 11, 3)).astype(np.uint8) * 80
    if case.startswith("palette"):
        im = Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=4 if case == "palette_2bit" else 16)
        kw = {"transparency": bytes([0, 128, 255])} if case == "palette_trns" else {}
        im.save(path, bits=2, **kw) if case == "palette_2bit" else im.save(path, **kw)
    elif case == "grey_alpha":
        Image.fromarray(rng.randint(0, 255, (9, 11, 2)).astype(np.uint8), "LA").save(path)
    elif case == "rgb_trns":
        rgb[0, 0] = (0, 80, 160)
        Image.fromarray(rgb).save(path, transparency=(0, 80, 160))
    elif case == "grey_1bit":
        Image.fromarray(rng.randint(0, 2, (9, 13)).astype(bool)).save(path)
    else:
        Image.fromarray(rng.randint(0, 65535, (9, 11)).astype(np.uint16)).save(path, transparency=7)
    assert_reads_like_cv2(path)
    if case in ("palette_trns", "grey_alpha", "rgb_trns"):
        assert P.imread(path, P.IMREAD_UNCHANGED).shape == (9, 11, 4)


def _png(path: str, ihdr: tuple, raw_rows: list, idat_parts: int = 1) -> None:
    """A PNG of IHDR (w, h, depth, colour type, interlace) and the filtered
    `raw_rows` (bytes, filter byte first), its zlib stream split over
    `idat_parts` IDAT chunks."""
    w, h, depth, ctype, interlace = ihdr
    z = zlib.compress(b"".join(raw_rows))
    cut = [len(z) * k // idat_parts for k in range(idat_parts + 1)]
    with open(path, "wb") as f:
        f.write(P.SIGNATURE + P._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)))
        for a, b in zip(cut, cut[1:]):
            f.write(P._chunk(b"IDAT", z[a:b]))
        f.write(P._chunk(b"IEND", b""))


@pytest.mark.parametrize("depth,ctype", [(8, 2), (16, 0), (8, 6), (1, 0)])
def test_adam7_interlaced_files(tmp_path, depth, ctype):
    """Adam7: the seven passes' sub-images, each with its own filter rows
    (here None, Up and Sub in turn), read as cv2 reads them, at a size
    with empty passes (3x2) and a larger one."""
    rng = np.random.RandomState(depth + ctype)
    ch = P.CHANNELS[ctype]
    for w, h in ((3, 2), (13, 11)):
        rows = []
        for x0, y0, dx, dy in P.ADAM7:
            pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
            if pw <= 0 or ph <= 0:
                continue
            nbytes = (pw * ch * depth + 7) // 8
            for r in range(ph):
                rows.append(bytes([r % 3]) + rng.randint(0, 256, nbytes).astype(np.uint8).tobytes())
        path = str(tmp_path / f"i{w}.png")
        _png(path, (w, h, depth, ctype, 1), rows)
        assert_reads_like_cv2(path)


@pytest.mark.parametrize("depth,ctype", [(16, 4), (8, 4), (16, 6), (16, 2), (4, 0), (2, 0)])
def test_files_cv2_cannot_write(tmp_path, depth, ctype):
    """Grey + alpha at 8 and 16 bits, RGBA and RGB at 16, grey at 4 and 2
    bits, built here row by row with every filter type in turn, read as
    cv2 reads them."""
    rng = np.random.RandomState(depth * 7 + ctype)
    w, h = 13, 10
    nbytes = (w * P.CHANNELS[ctype] * depth + 7) // 8
    rows = [bytes([y % 5]) + rng.randint(0, 256, nbytes).astype(np.uint8).tobytes() for y in range(h)]
    path = str(tmp_path / "f.png")
    _png(path, (w, h, depth, ctype, 0), rows)
    assert filter_bytes(path) == {0, 1, 2, 3, 4}
    assert_reads_like_cv2(path)


def test_several_idat_chunks_and_a_corrupt_crc(tmp_path):
    """The image data split over 5 IDAT chunks reads as cv2 reads it; one
    byte changed in a chunk's data fails its CRC, naming the chunk; a file
    that is not there raises FileNotFoundError (cv2 returns None)."""
    rng = np.random.RandomState(5)
    w, h = 23, 9
    rows = [bytes([y % 5]) + rng.randint(0, 256, 3 * w).astype(np.uint8).tobytes() for y in range(h)]
    path = str(tmp_path / "split.png")
    _png(path, (w, h, 8, 2, 0), rows, idat_parts=5)
    assert sum(k == "IDAT" for k, _ in P.read_chunks(path)) == 5
    assert filter_bytes(path) == {0, 1, 2, 3, 4}
    assert_reads_like_cv2(path)
    raw = bytearray(open(path, "rb").read())
    raw[8 + 8 + 4] ^= 1  # the first byte of IHDR's data
    bad = str(tmp_path / "bad.png")
    open(bad, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="IHDR.*CRC"):
        P.imread(bad)
    with pytest.raises(FileNotFoundError, match="no file"):
        P.imread(str(tmp_path / "missing.png"))
    with pytest.raises(ValueError, match="filter type 9"):
        P.unfilter_plain(np.array([9, 1, 2], np.uint8), 1, 2, 1)
    with pytest.raises(ValueError, match="row 1 has filter type 7"):
        png_unfilter(np.array([0, 1, 2, 7, 1, 2], np.uint8), 2, 2, 1)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 6), st.integers(1, 40), st.sampled_from([1, 2, 3, 4, 6, 8]), st.data())
def test_png_cc_matches_unfilter_plain(height, rowbytes, bpp, data):
    """The C++ row filters equal the NumPy version on random rows with
    random filter bytes 0-4."""
    body = data.draw(st.binary(min_size=height * rowbytes, max_size=height * rowbytes))
    kinds = data.draw(st.lists(st.integers(0, 4), min_size=height, max_size=height))
    raw = np.frombuffer(body, np.uint8).reshape(height, rowbytes)
    stream = np.concatenate([np.asarray(kinds, np.uint8)[:, None], raw], axis=1).reshape(-1)
    np.testing.assert_array_equal(png_unfilter(stream, height, rowbytes, bpp),
                                  P.unfilter_plain(stream, height, rowbytes, bpp))


@pytest.mark.parametrize("shape,dtype", [((6, 7), np.uint8), ((6, 7, 3), np.uint8), ((6, 7, 4), np.uint8),
                                         ((5, 9), np.uint16), ((5, 9, 3), np.uint16), ((1, 1, 4), np.uint16)])
def test_write_png_round_trip(tmp_path, shape, dtype):
    """write_png, then cv2.imread(IMREAD_UNCHANGED) gives the array back,
    and imread the same; other shapes and dtypes raise."""
    a = np.random.RandomState(7).randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / "w.png")
    P.write_png(path, a)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert ref.dtype == a.dtype and np.array_equal(ref, a)
    assert_reads_like_cv2(path)
    with pytest.raises(ValueError):
        P.write_png(path, a.astype(np.float32))
    with pytest.raises(ValueError, match="flags"):
        P.imread(path, cv2.IMREAD_GRAYSCALE)
