"""P6 PPM image I/O.

The reference mmaps an *existing* binary PPM and parses its header by hand
(map_P6 / Eat_Space / Get_Number, nbody-seq.c:171-304) — the parsed
``xdim``/``ydim`` define the simulation arena.  Same contract here: parse the
header (whitespace + ``#`` comments), expose the pixel-data offset, and write
frames in place.  A C implementation of the in-place frame blit lives in
native/ (used when the library loads).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


class PPMError(Exception):
    pass


@dataclasses.dataclass
class PPMFile:
    path: str
    xdim: int
    ydim: int
    maxval: int
    data_offset: int

    @property
    def npixels(self) -> int:
        return self.xdim * self.ydim


def _tokenize_header(buf: bytes):
    """Yield (token, end_offset) for header ints, honoring '#' comments."""
    i = 0
    n = len(buf)

    def eat_space(i):
        while i < n and buf[i:i + 1] in b" \t\n\r#":
            if buf[i:i + 1] == b"#":
                while i < n and buf[i:i + 1] != b"\n":
                    i += 1
            i += 1
        return i

    while True:
        i = eat_space(i)
        j = i
        while j < n and buf[j:j + 1].isdigit():
            j += 1
        if j == i:
            raise PPMError("malformed PPM header: expected integer")
        yield int(buf[i:j]), j
        i = j


def read_header(path: str) -> PPMFile:
    # 64 KiB covers any real-world comment block; the reference parses the
    # whole mmapped file, so a short fixed read must not reject headers with
    # long '#' comments.
    with open(path, "rb") as f:
        head = f.read(65536)
    if len(head) < 2 or head[0:1] != b"P":
        raise PPMError(f"{path}: not a PPM file")
    if head[1:2] != b"6":
        raise PPMError(f"{path}: not a P6 (binary RGB) PPM")
    toks = _tokenize_header(head[2:])
    xdim, _ = next(toks)
    ydim, _ = next(toks)
    maxval, end = next(toks)
    if xdim < 1 or ydim < 1:
        # A zero dimension would reach init's rand() % xdim as a division
        # by zero; reject it at the parser.
        raise PPMError(f"{path}: non-positive dimensions {xdim}x{ydim}")
    if maxval > 255:
        raise PPMError(f"{path}: 16-bit PPM unsupported (maxval={maxval})")
    # Exactly one whitespace byte separates maxval from pixel data.
    sep = head[2 + end:2 + end + 1]
    if sep not in (b" ", b"\t", b"\n", b"\r"):
        raise PPMError(f"{path}: malformed separator before pixel data")
    return PPMFile(path, xdim, ydim, maxval, 2 + end + 1)


def create(path: str, xdim: int, ydim: int,
           pixels: np.ndarray | None = None) -> PPMFile:
    """Create a P6 file (the reference never creates one; tests and the
    smoke run use it so they need no binary fixtures)."""
    header = b"P6\n%d %d\n255\n" % (xdim, ydim)
    if pixels is None:
        pixels = np.zeros((ydim, xdim, 3), np.uint8)
    with open(path, "wb") as f:
        f.write(header)
        f.write(np.ascontiguousarray(pixels, np.uint8).tobytes())
    return PPMFile(path, xdim, ydim, 255, len(header))


def write_pixels(ppm: PPMFile, pixels: np.ndarray) -> None:
    """In-place frame update (the display+msync analog, nbody-seq.c:467-471).

    Uses the native mmap blit (native/nbody_host.cpp) when the library
    loads; otherwise plain seek+write."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    if pixels.shape != (ppm.ydim, ppm.xdim, 3):
        raise ValueError("frame of shape %s does not fit the %dx%d arena"
                         % (pixels.shape, ppm.xdim, ppm.ydim))
    from . import native_bridge
    if native_bridge.ppm_blit(ppm.path, ppm.data_offset, pixels):
        return
    with open(ppm.path, "r+b") as f:
        f.seek(ppm.data_offset)
        f.write(pixels.tobytes())
        f.flush()
        os.fsync(f.fileno())


def read_pixels(ppm: PPMFile) -> np.ndarray:
    with open(ppm.path, "rb") as f:
        f.seek(ppm.data_offset)
        raw = f.read(ppm.npixels * 3)
    return np.frombuffer(raw, np.uint8).reshape(ppm.ydim, ppm.xdim, 3)
