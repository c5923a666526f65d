"""Image output (counterpart of enoki_tpu/render/io.py).

Parity with the reference mini-app's ``write_image`` (tests/sphere.cpp:
122-127): plain-text grayscale P3 PPM, one intensity per pixel replicated
to RGB, values clamped to [0, 255].
"""

from __future__ import annotations

import numpy as np


def write_ppm(filename: str, image: np.ndarray) -> None:
    img = np.asarray(image)
    h, w = img.shape
    v = np.clip(img, 0, 255).astype(np.int32)
    with open(filename, "w") as fh:
        fh.write(f"P3\n{w} {h}\n255\n")
        # vectorized formatting: "v v v" per pixel
        rows = np.repeat(v.reshape(-1, 1), 3, axis=1)
        np.savetxt(fh, rows, fmt="%d")


def read_ppm(filename: str) -> np.ndarray:
    with open(filename) as fh:
        magic = fh.readline().strip()
        if magic != "P3":
            raise ValueError(f"{filename}: not a plain-text PPM (P3), "
                             f"starts with {magic!r}")
        w, h = map(int, fh.readline().split())
        fh.readline()  # maxval
        data = np.loadtxt(fh, dtype=np.int32).reshape(h * w, 3)
    return data[:, 0].reshape(h, w).astype(np.float32)
