"""Small separable image filters as fused XLA ops.

Building blocks for the detection/tracking/stereo kernels. Border handling is
reflect-101 (OpenCV's BORDER_DEFAULT) unless noted. Images are ``[H, W]``
float32; everything vectorizes over leading batch dims via standard broadcasting
of ``jnp.pad``/slicing, and XLA fuses the tap sums into a handful of VPU passes.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp


def _pad(img: jnp.ndarray, ry: int, rx: int, mode: str = "reflect") -> jnp.ndarray:
    pad = [(0, 0)] * (img.ndim - 2) + [(ry, ry), (rx, rx)]
    if mode == "edge":
        return jnp.pad(img, pad, mode="edge")
    return jnp.pad(img, pad, mode="reflect")  # numpy reflect == OpenCV REFLECT_101


def sep_filter(img: jnp.ndarray, ky, kx, mode: str = "reflect") -> jnp.ndarray:
    """Separable 2D correlation with 1D taps ``ky`` (rows) then ``kx`` (cols)."""
    ky = np.asarray(ky, np.float32)
    kx = np.asarray(kx, np.float32)
    ry, rx = len(ky) // 2, len(kx) // 2
    p = _pad(img, ry, 0, mode)
    h = img.shape[-2]
    out = sum(
        float(ky[i]) * p[..., i : i + h, :] for i in range(len(ky)) if ky[i] != 0
    )
    p = _pad(out, 0, rx, mode)
    w = img.shape[-1]
    return sum(
        float(kx[i]) * p[..., :, i : i + w] for i in range(len(kx)) if kx[i] != 0
    )


def sobel_x(img: jnp.ndarray, mode: str = "reflect") -> jnp.ndarray:
    """Sobel d/dx, ksize 3 (smooth [1,2,1] over rows, diff [-1,0,1] over cols)."""
    return sep_filter(img, [1.0, 2.0, 1.0], [-1.0, 0.0, 1.0], mode)


def sobel_y(img: jnp.ndarray, mode: str = "reflect") -> jnp.ndarray:
    return sep_filter(img, [-1.0, 0.0, 1.0], [1.0, 2.0, 1.0], mode)


def scharr_x(img: jnp.ndarray, mode: str = "reflect") -> jnp.ndarray:
    """Scharr d/dx as used by OpenCV's LK spatial gradients (divided by 32)."""
    return sep_filter(img, [3.0, 10.0, 3.0], [-1.0, 0.0, 1.0], mode) / 32.0


def scharr_y(img: jnp.ndarray, mode: str = "reflect") -> jnp.ndarray:
    return sep_filter(img, [-1.0, 0.0, 1.0], [3.0, 10.0, 3.0], mode) / 32.0


def box_filter(img: jnp.ndarray, radius: int, mode: str = "reflect") -> jnp.ndarray:
    """Unnormalized (2r+1)^2 box sum.

    Small radii use separable tap sums (a handful of fused adds); large radii
    use 2D cumulative sums (two passes + four shifted views regardless of
    radius — the right shape for 21x21 StereoBM windows).
    """
    k = 2 * radius + 1
    if radius <= 3:
        ones = np.ones(k, np.float32)
        return sep_filter(img, ones, ones, mode)
    p = _pad(img, radius, radius, mode)
    # integral image with leading zero row/col
    ii = jnp.cumsum(jnp.cumsum(p, axis=-2), axis=-1)
    zshape_r = ii.shape[:-2] + (1, ii.shape[-1])
    ii = jnp.concatenate([jnp.zeros(zshape_r, ii.dtype), ii], axis=-2)
    zshape_c = ii.shape[:-1] + (1,)
    ii = jnp.concatenate([jnp.zeros(zshape_c, ii.dtype), ii], axis=-1)
    h, w = img.shape[-2:]
    return (
        ii[..., k : k + h, k : k + w]
        - ii[..., 0:h, k : k + w]
        - ii[..., k : k + h, 0:w]
        + ii[..., 0:h, 0:w]
    )


def sliding_sum(padded: jnp.ndarray, k: int, axis: int) -> jnp.ndarray:
    """Sum over every length-``k`` window along ``axis`` via log-tree doubling.

    ``padded`` must carry ``k - 1`` extra elements along ``axis``; the output
    has ``padded.shape[axis] - k + 1`` entries, entry ``i`` summing
    ``padded[i : i + k]``. ~2*log2(k) shifted adds expressed as static slices
    (contiguous views XLA fuses into a couple of elementwise passes) — no
    cumsums, no rolls.
    """
    n_out = padded.shape[axis] - k + 1
    arrs = {1: padded}
    c = 1
    while c * 2 <= k:
        a = arrs[c]
        n = a.shape[axis]
        arrs[c * 2] = jax.lax.slice_in_dim(a, 0, n - c, axis=axis) + \
            jax.lax.slice_in_dim(a, c, n, axis=axis)
        c *= 2
    out = None
    off = 0
    for c in sorted(arrs, reverse=True):
        if k & c:
            piece = jax.lax.slice_in_dim(arrs[c], off, off + n_out, axis=axis)
            out = piece if out is None else out + piece
            off += c
    return out


def box_sum_tree(img: jnp.ndarray, radius: int, mode: str = "reflect") -> jnp.ndarray:
    """(2r+1)^2 box sum via separable sliding sums (see ``sliding_sum``)."""
    k = 2 * radius + 1
    p = _pad(img, radius, radius, mode)
    return sliding_sum(sliding_sum(p, k, axis=-2), k, axis=-1)


def max_filter(img: jnp.ndarray, radius: int) -> jnp.ndarray:
    """(2r+1)^2 sliding max — separable, log-depth doubling.

    Shifts are expressed as pad + static slice (cheap contiguous views), NOT
    ``jnp.roll``, so the -inf border masking comes for free from the pad
    value.
    """
    out = img
    neg = -float(np.inf)
    for axis in (-2, -1):
        acc = out
        n = out.shape[axis]
        cover = 0
        shift = 1
        # running max over [-radius, +radius]; combining windows of cover c
        # shifted by s <= 2c+1 keeps coverage contiguous
        while cover < radius:
            s = min(shift, radius - cover)
            pad = [(0, 0)] * acc.ndim
            pad[axis] = (s, s)
            p = jnp.pad(acc, pad, constant_values=neg)
            lo = jax.lax.slice_in_dim(p, 0, n, axis=acc.ndim + axis)
            hi = jax.lax.slice_in_dim(p, 2 * s, 2 * s + n, axis=acc.ndim + axis)
            acc = jnp.maximum(acc, jnp.maximum(lo, hi))
            cover += s
            shift = 2 * cover + 1
        out = acc
    return out
