"""Native IO library: PNG decode + threaded replay loader vs OpenCV."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from stereo_vo.data.native_loader import (
    NativeStereoLoader,
    native_available,
    read_png_gray,
)

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native toolchain unavailable"
)


@pytest.fixture(scope="module")
def png_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pngs")
    ldir = root / "image_0"
    rdir = root / "image_1"
    ldir.mkdir()
    rdir.mkdir()
    rng = np.random.default_rng(0)
    imgs = []
    for i in range(6):
        l = rng.integers(0, 255, (37, 53), dtype=np.uint8)
        r = rng.integers(0, 255, (37, 53), dtype=np.uint8)
        cv2.imwrite(str(ldir / f"{i:06d}.png"), l)
        cv2.imwrite(str(rdir / f"{i:06d}.png"), r)
        imgs.append((l, r))
    return str(ldir), str(rdir), imgs


def test_png_decode_bitexact(png_dirs, tmp_path):
    ldir, _, imgs = png_dirs
    out = read_png_gray(f"{ldir}/000002.png")
    np.testing.assert_array_equal(out, imgs[2][0])


def test_png_decode_rgb_to_gray(tmp_path):
    rng = np.random.default_rng(1)
    bgr = rng.integers(0, 255, (20, 30, 3), dtype=np.uint8)
    p = str(tmp_path / "c.png")
    cv2.imwrite(p, bgr)
    ours = read_png_gray(p)
    ref = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    # rounding conventions differ by at most 1 LSB
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


def test_png_decode_large_filtered(tmp_path):
    # smooth gradients exercise Sub/Up/Average/Paeth filters
    y, x = np.mgrid[0:200, 0:300]
    img = ((x + y) % 256).astype(np.uint8)
    p = str(tmp_path / "g.png")
    cv2.imwrite(p, img)
    np.testing.assert_array_equal(read_png_gray(p), img)


def test_threaded_loader_in_order(png_dirs):
    ldir, rdir, imgs = png_dirs
    loader = NativeStereoLoader(ldir, rdir, prefetch=3, n_threads=3)
    assert len(loader) == 6
    got = list(loader)
    assert len(got) == 6
    for (gl, gr), (el, er) in zip(got, imgs):
        np.testing.assert_array_equal(gl, el)
        np.testing.assert_array_equal(gr, er)
    loader.close()


def test_missing_file_error(tmp_path):
    with pytest.raises(IOError):
        read_png_gray(str(tmp_path / "nope.png"))
