"""The port's film layer (`optixpathtracer_tpu_torch/film`) against the
JAX package's, on the same images made with numpy from a seed.

Tolerances:
- EXR files: the same bytes; the port reads back its own file bit for bit.
- to_display, BMP and PNG: the same uint8 values, except where the
  reference's float32 `pow` (within 3 ulp on the CPU) flips a rounding: at
  most 1e-4 of the values, each by 1 (none differ on these images).
- linear_to_srgb / srgb_to_linear: within 5e-7 relative (the port's pow is
  correctly rounded), and their gradients within 1e-6 relative.
- MSE, SSIM, FLIP: within 1e-5 relative (FLIP runs part of its colour
  pipeline in float32 in the reference, float64 in the port).
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from optixpathtracer_tpu import film as jfilm
from optixpathtracer_tpu_torch import film

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def hdr():
    rng = np.random.default_rng(7)
    img = (rng.random((96, 80, 3)) * 2.0).astype(np.float32)
    img[:4] *= 1e-3  # the linear segment of the sRGB transfer
    return img


def assert_display_close(got, want):
    """Equal up to the reference's pow flipping a rounding."""
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1
    assert (diff != 0).mean() <= 1e-4


def test_exr_bytes_equal_reference(tmp_path, hdr, capsys):
    img = hdr.copy()
    img[3, 4, 1] = np.nan
    img[5, 6, 0] = np.inf
    ours, theirs = str(tmp_path / "port.exr"), str(tmp_path / "ref.exr")
    film.write_exr(ours, torch.from_numpy(img))
    out = capsys.readouterr().out
    assert "2 non-finite pixels scrubbed to 0" in out
    jfilm.write_exr(theirs, img)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    back = film.read_exr(ours)
    want = np.where(np.isfinite(img), img, 0.0)
    np.testing.assert_array_equal(back, want)
    assert back[3, 4, 1] == 0.0 and np.isfinite(back).all()
    np.testing.assert_array_equal(jfilm.read_exr(ours), back)


def test_exr_round_trip(tmp_path, hdr):
    p = str(tmp_path / "t.exr")
    film.write_exr(p, hdr)
    np.testing.assert_array_equal(film.read_exr(p), hdr)


@pytest.mark.parametrize("tonemap", ["srgb", "agx", "none"])
def test_to_display_matches_reference(hdr, tonemap):
    img = hdr.copy()
    img[0, 0] = [np.nan, -1.0, np.inf]
    want = jfilm.to_display(img, tonemap)
    assert_display_close(film.to_display(img, tonemap), want)
    assert_display_close(film.to_display(torch.from_numpy(img), tonemap),
                         want)


def test_to_display_bad_tonemap_raises(hdr):
    with pytest.raises(ValueError):
        film.to_display(hdr, "filmic")


def test_bmp_bytes_match_reference(tmp_path, hdr):
    ours, theirs = str(tmp_path / "port.bmp"), str(tmp_path / "ref.bmp")
    film.write_bmp(ours, torch.from_numpy(hdr))
    jfilm.write_bmp(theirs, hdr)
    a = np.frombuffer(open(ours, "rb").read(), np.uint8)
    b = np.frombuffer(open(theirs, "rb").read(), np.uint8)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a[:54], b[:54])  # the two headers
    assert_display_close(a[54:], b[54:])
    im = Image.open(ours)
    assert im.size == (80, 96)
    # BMP rows are bottom-up, the film's order; PIL returns them top-down
    np.testing.assert_array_equal(np.asarray(im)[::-1],
                                  film.to_display(hdr))


def test_png_decodes_to_reference_pixels(tmp_path, hdr):
    ours, theirs = str(tmp_path / "port.png"), str(tmp_path / "ref.png")
    film.write_png(ours, hdr)
    jfilm.write_png(theirs, hdr)
    got = np.asarray(Image.open(ours).convert("RGB"))
    assert_display_close(got, np.asarray(Image.open(theirs).convert("RGB")))
    np.testing.assert_array_equal(got[::-1], film.to_display(hdr))


def test_srgb_transfer_matches_reference():
    x = np.concatenate([np.linspace(0.0, 0.01, 5001),
                        np.linspace(0.0, 4.0, 20001)]).astype(np.float32)
    for name, lo in (("linear_to_srgb", 0.0), ("srgb_to_linear", 0.0)):
        want = np.asarray(getattr(jfilm.color, name)(x))
        got = getattr(film.color, name)(torch.from_numpy(x))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-7, atol=lo)
    # arrays come back as tensors too
    assert isinstance(film.color.linear_to_srgb(x), torch.Tensor)


def test_srgb_transfer_gradient_matches_jax():
    """The transfers are differentiable, for fitting losses."""
    x = np.linspace(0.01, 2.0, 257).astype(np.float32)
    for name in ("linear_to_srgb", "srgb_to_linear"):
        want = np.asarray(jax.grad(
            lambda v: jnp.sum(getattr(jfilm.color, name)(v)))(x))
        t = torch.from_numpy(x).requires_grad_(True)
        getattr(film.color, name)(t).sum().backward()
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("metric", ["mse", "sqrt_mse", "ssim", "flip"])
def test_metrics_match_reference(hdr, metric):
    rng = np.random.default_rng(11)
    ref = np.clip(hdr[:64, :64], 0, 1)
    noisy = np.clip(ref + rng.normal(0, 0.05, ref.shape), 0, 1)
    noisy = noisy.astype(np.float32)
    want = getattr(jfilm.metrics, metric)(ref, noisy)
    for a, b in ((ref, noisy), (torch.from_numpy(ref), noisy),
                 (torch.from_numpy(ref), torch.from_numpy(noisy))):
        got = getattr(film.metrics, metric)(a, b)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_metrics_identical_zero(hdr):
    img = torch.from_numpy(np.clip(hdr, 0, 1))
    assert film.metrics.mse(img, img) == 0.0
    assert film.metrics.flip(img, img) == 0.0
    assert film.metrics.ssim(img, img) == pytest.approx(1.0)


def test_flip_black_white_near_one():
    assert film.metrics.flip(np.zeros((32, 32, 3)), np.ones((32, 32, 3))) \
        > 0.9


def test_png_from_stream_is_a_png(hdr):
    """write_png takes a path; the preview encodes to memory the same way."""
    from optixpathtracer_tpu_torch.preview import _encode_png
    png = _encode_png(torch.from_numpy(hdr))
    im = Image.open(io.BytesIO(png))
    assert im.format == "PNG"
    np.testing.assert_array_equal(np.asarray(im)[::-1],
                                  film.to_display(hdr))
