"""Image preprocessing & augmentation helpers.

Role analog of the reference's python/paddle/utils/image_util.py:30-101
(resize/flip/crop/mean-subtract/oversample/ImageTransformer) — re-designed
rather than translated:

- every random op takes an explicit ``rng`` (numpy Generator/RandomState);
  nothing reads global numpy random state, so a provider seeded per file
  is bit-reproducible (the reference uses np.random.* globals);
- pure-numpy host-side transforms (this is input-pipeline work that
  overlaps device compute via the feeder's async prefetch; the batched
  on-device rotate/scale perturbation lives in
  paddle_tpu/ops/perturbation.py, the hl_perturbation_util.cu analog);
- PIL-dependent helpers (jpeg decode, file loading, resize) degrade with a
  clear ImportError message instead of importing PIL at module scope.

Layout convention matches the reference: color images are CHW ndarrays
(K x H x W), grayscale are HW.
"""

from __future__ import annotations

import io
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "resize_image",
    "flip",
    "crop_img",
    "decode_jpeg",
    "preprocess_img",
    "load_meta",
    "load_image",
    "oversample",
    "ImageTransformer",
]


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover - PIL is in the base image
        raise ImportError(
            "PIL is required for jpeg/file image helpers "
            "(resize_image/decode_jpeg/load_image)"
        ) from e
    return Image


def resize_image(img, target_size: int):
    """Resize a PIL image so its SHORTER edge equals target_size
    (aspect-preserving, antialiased)."""
    Image = _pil_image()
    percent = target_size / float(min(img.size[0], img.size[1]))
    resized = (int(round(img.size[0] * percent)), int(round(img.size[1] * percent)))
    return img.resize(resized, Image.LANCZOS)


def flip(im: np.ndarray) -> np.ndarray:
    """Mirror an image along the horizontal (width) axis.

    Accepts CHW (K x H x W) or HW ndarrays — width is always the last
    axis under the module's layout convention.
    """
    return im[..., ::-1]


def _rng(rng):
    # None falls back to the module-level global stream (reference
    # behavior); providers should pass a per-file-seeded RandomState
    return np.random if rng is None else rng


def _randint(rng, low, high):
    """[low, high) draw working across the RandomState (randint) and
    Generator (integers) APIs."""
    fn = getattr(rng, "integers", None) or rng.randint
    return int(fn(low, high))


def crop_img(
    im: np.ndarray,
    inner_size: int,
    color: bool = True,
    test: bool = True,
    rng=None,
) -> np.ndarray:
    """Crop to inner_size x inner_size: center crop in test mode, random
    crop + 50% horizontal flip in train mode (test=False).

    Images smaller than inner_size are zero-padded to it first (centered),
    matching the reference's padding semantics. ``rng`` makes train-mode
    randomness explicit and reproducible.
    """
    im = np.asarray(im, dtype=np.float32)
    r = _rng(rng)
    spatial = im.shape[1:] if color else im.shape
    height, width = max(inner_size, spatial[0]), max(inner_size, spatial[1])
    if (height, width) != tuple(spatial):
        pad_shape = (im.shape[0], height, width) if color else (height, width)
        padded = np.zeros(pad_shape, dtype=np.float32)
        y0 = (height - spatial[0]) // 2
        x0 = (width - spatial[1]) // 2
        padded[..., y0 : y0 + spatial[0], x0 : x0 + spatial[1]] = im
        im = padded
    if test:
        start_y = (height - inner_size) // 2
        start_x = (width - inner_size) // 2
    else:
        start_y = _randint(r, 0, height - inner_size + 1)
        start_x = _randint(r, 0, width - inner_size + 1)
    pic = im[..., start_y : start_y + inner_size, start_x : start_x + inner_size]
    if not test and _randint(r, 0, 2) == 0:
        pic = flip(pic)
    return pic


def decode_jpeg(jpeg_string: bytes) -> np.ndarray:
    """Decode an encoded image byte string to a CHW (color) or HW
    (grayscale) ndarray."""
    Image = _pil_image()
    arr = np.array(Image.open(io.BytesIO(jpeg_string)))
    if arr.ndim == 3:
        arr = np.transpose(arr, (2, 0, 1))
    return arr


def preprocess_img(
    im: np.ndarray,
    img_mean: np.ndarray,
    crop_size: int,
    is_train: bool,
    color: bool = True,
    rng=None,
) -> np.ndarray:
    """Standard train/eval image pipeline: crop (random+flip when training,
    center otherwise), subtract the dataset mean, flatten to a feature
    vector. The reference's preprocess_img with explicit rng."""
    pic = crop_img(np.asarray(im, np.float32), crop_size, color, test=not is_train, rng=rng)
    pic = pic - np.asarray(img_mean, np.float32)
    return pic.ravel()


def load_meta(meta_path: str, mean_img_size: int, crop_size: int, color: bool = True) -> np.ndarray:
    """Load the dataset mean image from a meta file and center-crop it to
    crop_size so it aligns with cropped samples.

    Accepts either an .npz/npy-style file with a 'data_mean' entry (our
    converters write np.savez) or a pickled dict with 'data_mean' (the
    reference's cPickle batches.meta format).
    """
    try:
        mean = np.load(meta_path, allow_pickle=True)["data_mean"]
    except Exception:
        import pickle

        with open(meta_path, "rb") as f:
            mean = pickle.load(f, encoding="latin1")["data_mean"]
    mean = np.asarray(mean, np.float32)
    border = (mean_img_size - crop_size) // 2
    if color:
        assert mean.size == 3 * mean_img_size * mean_img_size, mean.shape
        mean = mean.reshape(3, mean_img_size, mean_img_size)
    else:
        assert mean.size == mean_img_size * mean_img_size, mean.shape
        mean = mean.reshape(mean_img_size, mean_img_size)
    return mean[..., border : border + crop_size, border : border + crop_size]


def load_image(img_path: str, is_color: bool = True):
    """Open an image file as a PIL image (converted to RGB or L)."""
    Image = _pil_image()
    img = Image.open(img_path)
    img.load()
    return img.convert("RGB" if is_color else "L")


def oversample(imgs: Sequence[np.ndarray], crop_dims: Tuple[int, int]) -> np.ndarray:
    """10-crop test-time augmentation: 4 corners + center, each mirrored.

    imgs: iterable of HWC ndarrays (the reference's oversample contract).
    Returns (10*N, crop_h, crop_w, K) float32.
    """
    im_shape = np.array(imgs[0].shape)
    crop_dims = np.array(crop_dims)
    center = im_shape[:2] / 2.0
    h_inds = (0, im_shape[0] - crop_dims[0])
    w_inds = (0, im_shape[1] - crop_dims[1])
    crops_ix = np.empty((5, 4), dtype=int)
    curr = 0
    for i in h_inds:
        for j in w_inds:
            crops_ix[curr] = (i, j, i + crop_dims[0], j + crop_dims[1])
            curr += 1
    crops_ix[4] = np.concatenate([center - crop_dims / 2.0, center + crop_dims / 2.0]).astype(int)
    out = np.empty((10 * len(imgs), crop_dims[0], crop_dims[1], im_shape[-1]), np.float32)
    ix = 0
    for im in imgs:
        for y0, x0, y1, x1 in crops_ix:
            out[ix] = im[y0:y1, x0:x1, :]
            ix += 1
        for k in range(5):
            out[ix] = out[ix - 5][:, ::-1, :]
            ix += 1
    return out


class ImageTransformer:
    """Composable inference-time transform: axis transpose, channel swap,
    mean subtraction (reference ImageTransformer contract)."""

    def __init__(self, transpose=None, channel_swap=None, mean=None, is_color: bool = True):
        self.is_color = is_color
        self.transpose = None
        self.channel_swap = None
        self.mean = None
        if transpose is not None:
            self.set_transpose(transpose)
        if channel_swap is not None:
            self.set_channel_swap(channel_swap)
        if mean is not None:
            self.set_mean(mean)

    def set_transpose(self, order):
        if self.is_color:
            assert len(order) == 3
        self.transpose = tuple(order)

    def set_channel_swap(self, order):
        if self.is_color:
            assert len(order) == 3
        self.channel_swap = tuple(order)

    def set_mean(self, mean):
        mean = np.asarray(mean, np.float32)
        if mean.ndim == 1:  # one value per channel
            mean = mean[:, np.newaxis, np.newaxis]
        elif self.is_color:
            assert mean.ndim == 3
        self.mean = mean

    def transformer(self, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data, np.float32)
        if self.transpose is not None:
            data = data.transpose(self.transpose)
        if self.channel_swap is not None:
            data = data[list(self.channel_swap), :, :]
        if self.mean is not None:
            data = data - self.mean
        return data
