"""Image-folder input pipeline of the port, host numpy and PIL
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/data/generators.py).

Ported: ``load_image`` (the PIL branch, :46-55; the JAX package's native
decoder is bit-identical to it), ``SegmentationFolderDataset`` (:58),
``split_dataset`` (:115), ``PrefetchLoader`` (:125) with on-the-fly
augmentation and patchify, and ``augment_pair`` with ``_warp_pair``
(:261-315; OpenCV imported when a pair is warped).
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import typing as tp

import numpy as np

from .patch import create_patches

_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def _list_images(directory: str) -> tp.List[str]:
    return sorted(os.path.join(directory, f) for f in os.listdir(directory)
                  if f.lower().endswith(_EXTS))


def load_image(path: str, size: tp.Tuple[int, int], color_mode: str,
               resample: str = "lanczos", norm: float = 1.0) -> np.ndarray:
    """Load, convert ('grayscale' or RGB), resize to ``size`` = (H, W)
    (lanczos for images, nearest for masks: DataGenerator.py:68-77) and
    divide by ``norm``.  Returns float32 (H, W, C)."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("L" if color_mode == "grayscale" else "RGB")
        if img.size != (size[1], size[0]):
            method = Image.LANCZOS if resample == "lanczos" else Image.NEAREST
            img = img.resize((size[1], size[0]), method)
        arr = np.asarray(img, np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr if norm == 1.0 else arr / np.float32(norm)


class SegmentationFolderDataset:
    """Paired image/mask folder dataset with the reference's layout
    (``{dir}/images``, ``{dir}/masks`` or ``img``/``msk``)."""

    def __init__(self, directory: str, image_size: tp.Tuple[int, int],
                 image_color_mode: str = "rgb",
                 mask_color_mode: str = "grayscale",
                 normalizing_factor_img: float = 255.0,
                 normalizing_factor_msk: float = 255.0):
        cands = [(os.path.join(directory, "images"),
                  os.path.join(directory, "masks")),
                 (os.path.join(directory, "img"),
                  os.path.join(directory, "msk"))]
        for img_dir, msk_dir in cands:
            if os.path.isdir(img_dir) and os.path.isdir(msk_dir):
                break
        else:
            raise FileNotFoundError(
                f"no images/masks (or img/msk) subdirs under {directory}")
        self.image_paths = _list_images(img_dir)
        self.mask_paths = _list_images(msk_dir)
        if len(self.image_paths) != len(self.mask_paths):  # DataGenerator.py:31
            raise ValueError(f"image/mask count mismatch under {directory}: "
                             f"{len(self.image_paths)} images, "
                             f"{len(self.mask_paths)} masks")
        self.image_size = image_size
        self.image_color_mode = image_color_mode
        self.mask_color_mode = mask_color_mode
        self.nf_img = normalizing_factor_img
        self.nf_msk = normalizing_factor_msk

    def __len__(self) -> int:
        return len(self.image_paths)

    def load_pair(self, idx: int) -> tp.Tuple[np.ndarray, np.ndarray]:
        img = load_image(self.image_paths[idx], self.image_size,
                         self.image_color_mode, "lanczos", self.nf_img)
        msk = load_image(self.mask_paths[idx], self.image_size,
                         self.mask_color_mode, "nearest", self.nf_msk)
        return img, msk


class SubsetDataset:
    """Index-subset view of a dataset (the validation_portion split)."""

    def __init__(self, base: SegmentationFolderDataset,
                 indices: tp.Sequence[int]):
        self.base = base
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def load_pair(self, idx: int) -> tp.Tuple[np.ndarray, np.ndarray]:
        return self.base.load_pair(self.indices[idx])


def split_dataset(ds: SegmentationFolderDataset, val_portion: float,
                  seed: int = 1) -> tp.Tuple[SubsetDataset, SubsetDataset]:
    """Random (train, val) split by portion."""
    n = len(ds)
    order = np.random.default_rng(seed).permutation(n)
    n_val = int(n * val_portion)
    return (SubsetDataset(ds, order[n_val:]),
            SubsetDataset(ds, order[:n_val]))


class PrefetchLoader:
    """Threaded batch loader: ``__call__`` returns a fresh epoch iterator
    of NHWC (images, masks) float32 batches.  Every decode is its own pool
    task, and ``prefetch_batches`` batches' worth of decodes stay in
    flight ahead of the consumer.  The shuffle of epoch e is
    ``default_rng(seed + e)``, as in the JAX package, so both give the
    same batches in the same order.  ``cache`` keeps decoded pairs in RAM
    after their first epoch.  ``augment`` runs ``augment_pair`` on each
    decoded pair with ``default_rng((seed, e + 1, index))`` in the epoch
    shuffled with ``seed + e``, as the JAX loader does; ``patchify``
    then cuts image and mask into ``patch_shape`` patches
    (``create_patches``), all of a pair's patches in its batch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 1, num_workers: int = 4,
                 prefetch_batches: int = 2, drop_remainder: bool = False,
                 cache: bool = False, augment: bool = False,
                 patchify: bool = False,
                 patch_shape: tp.Tuple[int, int] = (64, 64),
                 overlap_ratio: float = 0.0):
        self.augment = augment
        self.patchify = patchify
        self.patch_shape = patch_shape
        self.overlap_ratio = overlap_ratio
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch_batches = max(prefetch_batches, 1)
        self.drop_remainder = drop_remainder
        self.cache = cache
        self._cached: tp.Dict[int, tp.Tuple[np.ndarray, np.ndarray]] = {}
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Fast-forward the epoch counter (exact resume): the shuffle and
        the augmentation are keyed by (seed, epoch), so a resumed run sees
        the data the uninterrupted run would have seen."""
        self._epoch = int(epoch)

    def _load_one(self, i: int, epoch: int
                  ) -> tp.Tuple[np.ndarray, np.ndarray]:
        if self.cache and i in self._cached:
            img, msk = self._cached[i]
        else:
            img, msk = self.ds.load_pair(i)
            if self.cache:
                # dict writes are atomic under the GIL; two threads may
                # both decode one index, and either result is right
                self._cached[i] = (img, msk)
        if self.augment:
            img, msk = augment_pair(
                img, msk, np.random.default_rng((self.seed, epoch, i)))
        if self.patchify:
            return (create_patches(img, self.patch_shape,
                                   self.overlap_ratio)[0],
                    create_patches(msk, self.patch_shape,
                                   self.overlap_ratio)[0])
        return img[None], msk[None]

    def __call__(self) -> tp.Iterator[tp.Tuple[np.ndarray, np.ndarray]]:
        n = len(self.ds)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        self._epoch += 1
        # the JAX loader's decode tasks read the counter after this
        # increment: the augmentation of the epoch shuffled with
        # seed + e is keyed by e + 1
        epoch = self._epoch
        stop = n - (n % self.batch_size) if self.drop_remainder else n
        batches = [idx[s:s + self.batch_size]
                   for s in range(0, stop, self.batch_size)]
        if not batches:
            raise ValueError(
                f"PrefetchLoader yields no batches: dataset has {n} "
                f"example(s) and batch_size={self.batch_size}"
                + (" with drop_remainder=True (accumulation requires "
                   "full batches); shrink batch_size or add data"
                   if self.drop_remainder and n else ""))
        return self._iterate(batches, epoch)

    def _iterate(self, batches: tp.List[np.ndarray], epoch: int
                 ) -> tp.Iterator[tp.Tuple[np.ndarray, np.ndarray]]:
        flat = [int(i) for b in batches for i in b]
        window = self.batch_size * self.prefetch_batches
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            futures: tp.Dict[int, cf.Future] = {
                j: pool.submit(self._load_one, flat[j], epoch)
                for j in range(min(window, len(flat)))}
            pos = 0
            for b in batches:
                parts = []
                for _ in b:
                    parts.append(futures.pop(pos).result())
                    nxt = pos + window
                    if nxt < len(flat):
                        futures[nxt] = pool.submit(self._load_one,
                                                   flat[nxt], epoch)
                    pos += 1
                yield (np.concatenate([p[0] for p in parts], 0),
                       np.concatenate([p[1] for p in parts], 0))


def _warp_pair(img: np.ndarray, msk: np.ndarray, angle: float,
               scale: float, tx: float, ty: float
               ) -> tp.Tuple[np.ndarray, np.ndarray]:
    """One affine (rotation about the centre, scale, shift as fractions of
    the canvas) on both arrays: bilinear for the image, nearest for the
    mask so its label values survive, reflect-101 borders (JAX
    generators.py:261-280)."""
    import cv2

    h, w = img.shape[:2]
    mat = cv2.getRotationMatrix2D((w / 2.0, h / 2.0), angle, scale)
    mat[0, 2] += tx * w
    mat[1, 2] += ty * h
    kw = dict(dsize=(w, h), borderMode=cv2.BORDER_REFLECT_101)
    img_w = cv2.warpAffine(img, mat, flags=cv2.INTER_LINEAR, **kw)
    msk_w = cv2.warpAffine(msk, mat, flags=cv2.INTER_NEAREST, **kw)
    # cv2 drops a singleton channel axis
    if img_w.ndim == 2:
        img_w = img_w[..., None]
    if msk_w.ndim == 2:
        msk_w = msk_w[..., None]
    return img_w, msk_w


def augment_pair(img: np.ndarray, msk: np.ndarray, rng: np.random.Generator
                 ) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Geometric and photometric augmentation of one image/mask pair, with
    the draws of the JAX package's ``augment_pair`` (generators.py:283)
    from ``rng`` in the same order: horizontal and vertical flips, rot90
    on square inputs, shift-scale-rotate (+-30 degrees, scale 0.9-1.1,
    shift +-6.25%), brightness and contrast on the image only.  The mask
    takes every geometric op with nearest sampling."""
    if rng.random() < 0.5:
        img, msk = img[:, ::-1], msk[:, ::-1]
    if rng.random() < 0.5:
        img, msk = img[::-1], msk[::-1]
    k = int(rng.integers(0, 4))
    if k and img.shape[0] == img.shape[1]:
        img, msk = np.rot90(img, k), np.rot90(msk, k)
    if rng.random() < 0.5:
        img, msk = _warp_pair(
            np.ascontiguousarray(img, np.float32),
            np.ascontiguousarray(msk, np.float32),
            angle=float(rng.uniform(-30.0, 30.0)),
            scale=float(rng.uniform(0.9, 1.1)),
            tx=float(rng.uniform(-0.0625, 0.0625)),
            ty=float(rng.uniform(-0.0625, 0.0625)))
    if rng.random() < 0.3:
        hi = 255.0 if img.max() > 1.0 else 1.0  # raw 0-255 or normalized
        img = np.clip(img * rng.uniform(0.8, 1.2)
                      + rng.uniform(-0.05, 0.05) * hi, 0.0, hi)
    return (np.ascontiguousarray(img, np.float32),
            np.ascontiguousarray(msk, np.float32))
