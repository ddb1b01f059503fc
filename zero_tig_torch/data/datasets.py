"""Sequential video-frame datasets.

Port of ``zero_tig_tpu/data/datasets.py`` (:1-314; reference
dataloader/multi_read_data.py + dataloader/create_data.py). Loaders yield
frames in temporal order per scene, each resized to the target size
(1920x1080 by default, multi_read_data.py:129). Each record carries an
``is_new_seq`` flag with the semantics of the reference's
``sequential_judgment`` (utils/utils.py:145-160), quirks kept: the very
first record compares against itself, so it is a new sequence, and the
previous path persists across epochs (``_last_path``, :91, :149-150,
:189-190). The generic recursive loader stands in for the reference's
broken ``DefaultDataset`` (multi_read_data.py:29-71).

Frames decode through the port's own PNG codec (``native``); JPEG frames,
and the reference's Pillow bicubic resize of a frame that is not at the
target size (multi_read_data.py:127-132), go through Pillow, which is
imported only then. ``ZERO_TIG_NATIVE_IO=1`` in the environment puts
the native C++ frame pipeline (``native.frameio``: libpng and libjpeg,
OpenCV's bicubic for off-size frames, threads decoding ahead) under
``iter_u8`` and ``load_image``, as in the JAX package (:84-102, :168-180);
where it cannot be built, the dataset raises. The JAX package's OpenCV
opt-in (``ZERO_TIG_CV2_RESIZE``) has no counterpart.
"""

from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from .. import native
from ..native import frameio


@dataclass
class FrameRecord:
    image: np.ndarray  # (H, W, 3) RGB: float32 in [0, 1] from __iter__, uint8 from iter_u8
    name: str  # file stem
    path: str
    is_new_seq: bool


def extract_number(filename: str) -> int:
    stem = os.path.splitext(os.path.split(filename)[1])[0]
    m = re.search(r"\d+", stem)
    return int(m.group()) if m else 0


def sort_files_by_name(paths: list[str]) -> list[str]:
    return sorted(paths, key=extract_number)


def sequential_judgment(img_path: str, last_img_path: str) -> bool:
    """New-sequence detector (utils/utils.py:145-160): the same directory and
    a numeric stem one past the last one continue a sequence; anything else
    starts one. Non-numeric stems count as their first number, or 0."""
    img_dir, img_name = os.path.split(img_path)
    last_dir, last_name = os.path.split(last_img_path)
    if img_dir != last_dir:
        return True
    try:
        img_idx = int(os.path.splitext(img_name)[0])
        last_idx = int(os.path.splitext(last_name)[0])
    except ValueError:
        img_idx = extract_number(img_name)
        last_idx = extract_number(last_name)
    return img_idx != last_idx + 1


class FrameDataset:
    """Ordered frame-path list + stateful sequential iteration."""

    name = "generic"

    def __init__(self, paths: list[str], *, size: tuple[int, int] = (1920, 1080)):
        if not paths:
            raise ValueError("dataset is empty")
        self.paths = paths
        self.size = size  # (W, H)
        self._last_path = paths[0]  # persists across epochs (reference quirk)
        self.native_io = os.environ.get("ZERO_TIG_NATIVE_IO", "0") == "1"
        if self.native_io:
            frameio.library()  # built here: a dataset that cannot read its frames fails at once

    def __len__(self) -> int:
        return len(self.paths)

    def load_image_u8(self, path: str) -> np.ndarray:
        """The frame as (H, W, 3) uint8 RGB at ``size``."""
        img = native.read_rgb(path)
        if (img.shape[1], img.shape[0]) != tuple(self.size):
            img = native.resize_bicubic_pil(img, tuple(self.size))
        return img

    def load_image(self, path: str) -> np.ndarray:
        if self.native_io:
            return frameio.load_frame(path, *self.size)
        return self.load_image_u8(path).astype(np.float32) / 255.0

    def _records(self, images) -> Iterator[FrameRecord]:
        for path, image in zip(self.paths, images):
            is_new = sequential_judgment(path, self._last_path)
            self._last_path = path
            yield FrameRecord(
                image=image,
                name=os.path.splitext(os.path.basename(path))[0],
                path=path,
                is_new_seq=is_new,
            )

    def __iter__(self) -> Iterator[FrameRecord]:
        return self._records(map(self.load_image, self.paths))

    def iter_u8(self) -> Iterator[FrameRecord]:
        """Like ``__iter__``, the images left uint8: the prefetcher ships them
        so and normalises on the device. With native IO, the C++ pipeline
        decodes ahead on the host's cores."""
        if not self.native_io:
            return self._records(map(self.load_image_u8, self.paths))
        return self._native_records()

    def _native_records(self) -> Iterator[FrameRecord]:
        pipe = frameio.NativePipeline(self.paths, *self.size, threads=max(os.cpu_count() or 1, 1), out_u8=True)
        try:
            yield from self._records(pipe)
        finally:
            pipe.close()


def _check_task(task: str) -> None:
    if task not in ("train", "test"):
        raise ValueError(f"Invalid phase: {task}")


def _read_phase_list(root: str, list_file: str) -> list[str]:
    with open(os.path.join(root, list_file)) as f:
        lines = [ln.strip() for ln in f.readlines()]
    scenes = [ln for ln in lines if ln]
    if not scenes:
        raise ValueError(f"No input data in {list_file}.")
    return scenes


class RLVDataset(FrameDataset):
    """BVI-RLV: input/<scene>/low_light_{10,20}/*.png per {train,test}_list.txt.

    Parity: RLVDataLoader (multi_read_data.py:74-147).
    """

    name = "BVI-RLV"

    def __init__(self, root: str, task: str, **kw):
        _check_task(task)
        paths: list[str] = []
        for scene in _read_phase_list(root, f"{task}_list.txt"):
            for sub in ("low_light_10", "low_light_20"):
                paths.extend(
                    sort_files_by_name(
                        glob.glob(os.path.join(root, "input", scene, sub, "*.png"))
                    )
                )
        super().__init__(paths, **kw)


class DIDDataset(FrameDataset):
    """DID: input/<scene>/*.{jpg,png}. Parity: DidDataloader
    (multi_read_data.py:150-210)."""

    name = "DID"

    def __init__(self, root: str, task: str, **kw):
        _check_task(task)
        paths: list[str] = []
        for scene in _read_phase_list(root, f"{task}_list.txt"):
            files = glob.glob(os.path.join(root, "input", scene, "*.jpg"))
            files += glob.glob(os.path.join(root, "input", scene, "*.png"))
            paths.extend(sort_files_by_name(files))
        super().__init__(paths, **kw)


class SDSDDataset(FrameDataset):
    """SDSD: indoor/outdoor auto-detect, one low-light frame per pair dir.

    Parity: SDSDDataloader (multi_read_data.py:213-335).
    """

    name = "SDSD"

    def __init__(self, root: str, task: str, **kw):
        _check_task(task)
        paths: list[str] = []
        for subset, prefix in (("indoor", "in"), ("outdoor", "out")):
            subset_dir = os.path.join(root, subset, f"{subset}_png")
            list_path = os.path.join(root, f"sdsd_{prefix}_{task}.txt")
            if not (os.path.isdir(subset_dir) and os.path.exists(list_path)):
                continue
            subset_paths = []
            with open(list_path) as f:
                pairs = f.read().splitlines()
            for line in pairs:
                pair = line.strip()
                if not pair:
                    continue
                pair_dir = os.path.join(subset_dir, pair)
                if not os.path.isdir(pair_dir):
                    continue
                files = glob.glob(os.path.join(pair_dir, "*.png"))
                files += glob.glob(os.path.join(pair_dir, "*.jpg"))
                low = next(
                    (
                        f
                        for f in files
                        if "gt" not in f.lower() and "normal" not in f.lower()
                    ),
                    files[0] if files else None,
                )
                if low:
                    subset_paths.append(low)
            paths.extend(sort_files_by_name(subset_paths))
        super().__init__(paths, **kw)


class GenericDataset(FrameDataset):
    """Recursive walk of an input directory (the *fixed* underwater/default
    loader -- the reference's is broken, multi_read_data.py:29-71)."""

    name = "generic"

    def __init__(self, root: str, task: str = "train", **kw):
        if not os.path.exists(root):
            raise FileNotFoundError(f"Input directory does not exist: {root}")
        paths = []
        for r, _dirs, names in os.walk(root):
            for n in sorted(names):
                if n.startswith("."):
                    continue
                if os.path.splitext(n)[1].lower() in (".png", ".jpg", ".jpeg", ".bmp"):
                    paths.append(os.path.join(r, n))
        super().__init__(sort_files_by_name(paths), **kw)


def create_dataset(
    dataset: str,
    root: str,
    task: str,
    *,
    size: tuple[int, int] = (1920, 1080),
) -> FrameDataset:
    """Dataset factory. Parity: CreateDataset (dataloader/create_data.py:3-18)."""
    if dataset in ("lowlight_dataset", "RLV", "BVI-RLV"):
        return RLVDataset(root, task, size=size)
    if dataset in ("DID", "DID_1080"):
        return DIDDataset(root, task, size=size)
    if dataset in ("SDSD", "3_SDSD"):
        return SDSDDataset(root, task, size=size)
    return GenericDataset(root, task, size=size)


def gt_path_for(input_path: str) -> str:
    """GT located by path convention (evals.py:133)."""
    return input_path.replace("input", "gt").replace("low_light_", "normal_light_")
