"""Zip-backed image folder dataset + strided subset sampling.

A copy of ``mvuld_tpu/data/zip_folder.py`` (host code: zipfile, numpy, and
PIL imported where an image is decoded); items are what the JAX dataset
gives, (image, int label) with the image after ``transform``.

Equivalent of the reference's ImageNet plumbing (reference:
mvuld/data/cached_image_folder.py:209 CachedImageFolder, zipreader.py:23
ZipReader, samplers.py:11 SubsetRandomSampler): images live inside a zip
archive next to an annotation map file ("member_path label" lines); CACHE_MODE
∈ {none, part, full} controls whether decoded bytes are memoized. Used for
ImageNet-format pretraining data (DATA.ZIP_MODE).
"""

from __future__ import annotations

import io
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np


class ZipReader:
    """Process-wide zip handle cache (reference: zipreader.py)."""

    _handles: Dict[str, zipfile.ZipFile] = {}

    @classmethod
    def get(cls, path: str) -> zipfile.ZipFile:
        if path not in cls._handles:
            cls._handles[path] = zipfile.ZipFile(path, "r")
        return cls._handles[path]

    @classmethod
    def read(cls, zip_path: str, member: str) -> bytes:
        return cls.get(zip_path).read(member)


class CachedZipImageFolder:
    """(image, label) dataset over a zip archive.

    ``ann_file``: text file of "member_path label" lines (the reference's
    map files). cache_mode: "none" decodes every access; "part" caches a
    strided shard (rank::world); "full" caches everything.
    """

    def __init__(self, zip_path: str, ann_file: str, cache_mode: str = "part",
                 rank: int = 0, world_size: int = 1, transform=None):
        self.zip_path = zip_path
        self.transform = transform
        self.samples: List[Tuple[str, int]] = []
        with open(ann_file) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                member, label = line.rsplit(" ", 1)
                self.samples.append((member, int(label)))
        self.cache_mode = cache_mode
        self._cache: Dict[int, bytes] = {}
        if cache_mode in ("part", "full"):
            stride = world_size if cache_mode == "part" else 1
            offset = rank if cache_mode == "part" else 0
            for i in range(offset, len(self.samples), stride):
                self._cache[i] = ZipReader.read(zip_path, self.samples[i][0])

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int):
        from PIL import Image
        member, label = self.samples[idx]
        data = self._cache.get(idx)
        if data is None:
            data = ZipReader.read(self.zip_path, member)
        img = Image.open(io.BytesIO(data)).convert("RGB")
        if self.transform is not None:
            img = self.transform(img)
        return img, label


def subset_strided_indices(n: int, rank: int, world_size: int,
                           shuffle_seed: Optional[int] = None) -> np.ndarray:
    """Strided index shard (reference: SubsetRandomSampler usage,
    build.py:56-58): indices rank::world_size, optionally shuffled."""
    idx = np.arange(rank, n, world_size)
    if shuffle_seed is not None:
        np.random.RandomState(shuffle_seed).shuffle(idx)
    return idx


class IN22KDataset:
    """ImageNet-22K dataset over a JSON annotation database (reference:
    mvuld/data/imagenet22k_dataset.py:12 IN22KDATASET).

    ``ann_file`` is a JSON list of ``[relative_image_path, class_index]``
    pairs under ``root``. Unreadable images degrade to a random 224² RGB
    image rather than aborting an epoch (reference behavior — multi-day
    22K pretraining must survive corrupt files)."""

    def __init__(self, root: str, ann_file: str = "", transform=None,
                 target_transform=None):
        import json
        import os
        self.data_path = root
        self.ann_path = os.path.join(root, ann_file)
        self.transform = transform
        self.target_transform = target_transform
        with open(self.ann_path) as f:
            self.database = json.load(f)

    def _load_image(self, path: str):
        from PIL import Image
        try:
            return Image.open(path)
        except Exception:
            print("ERROR IMG LOADED: ", path)
            rand = (np.random.rand(224, 224, 3) * 255).astype(np.uint8)
            return Image.fromarray(rand)

    def __getitem__(self, index: int):
        idb = self.database[index]
        img = self._load_image(self.data_path + "/" + idb[0]).convert("RGB")
        if self.transform is not None:
            img = self.transform(img)
        target = int(idb[1])
        if self.target_transform is not None:
            target = self.target_transform(target)
        return img, target

    def __len__(self) -> int:
        return len(self.database)
