"""Image transforms + mixup/cutmix (timm-free numpy implementations).

The reference builds its pipeline with timm's create_transform
(mvuld/data/build.py:127-170): train = RandomResizedCrop + AutoAugment
(rand-m9-mstd0.5-inc1) + color-jitter 0.4 + RandomErasing 0.25; eval = resize
(bicubic) + normalize(ImageNet). timm is unavailable here, so this module
implements the same pipeline in numpy/PIL: random-resized-crop, flip,
color-jitter, a rand-augment subset (the geometric + color ops that matter
for synthetic graph renders), random erasing, and batch-level mixup/cutmix
(AUG.MIXUP=0.8 / CUTMIX=1.0 / switch 0.5, mvuld/config.py AUG block).

The port's copy imports PIL inside the functions that use it, so the
package imports on a machine without it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_image(path: str) -> Image.Image:
    from PIL import Image
    return Image.open(path).convert("RGB")


def resize_normalize(img: Image.Image, size: int) -> np.ndarray:
    """Eval path (build.py:152-162): bicubic resize + ImageNet normalize,
    NHWC float32."""
    from PIL import Image
    img = img.resize((size, size), Image.BICUBIC)
    x = np.asarray(img, np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def random_resized_crop(img: Image.Image, size: int,
                        rng: np.random.RandomState,
                        scale: Tuple[float, float] = (0.08, 1.0),
                        ratio: Tuple[float, float] = (3 / 4, 4 / 3)) -> Image.Image:
    from PIL import Image
    W, H = img.size
    area = W * H
    for _ in range(10):
        target = rng.uniform(*scale) * area
        log_r = rng.uniform(np.log(ratio[0]), np.log(ratio[1]))
        r = np.exp(log_r)
        w = int(round(np.sqrt(target * r)))
        h = int(round(np.sqrt(target / r)))
        if 0 < w <= W and 0 < h <= H:
            x0 = rng.randint(0, W - w + 1)
            y0 = rng.randint(0, H - h + 1)
            return img.crop((x0, y0, x0 + w, y0 + h)).resize((size, size),
                                                             Image.BICUBIC)
    return img.resize((size, size), Image.BICUBIC)


def color_jitter(img: Image.Image, rng: np.random.RandomState,
                 strength: float = 0.4) -> Image.Image:
    from PIL import ImageEnhance
    for enh in (ImageEnhance.Brightness, ImageEnhance.Contrast,
                ImageEnhance.Color):
        factor = 1.0 + rng.uniform(-strength, strength)
        img = enh(img).enhance(max(factor, 0.0))
    return img


# The FULL rand-m9-mstd0.5-inc1 op set (timm _RAND_INCREASING_TRANSFORMS;
# reference policy string at mvuld/config.py AUG.AUTO_AUGMENT, applied by
# create_transform in build.py:127-170). 15 ops, 2 layers, each op applied
# with prob 0.5; magnitude ~ N(9, mstd=0.5) clipped to [0, 10]; "increasing"
# variants scale their effect UP with magnitude. Fill is white (graph
# renders have white background; timm's gray mean-fill would paint
# out-of-canvas regions darker than any real render).
_RAND_AUG_OPS = ("auto_contrast", "equalize", "invert", "rotate",
                 "posterize", "solarize", "solarize_add", "color",
                 "contrast", "brightness", "sharpness", "shear_x", "shear_y",
                 "translate_x", "translate_y")
_FILL = (255, 255, 255)


def _solarize_add(img: Image.Image, add: int, thresh: int = 128) -> Image.Image:
    from PIL import Image
    x = np.asarray(img, np.int32)
    x = np.where(x < thresh, np.clip(x + add, 0, 255), x)
    return Image.fromarray(x.astype(np.uint8))


def rand_augment(img: Image.Image, rng: np.random.RandomState,
                 num_ops: int = 2, magnitude: int = 9,
                 mstd: float = 0.5, prob: float = 0.5) -> Image.Image:
    """Full rand-m9-mstd0.5-inc1 policy (timm RandAugment semantics)."""
    from PIL import Image, ImageEnhance, ImageOps
    for _ in range(num_ops):
        if rng.rand() > prob:
            continue
        op = _RAND_AUG_OPS[rng.randint(len(_RAND_AUG_OPS))]
        level = float(np.clip(rng.normal(magnitude, mstd), 0, 10))
        m = level / 10.0
        sign = 1.0 if rng.rand() < 0.5 else -1.0
        if op == "auto_contrast":
            img = ImageOps.autocontrast(img)
        elif op == "equalize":
            img = ImageOps.equalize(img)
        elif op == "invert":
            img = ImageOps.invert(img)
        elif op == "rotate":
            img = img.rotate(m * 30 * sign, resample=Image.BICUBIC,
                             fillcolor=_FILL)
        elif op == "posterize":
            # PosterizeIncreasing: more magnitude → fewer bits kept
            img = ImageOps.posterize(img, max(4 - int(m * 4), 1))
        elif op == "solarize":
            # SolarizeIncreasing: more magnitude → lower threshold
            img = ImageOps.solarize(img, int(256 - m * 256))
        elif op == "solarize_add":
            img = _solarize_add(img, int(m * 110))
        elif op in ("color", "contrast", "brightness", "sharpness"):
            # *Increasing enhance ops: factor = 1 ± 0.9·m
            enh = {"color": ImageEnhance.Color,
                   "contrast": ImageEnhance.Contrast,
                   "brightness": ImageEnhance.Brightness,
                   "sharpness": ImageEnhance.Sharpness}[op]
            img = enh(img).enhance(max(1.0 + sign * m * 0.9, 0.0))
        else:                       # shear / relative translate
            W, H = img.size
            v = sign * m * (0.3 if "shear" in op else 0.45)
            if op == "shear_x":
                mat = (1, v, 0, 0, 1, 0)
            elif op == "shear_y":
                mat = (1, 0, 0, v, 1, 0)
            elif op == "translate_x":
                mat = (1, 0, v * W, 0, 1, 0)
            else:
                mat = (1, 0, 0, 0, 1, v * H)
            img = img.transform((W, H), Image.AFFINE, mat,
                                resample=Image.BICUBIC, fillcolor=_FILL)
    return img


def random_erasing(x: np.ndarray, rng: np.random.RandomState,
                   prob: float = 0.25, scale: Tuple[float, float] = (0.02, 1 / 3),
                   mode: str = "pixel") -> np.ndarray:
    """RandomErasing (AUG.REPROB=0.25, REMODE='pixel') on a normalized HWC."""
    if rng.rand() > prob:
        return x
    H, W, C = x.shape
    area = H * W
    for _ in range(10):
        target = rng.uniform(*scale) * area
        r = np.exp(rng.uniform(np.log(0.3), np.log(1 / 0.3)))
        h = int(round(np.sqrt(target * r)))
        w = int(round(np.sqrt(target / r)))
        if h < H and w < W:
            y0 = rng.randint(0, H - h)
            x0 = rng.randint(0, W - w)
            if mode == "pixel":
                x[y0:y0 + h, x0:x0 + w] = rng.randn(h, w, C).astype(np.float32)
            else:
                x[y0:y0 + h, x0:x0 + w] = 0.0
            return x
    return x


def train_transform(img: Image.Image, size: int, rng: np.random.RandomState,
                    color_jitter_strength: float = 0.4,
                    reprob: float = 0.25) -> np.ndarray:
    from PIL import Image
    img = random_resized_crop(img, size, rng)
    if rng.rand() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    img = rand_augment(img, rng)
    img = color_jitter(img, rng, color_jitter_strength)
    x = np.asarray(img, np.float32) / 255.0
    x = (x - IMAGENET_MEAN) / IMAGENET_STD
    return random_erasing(x, rng, prob=reprob)


def mixup_cutmix(images: np.ndarray, labels: np.ndarray, num_classes: int,
                 rng: np.random.RandomState, mixup_alpha: float = 0.8,
                 cutmix_alpha: float = 1.0, prob: float = 1.0,
                 switch_prob: float = 0.5, label_smoothing: float = 0.1
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Batch-level mixup/cutmix producing soft targets (timm Mixup
    semantics; reference uses mixup_fn in train_one_epoch, main.py:267-269).
    Label smoothing is folded into the soft target like timm does."""
    B = images.shape[0]
    off = label_smoothing / num_classes
    on = 1.0 - label_smoothing + off
    y = np.full((B, num_classes), off, np.float32)
    y[np.arange(B), labels] = on
    if rng.rand() > prob:
        return images, y
    perm = rng.permutation(B)
    use_cutmix = cutmix_alpha > 0 and rng.rand() < switch_prob
    if use_cutmix:
        lam = rng.beta(cutmix_alpha, cutmix_alpha)
        H, W = images.shape[1:3]
        rh, rw = int(H * np.sqrt(1 - lam)), int(W * np.sqrt(1 - lam))
        cy, cx = rng.randint(H), rng.randint(W)
        y0, y1 = np.clip(cy - rh // 2, 0, H), np.clip(cy + rh // 2, 0, H)
        x0, x1 = np.clip(cx - rw // 2, 0, W), np.clip(cx + rw // 2, 0, W)
        images = images.copy()
        images[:, y0:y1, x0:x1] = images[perm, y0:y1, x0:x1]
        lam = 1.0 - (y1 - y0) * (x1 - x0) / (H * W)
    else:
        lam = rng.beta(mixup_alpha, mixup_alpha) if mixup_alpha > 0 else 1.0
        images = lam * images + (1 - lam) * images[perm]
    y = lam * y + (1 - lam) * y[perm]
    return images.astype(np.float32), y
