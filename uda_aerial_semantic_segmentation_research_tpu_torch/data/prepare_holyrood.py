"""Prepare the Holyrood target-domain dataset from raw zip archives.

The port's copy of the JAX package's ``data/prepare_holyrood.py`` (stdlib
only): unzips the archives under ``data/raw/holyrood_october_2020`` into a
flat ``data/target/holyrood`` directory.  Idempotent (skips when the target
directory holds images), extracts into a temporary directory that it removes,
renames a file whose name is taken to ``<stem>_<n><suffix>`` (``n`` the count
of images moved so far), and skips dotfiles.

    python -m uda_aerial_semantic_segmentation_research_tpu_torch.data.prepare_holyrood
"""

from __future__ import annotations

import os
import shutil
import tempfile
import zipfile
from pathlib import Path

IMG_EXTS = (".jpg", ".jpeg", ".png", ".JPG", ".JPEG", ".PNG")


def prepare_holyrood_dataset(
        raw_dir: str = os.path.join("data", "raw", "holyrood_october_2020"),
        target_dir: str = os.path.join("data", "target", "holyrood")) -> int:
    """Flatten all images from the raw zips into ``target_dir``.

    Returns the number of images available in ``target_dir``.
    """
    target = Path(target_dir)
    target.mkdir(parents=True, exist_ok=True)

    existing = [f for f in target.iterdir() if f.suffix in IMG_EXTS]
    if existing:
        print(f"Holyrood dataset already prepared ({len(existing)} images); skipping")
        return len(existing)

    raw = Path(raw_dir)
    zips = sorted(raw.glob("*.zip")) if raw.exists() else []
    if not zips:
        print(f"No raw archives found under {raw_dir}; nothing to prepare")
        return 0

    n = 0
    tmp_root = tempfile.mkdtemp(prefix="holyrood_")
    try:
        for z in zips:
            with zipfile.ZipFile(z) as zf:
                zf.extractall(tmp_root)
        for root, _, files in os.walk(tmp_root):
            for f in files:
                if Path(f).suffix in IMG_EXTS and not f.startswith("."):
                    src = Path(root) / f
                    dst = target / f
                    if dst.exists():
                        dst = target / f"{Path(f).stem}_{n}{Path(f).suffix}"
                    shutil.move(str(src), str(dst))
                    n += 1
    finally:
        shutil.rmtree(tmp_root, ignore_errors=True)

    print(f"Prepared {n} Holyrood images at {target_dir}")
    return n


if __name__ == "__main__":
    prepare_holyrood_dataset()
