"""Prepare the Oxford-IIIT Pet dataset into the framework's layout.

Counterpart of the JAX repository's scripts/prepare_oxford_pet.py (the
same split, the same files). Input: a standard Oxford-IIIT Pet download,

    {src}/images/*.jpg                 (7349 photos)
    {src}/annotations/trimaps/*.png    (1=pet, 2=background, 3=border)
    {src}/annotations/list.txt         (name class_id species breed_id;
                                        species 1=cat 2=dog)

Output: {dst}/{Train,Val,Test}/{color,label}/, the photos copied as they
are and class-id label PNGs: 0 background, 1 cat, 2 dog, 255 boundary.

Species comes from list.txt when present, else from the filename
convention (cat breeds are Capitalised). The split is a permutation of
the sorted stems by `numpy.random.default_rng(seed)`.

  python -m image_segmentation_tpu_torch.scripts.prepare_oxford_pet \
      --src /data/oxford-iiit-pet --dst /data/pet [--val 0.1 --test 0.1 --seed 0]
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np
from PIL import Image


def species_map_from_list(list_path: str) -> dict:
    """stem -> 1 (cat) | 2 (dog) from annotations/list.txt ({} without it)."""
    mapping = {}
    if not os.path.exists(list_path):
        return mapping
    with open(list_path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) >= 3:
                mapping[parts[0]] = int(parts[2])
    return mapping


def species_from_name(stem: str) -> int:
    """Capitalised breed names are cats in the Pet naming convention."""
    return 1 if stem[:1].isupper() else 2


def trimap_to_classes(trimap: np.ndarray, species: int) -> np.ndarray:
    """1=pet, 2=background, 3=border → 0 bg / species (1 cat, 2 dog) /
    255 boundary."""
    out = np.zeros(trimap.shape, np.uint8)
    out[trimap == 1] = species
    out[trimap == 3] = 255
    return out


def split_stems(stems, val: float, test: float, seed: int) -> dict:
    """{'Test', 'Val', 'Train'} → stems: the first int(n·test) of a seeded
    permutation are Test, the next int(n·val) Val, the rest Train."""
    order = np.random.default_rng(seed).permutation(len(stems))
    n_test, n_val = int(len(stems) * test), int(len(stems) * val)
    return {"Test": [stems[i] for i in order[:n_test]],
            "Val": [stems[i] for i in order[n_test:n_test + n_val]],
            "Train": [stems[i] for i in order[n_test + n_val:]]}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m image_segmentation_tpu_torch.scripts."
                                     "prepare_oxford_pet")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--val", type=float, default=0.1)
    p.add_argument("--test", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    img_dir = os.path.join(args.src, "images")
    tri_dir = os.path.join(args.src, "annotations", "trimaps")
    if not os.path.isdir(img_dir) or not os.path.isdir(tri_dir):
        sys.exit(f"expected {img_dir} and {tri_dir}")
    species = species_map_from_list(os.path.join(args.src, "annotations", "list.txt"))
    stems = sorted(os.path.splitext(f)[0] for f in os.listdir(img_dir)
                   if f.lower().endswith(".jpg") and not f.startswith("."))
    stems = [s for s in stems if os.path.exists(os.path.join(tri_dir, s + ".png"))]
    splits = split_stems(stems, args.val, args.test, args.seed)
    for split, names in splits.items():
        cdir = os.path.join(args.dst, split, "color")
        ldir = os.path.join(args.dst, split, "label")
        os.makedirs(cdir, exist_ok=True)
        os.makedirs(ldir, exist_ok=True)
        for stem in names:
            shutil.copy2(os.path.join(img_dir, stem + ".jpg"), os.path.join(cdir, stem + ".jpg"))
            with Image.open(os.path.join(tri_dir, stem + ".png")) as im:
                tri = np.asarray(im.convert("L"))
            label = trimap_to_classes(tri, species.get(stem, species_from_name(stem)))
            Image.fromarray(label).save(os.path.join(ldir, stem + ".png"))
        print(f"{split}: {len(names)} samples")
    return splits


if __name__ == "__main__":
    main()
