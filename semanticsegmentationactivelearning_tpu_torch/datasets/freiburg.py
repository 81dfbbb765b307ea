"""Freiburg Forest dataset metadata and file discovery.

6 training classes, RGB-color-coded ground truth mapped through a
256^3 color->trainId LUT (reference: datasets/freiburg.py:24-33,50-55).
Supports extra modalities (e.g. ``nir``) and a deterministic strided
train/val split (freiburg.py:105-167).
"""

from __future__ import annotations

import os

import numpy as np

from .base import Label, color_embedding

# Vegetation and Tree share dataset id 3 / trainId 2 ("non-drivable
# vegetation"); Void (id 0) has no color and maps to ignore (255).
LABELS = [
    Label("Void",       0, 255, None),
    Label("Road",       1, 0,   (170, 170, 170)),
    Label("Grass",      2, 1,   (0, 255, 0)),
    Label("Vegetation", 3, 2,   (102, 102, 51)),
    Label("Tree",       3, 2,   (0, 60, 0)),
    Label("Sky",        4, 3,   (0, 120, 255)),
    Label("Obstacle",   5, 4,   (0, 0, 0)),
]


class Freiburg:
    """Freiburg Forest metadata (reference: datasets/freiburg.py:39-167)."""

    def __init__(self, modalities=None):
        self.modalities = modalities
        self._num_classes = 6
        self._embedding = None
        self._colormap = None

    @property
    def num_classes(self) -> int:
        return self._num_classes

    @property
    def embedding(self) -> np.ndarray:
        # 16 MiB color LUT; built lazily (freiburg.py:50-55). Void has no
        # color so all unmapped colors -> 255.
        if self._embedding is None:
            self._embedding = color_embedding(LABELS[1:])
        return self._embedding

    @property
    def colormap(self) -> np.ndarray:
        if self._colormap is None:
            cmap = np.full((256, 3), 255, dtype=np.uint8)
            for label in LABELS[1:]:
                cmap[label.trainId] = label.color
            self._colormap = cmap
        return self._colormap

    @property
    def embedding_reversed(self) -> np.ndarray:
        # trainId -> color, used to reconstruct GT_color-style outputs
        # (freiburg.py:57-63 returns the colormap here too).
        return self.colormap

    def get_train_paths(self, root_path):
        return [os.path.join(root_path, "train")]

    def get_validation_paths(self, root_path):
        val_path = os.path.join(root_path, "val")
        return [val_path] if os.path.exists(val_path) else None

    def get_test_paths(self, root_path):
        return [os.path.join(root_path, "test")]

    def file_associations(self, root_path, val_proportion: float = 0.05):
        """Pair GT_color labels with per-modality images.

        File ids are the leading ``_``/``.``-delimited token (the dataset's
        naming has ``_Clipped``/``_mask`` postfixes; freiburg.py:138-140).
        A deterministic validation split is carved out of train by strided
        sampling over the sorted ids (freiburg.py:154-166).
        """
        modalities = self.modalities
        if modalities is None or len(modalities) == 0:
            modalities = ["rgb"]
        if not isinstance(modalities, list):
            raise ValueError(
                "Modalities must be a list of dataset subdirectory names, "
                "e.g. ['rgb', 'nir_gray'].")

        assoc = {"train": {}, "test": {}}
        for split in assoc:
            split_path = os.path.join(root_path, split)
            label_path = os.path.join(split_path, "GT_color")
            for filename in sorted(os.listdir(label_path)):
                _id = filename.split(".")[0].split("_")[0]
                assoc[split][_id] = {
                    "label": os.path.join(label_path, filename)}
            for modality in modalities:
                mod_path = os.path.join(split_path, modality)
                key = "image" if modality == "rgb" else modality
                for filename in sorted(os.listdir(mod_path)):
                    _id = filename.split(".")[0].split("_")[0]
                    assoc[split][_id][key] = os.path.join(mod_path, filename)

        if val_proportion > 0.0:
            assoc["val"] = {}
            stride = int(1.0 / val_proportion + 1)
            for example in sorted(assoc["train"])[::stride]:
                assoc["val"][example] = assoc["train"].pop(example)
        return assoc
