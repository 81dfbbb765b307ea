"""Mapillary Vistas dataset metadata and file discovery.

66-label table mapped onto the 19 Cityscapes trainIds; RGB-color-coded
ground truth via a 256^3 LUT (reference: datasets/vistas.py:15-114).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .base import color_embedding


@dataclasses.dataclass(frozen=True)
class VistasLabel:
    name: str
    id: int
    trainId: int
    cityscapesId: int
    color: tuple

# (name, id, trainId, cityscapesId, color) — Vistas v1.x label set mapped
# onto Cityscapes trainIds, values as in the reference table
# (datasets/vistas.py:15-83).
LABELS = [
    VistasLabel("bird",                      0, 255,   5, (165, 42, 42)),
    VistasLabel("ground animal",             1, 255,   5, (0, 192, 0)),
    VistasLabel("curb",                      2,   1,   8, (196, 196, 196)),
    VistasLabel("fence",                     3,   4,  13, (190, 153, 153)),
    VistasLabel("guard rail",                4, 255,  14, (180, 165, 180)),
    VistasLabel("barrier",                   5, 255, 255, (90, 120, 150)),
    VistasLabel("wall",                      6,   3,  12, (102, 102, 156)),
    VistasLabel("bike lane",                 7,   1,   8, (128, 64, 255)),
    VistasLabel("crosswalk - plain",         8, 255, 255, (140, 140, 200)),
    VistasLabel("curb cut",                  9,   1,   8, (170, 170, 170)),
    VistasLabel("parking",                  10, 255,   9, (250, 170, 160)),
    VistasLabel("pedestrian area",          11,   1,   7, (96, 96, 96)),
    VistasLabel("rail track",               12, 255,  10, (230, 150, 140)),
    VistasLabel("service lane",             14, 255, 255, (110, 110, 110)),
    VistasLabel("sidewalk",                 15,   1,   8, (244, 35, 232)),
    VistasLabel("bridge",                   16, 255,  15, (150, 100, 100)),
    VistasLabel("building",                 17,   2,  11, (70, 70, 70)),
    VistasLabel("tunnel",                   18, 255,  16, (150, 120, 90)),
    VistasLabel("person",                   19,  11,  24, (220, 20, 60)),
    VistasLabel("bicyclist",                20,  12,  25, (255, 0, 0)),
    VistasLabel("motorcyclist",             21,  12,  25, (255, 0, 100)),
    VistasLabel("rider",                    22,  12,  25, (255, 0, 200)),
    VistasLabel("lane marking - crosswalk", 23, 255, 255, (200, 128, 128)),
    VistasLabel("lane marking - general",   24,   0,   7, (255, 255, 255)),
    VistasLabel("road",                     13,   0,   7, (128, 64, 128)),
    VistasLabel("mountain",                 25, 255,   4, (64, 170, 64)),
    VistasLabel("sand",                     26, 255, 255, (230, 160, 50)),
    VistasLabel("sky",                      27,  10,  23, (70, 130, 180)),
    VistasLabel("snow",                     28, 255,   5, (190, 255, 255)),
    VistasLabel("terrain",                  29,   9,  22, (152, 251, 152)),
    VistasLabel("vegetation",               30,   8,  21, (107, 142, 35)),
    VistasLabel("water",                    31, 255,   4, (0, 170, 30)),
    VistasLabel("banner",                   32, 255, 255, (255, 255, 128)),
    VistasLabel("bench",                    33, 255,   4, (250, 0, 30)),
    VistasLabel("bike rack",                34, 255, 255, (100, 140, 180)),
    VistasLabel("billboard",                35, 255,   4, (220, 220, 220)),
    VistasLabel("catch basin",              36, 255, 255, (220, 128, 128)),
    VistasLabel("cctv camera",              37, 255,   4, (222, 40, 40)),
    VistasLabel("fire hydrant",             38, 255,   4, (100, 170, 30)),
    VistasLabel("junction box",             39, 255,   4, (40, 40, 40)),
    VistasLabel("mailbox",                  40, 255,   4, (33, 33, 33)),
    VistasLabel("manhole",                  41, 255, 255, (100, 128, 160)),
    VistasLabel("phone booth",              42, 255,   4, (142, 0, 0)),
    VistasLabel("pothole",                  43, 255, 255, (70, 100, 150)),
    VistasLabel("street light",             44, 255,   0, (210, 170, 100)),
    VistasLabel("traffic sign frame",       46, 255, 255, (128, 128, 128)),
    VistasLabel("utility pole",             47,   5,  17, (0, 0, 80)),
    VistasLabel("pole",                     45,   5,  17, (153, 153, 153)),
    VistasLabel("traffic light",            48,   6,  19, (250, 170, 30)),
    VistasLabel("traffic sign (back)",      49, 255, 255, (192, 192, 192)),
    VistasLabel("traffic sign",             50,   7,  20, (220, 220, 0)),
    VistasLabel("trash can",                51, 255,   4, (140, 140, 20)),
    VistasLabel("bicycle",                  52,  18,  33, (119, 11, 32)),
    VistasLabel("boat",                     53, 255, 255, (150, 0, 255)),
    VistasLabel("bus",                      54,  15,  28, (0, 60, 100)),
    VistasLabel("car",                      55,  13,  26, (0, 0, 142)),
    VistasLabel("caravan",                  56, 255,  29, (0, 0, 90)),
    VistasLabel("motorcycle",               57,  17,  32, (0, 0, 230)),
    VistasLabel("on rails",                 58,  16,  31, (0, 80, 100)),
    VistasLabel("other vehicle",            59, 255, 255, (128, 64, 64)),
    VistasLabel("trailer",                  60, 255,  30, (0, 0, 110)),
    VistasLabel("truck",                    61,  14,  27, (0, 0, 70)),
    VistasLabel("wheeled slow",             62, 255, 255, (0, 0, 192)),
    VistasLabel("car mount",                63, 255, 255, (32, 32, 32)),
    VistasLabel("ego vehicle",              64, 255,   1, (120, 10, 10)),
    VistasLabel("unlabeled",                65, 255,   0, (0, 0, 0)),
]


class Vistas:
    """Mapillary Vistas metadata (reference: datasets/vistas.py:85-192)."""

    def __init__(self):
        self._num_classes = 19
        self._embedding = None
        self._name_embedding = None
        # Forward iteration: the last label listed for a trainId wins
        # (vistas.py:91-93 builds the colormap eagerly, forward order).
        cmap = np.full((256, 3), 255, dtype=np.uint8)
        for label in LABELS:
            cmap[label.trainId] = label.color
        self._colormap = cmap

    @property
    def num_classes(self) -> int:
        return self._num_classes

    @property
    def colormap(self) -> np.ndarray:
        return self._colormap

    @property
    def embedding(self) -> np.ndarray:
        if self._embedding is None:
            self._embedding = color_embedding(LABELS)
        return self._embedding

    @property
    def embedding_reversed(self) -> np.ndarray:
        # trainId -> color (vistas.py:117-122 returns the colormap).
        return self._colormap

    @property
    def name_embedding(self):
        if self._name_embedding is None:
            names = [""] * self.num_classes
            for label in LABELS:
                if label.trainId != 255:
                    names[label.trainId] = label.name
            self._name_embedding = names
        return self._name_embedding

    def get_train_paths(self, root_path):
        return [os.path.join(root_path, "train")]

    def get_validation_paths(self, root_path):
        return [os.path.join(root_path, "val")]

    def get_test_paths(self, root_path):
        return [os.path.join(root_path, "test")]

    def file_associations(self, root_path):
        """Walk ``{root}/{training,validation,testing}/{images,labels}``.

        Splits are renamed train/val/test and files paired by stem
        (reference: datasets/vistas.py:147-192).
        """
        splits = {"training": "train", "validation": "val",
                  "testing": "test"}
        kinds = {"images": "image", "labels": "label"}
        assoc = {"train": {}, "val": {}, "test": {}}

        current_split = None
        for walk_root, _dirs, filenames in os.walk(root_path):
            basename = os.path.basename(walk_root)
            if basename in splits:
                current_split = splits[basename]
                continue
            if basename not in kinds or current_split is None:
                continue
            kind = kinds[basename]
            for filename in sorted(filenames):
                file_id = "".join(filename.split(".")[:-1])
                assoc[current_split].setdefault(file_id, {})[kind] = \
                    os.path.join(walk_root, filename)
        return assoc
