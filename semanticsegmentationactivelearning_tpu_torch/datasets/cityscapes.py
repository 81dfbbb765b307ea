"""Cityscapes dataset metadata and file discovery.

Label table values are the public Cityscapes definitions
(github.com/mcordts/cityscapesScripts, helpers/labels.py), the same data
the reference embeds (reference: datasets/cityscapes.py:66-103). 19
training classes; raw ids are mapped to trainIds via a 256-entry LUT.
"""

from __future__ import annotations

import os

import numpy as np

from .base import (Label, colormap_from_labels, id_embedding,
                   reversed_id_embedding)

# (name, id, trainId, color) — public Cityscapes label definitions.
LABELS = [
    Label("unlabeled",             0, 255, (0, 0, 0)),
    Label("ego vehicle",           1, 255, (0, 0, 0)),
    Label("rectification border",  2, 255, (0, 0, 0)),
    Label("out of roi",            3, 255, (0, 0, 0)),
    Label("static",                4, 255, (0, 0, 0)),
    Label("dynamic",               5, 255, (111, 74, 0)),
    Label("ground",                6, 255, (81, 0, 81)),
    Label("road",                  7, 0,   (128, 64, 128)),
    Label("sidewalk",              8, 1,   (244, 35, 232)),
    Label("parking",               9, 255, (250, 170, 160)),
    Label("rail track",           10, 255, (230, 150, 140)),
    Label("building",             11, 2,   (70, 70, 70)),
    Label("wall",                 12, 3,   (102, 102, 156)),
    Label("fence",                13, 4,   (190, 153, 153)),
    Label("guard rail",           14, 255, (180, 165, 180)),
    Label("bridge",               15, 255, (150, 100, 100)),
    Label("tunnel",               16, 255, (150, 120, 90)),
    Label("pole",                 17, 5,   (153, 153, 153)),
    Label("polegroup",            18, 255, (153, 153, 153)),
    Label("traffic light",        19, 6,   (250, 170, 30)),
    Label("traffic sign",         20, 7,   (220, 220, 0)),
    Label("vegetation",           21, 8,   (107, 142, 35)),
    Label("terrain",              22, 9,   (152, 251, 152)),
    Label("sky",                  23, 10,  (70, 130, 180)),
    Label("person",               24, 11,  (220, 20, 60)),
    Label("rider",                25, 12,  (255, 0, 0)),
    Label("car",                  26, 13,  (0, 0, 142)),
    Label("truck",                27, 14,  (0, 0, 70)),
    Label("bus",                  28, 15,  (0, 60, 100)),
    Label("caravan",              29, 255, (0, 0, 90)),
    Label("trailer",              30, 255, (0, 0, 110)),
    Label("train",                31, 16,  (0, 80, 100)),
    Label("motorcycle",           32, 17,  (0, 0, 230)),
    Label("bicycle",              33, 18,  (119, 11, 32)),
    Label("license plate",        -1, 255, (0, 0, 142)),
]


class Cityscapes:
    """Cityscapes metadata (reference: datasets/cityscapes.py:108-248)."""

    def __init__(self, coarse: bool = False):
        self.coarse = coarse
        self._num_classes = 19
        self._embedding = None
        self._embedding_reversed = None
        self._colormap = None
        self._name_embedding = None

    @property
    def num_classes(self) -> int:
        return self._num_classes

    @property
    def colormap(self) -> np.ndarray:
        if self._colormap is None:
            self._colormap = colormap_from_labels(LABELS)
        return self._colormap

    @property
    def embedding(self) -> np.ndarray:
        if self._embedding is None:
            self._embedding = id_embedding(LABELS)
        return self._embedding

    @property
    def embedding_reversed(self) -> np.ndarray:
        if self._embedding_reversed is None:
            self._embedding_reversed = reversed_id_embedding(LABELS)
        return self._embedding_reversed

    @property
    def name_embedding(self):
        if self._name_embedding is None:
            self._name_embedding = [
                lb.name for lb in LABELS if lb.trainId != 255]
        return self._name_embedding

    def get_train_paths(self, root_path):
        paths = [os.path.join(root_path, "train")]
        if self.coarse:
            paths.append(os.path.join(root_path, "train_extra"))
        return paths

    def get_validation_paths(self, root_path):
        return [os.path.join(root_path, "val")]

    def get_test_paths(self, root_path):
        return [os.path.join(root_path, "test")]

    def file_associations(self, root_path):
        """Associate raw images with *_labelIds.png ground truth.

        Walks ``{root}/{leftImg8bit,gtFine|gtCoarse}/{split}/{city}`` and
        pairs by the ``city_seq_frame`` prefix, filtering out instance
        and polygon files (reference: datasets/cityscapes.py:173-248).
        Test images (no labels) are collected by a recursive walk.
        """
        label_type = "gtCoarse" if self.coarse else "gtFine"
        image_type = "leftImg8bit"
        image_base = os.path.join(root_path, image_type)
        label_base = os.path.join(root_path, label_type)

        assoc = {"train": {}, "val": {}, "test": {}}
        splits = ["train", "val"]
        if self.coarse:
            assoc["train_extra"] = {}
            splits = ["train", "train_extra", "val"]

        for split in splits:
            label_split = os.path.join(label_base, split)
            image_split = os.path.join(image_base, split)
            if not os.path.isdir(label_split):
                continue
            for city in sorted(os.listdir(label_split)):
                label_city = os.path.join(label_split, city)
                image_city = os.path.join(image_split, city)
                for filename in sorted(os.listdir(label_city)):
                    parts = filename.split("_")
                    if parts[-1] != "labelIds.png":
                        continue
                    file_id = "_".join(parts[:3])
                    # city_seq_frame_<gtType>_labelIds.png ->
                    # city_seq_frame_leftImg8bit.png
                    image_name = "_".join(parts[:-2] + [image_type + ".png"])
                    assoc[split][file_id] = {
                        "image": os.path.join(image_city, image_name),
                        "label": os.path.join(label_city, filename),
                    }

        test_split = os.path.join(image_base, "test")
        for walk_root, _dirs, filenames in os.walk(test_split):
            for filename in sorted(filenames):
                file_id = "_".join(filename.split("_")[:3])
                assoc["test"][file_id] = {
                    "image": os.path.join(walk_root, filename)}
        return assoc
