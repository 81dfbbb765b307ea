"""Generic directory-paired dataset.

Pairs ``{root}/images/**.{png,jpg}`` with same-stem files under
``{root}/labels`` and uses an identity label embedding
(reference: datasets/generic.py:8-57).
"""

from __future__ import annotations

import glob
import logging
import os

import numpy as np

logger = logging.getLogger(__name__)


class Generic:

    def __init__(self, image_dir=None, label_dir=None):
        self.image_dir = image_dir
        self.label_dir = label_dir

    @property
    def embedding(self) -> np.ndarray:
        # Identity: labels are assumed to already be trainIds.
        return np.arange(256, dtype=np.uint8)

    @property
    def embedding_reversed(self) -> np.ndarray:
        return np.arange(256, dtype=np.uint8)

    def file_associations(self, root_path):
        image_dir = os.path.join(root_path, self.image_dir or "images")
        label_dir = os.path.join(root_path, self.label_dir or "labels")
        assoc = {"examples": {}}
        if not os.path.isdir(image_dir):
            return assoc
        for walk_root, _dirs, filenames in os.walk(image_dir):
            for filename in sorted(filenames):
                if not filename.endswith((".png", ".jpg")):
                    continue
                file_id = ".".join(filename.split(".")[:-1])
                assoc["examples"][file_id] = {
                    "image": os.path.join(walk_root, filename)}
                subdir = os.path.relpath(walk_root, image_dir)
                subdir = "" if subdir == "." else subdir
                matches = glob.glob(
                    os.path.join(label_dir, subdir, file_id + "*"))
                if len(matches) > 1:
                    raise ValueError(
                        "Every label must have the same filename stem as "
                        "its image; multiple matches for %r" % file_id)
                if len(matches) == 0:
                    logger.info("Example %r has no matching label.", file_id)
                else:
                    assoc["examples"][file_id]["label"] = matches[0]
        return assoc
