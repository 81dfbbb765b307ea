"""Dataset metadata registry (reference: datasets/__init__.py:2-5)."""

from .base import Label, embed_label_image
from .cityscapes import Cityscapes
from .freiburg import Freiburg
from .generic import Generic
from .vistas import Vistas

_REGISTRY = {
    "cityscapes": Cityscapes,
    "freiburg": Freiburg,
    "vistas": Vistas,
    "generic": Generic,
}


def get_dataset(name: str, **kwargs):
    """Instantiate a dataset object by CLI name."""
    try:
        cls = _REGISTRY[name.lower()]
    except KeyError:
        raise NotImplementedError(f"Dataset {name!r} not supported") from None
    return cls(**kwargs)


__all__ = ["Cityscapes", "Freiburg", "Generic", "Vistas", "Label",
           "embed_label_image", "get_dataset"]
