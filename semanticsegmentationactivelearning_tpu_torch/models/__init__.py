"""Model zoo of the PyTorch port (the counterpart of
``semanticsegmentationactivelearning_tpu.models``)."""

from .enet import ENet
from .icnet import ICNet

_REGISTRY = {"enet": ENet, "icnet": ICNet}


def get_model(name: str, num_classes: int, **kwargs):
    try:
        cls = _REGISTRY[name.lower()]
    except KeyError:
        raise NotImplementedError(f"Model {name!r} not supported") from None
    return cls(num_classes=num_classes, **kwargs)


__all__ = ["ENet", "ICNet", "get_model"]
