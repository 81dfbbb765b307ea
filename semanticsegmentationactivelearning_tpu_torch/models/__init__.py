"""Model zoo of the PyTorch port (the counterpart of
``semanticsegmentationactivelearning_tpu.models``)."""

from .enet import ENet

_REGISTRY = {"enet": ENet}
# ported later; see ROADMAP.md Queue 1 item 8
_NOT_PORTED = {"icnet": "ICNet is not ported yet (ROADMAP.md Queue 1 "
                        "item 8, ICNet)"}


def get_model(name: str, num_classes: int, **kwargs):
    key = name.lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[key])
    try:
        cls = _REGISTRY[key]
    except KeyError:
        raise NotImplementedError(f"Model {name!r} not supported") from None
    return cls(num_classes=num_classes, **kwargs)


__all__ = ["ENet", "get_model"]
