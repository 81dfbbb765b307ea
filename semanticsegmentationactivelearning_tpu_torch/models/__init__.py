"""Model zoo of the PyTorch port (the counterpart of
``semanticsegmentationactivelearning_tpu.models``)."""

from .enet import ENet
from .icnet import ICNet

_REGISTRY = {"enet": ENet, "icnet": ICNet}


def model_class(name: str):
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise NotImplementedError(f"Model {name!r} not supported") from None


def get_model(name: str, num_classes: int, **kwargs):
    return model_class(name)(num_classes=num_classes, **kwargs)


def conf_model_kwargs(name: str, hyperparams) -> dict:
    """The kwargs the CLIs build ``name`` with from a conf's
    ``hyperparams``: ``drop_rates``, as the JAX CLIs give every model,
    and for ENet its multiscale loss heads when the conf's loss takes
    them (the flax ENet makes them on its first multiscale call; ICNet's
    cascade heads are part of the model)."""
    kwargs = {"drop_rates": tuple(hyperparams["dropout_rates"])}
    if model_class(name) is ENet:
        kwargs["multiscale_heads"] = bool(
            hyperparams.get("softmax", {}).get("multiscale", False))
    return kwargs


__all__ = ["ENet", "ICNet", "conf_model_kwargs", "get_model", "model_class"]
