from . import colorspace, evaluate, synthetic  # noqa: F401
