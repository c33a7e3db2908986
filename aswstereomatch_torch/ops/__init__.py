from . import aggregate, cost, postprocess, preprocess, wta  # noqa: F401
