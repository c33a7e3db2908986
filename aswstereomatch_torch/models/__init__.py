from .pipeline import StereoMatcher, match_batch, match_pair  # noqa: F401
