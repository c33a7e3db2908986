"""The port's long-lived entry points: the serving daemon (``serve``) and
the resumable dataset sweep (``sweep``); run each with ``python -m``."""
