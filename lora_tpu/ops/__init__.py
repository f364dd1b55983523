from . import codes, chirp, detect  # noqa: F401
