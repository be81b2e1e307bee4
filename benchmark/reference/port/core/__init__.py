from . import quat, rot  # noqa: F401
