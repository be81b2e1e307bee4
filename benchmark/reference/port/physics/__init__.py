from .model import ArticulationModel, ArticulationState, ContactParams  # noqa: F401
from . import engine, asset, spatial  # noqa: F401
