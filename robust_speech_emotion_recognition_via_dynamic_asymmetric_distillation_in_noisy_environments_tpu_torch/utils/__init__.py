from .device import MESH_NOT_PORTED, resolve_device
from .io import dump_json, load_json
from .logging import get_logger

__all__ = ["MESH_NOT_PORTED", "dump_json", "get_logger", "load_json", "resolve_device"]
